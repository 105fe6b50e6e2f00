"""Fused signal -> features: the Hopper kernel's wrapper and its plain twin.

Replaces the TPU kernels of ``tpufeat/pallas/fused.py`` that frame inside
the kernel — ``signal_features`` -> ``_signal_kernel`` (v4 hop-split layout)
and ``_signal_features_phase`` -> ``_phase_signal_kernel`` (v5 phase-packed
layout). The two TPU layouts exist only to fit 128-lane rows; a Hopper block
reads its overlapping frames straight out of the signal.

Contract (that of ``fused.signal_features``): ``buf`` [B, M] float32 is the
framing buffer, frame t covers ``buf[t*hop : t*hop + frame_length]`` and
reads past M are zeros. The result is [B, n_frames, D] float32, with
D = n_mfcc (MFCCs) or n_mels (log-mel; log10 for whisper, which the caller
then normalizes).

Precision: every product x @ W of the DFT, the mel and the DCT runs at
``cfg.matmul_precision``, as on the TPU (``fused.py:87-143``), as a sum of
bf16 products of the operands' pieces hi = bf16_rn(x), mid =
bf16_rn(x - hi), lo = bf16_rn(x - hi - mid) (:func:`split_pieces`), in the
order of :data:`PASS_ORDER`, each product exact in f32 and summed in f32:

- ``"highest"``: six passes, hi.hi + hi.mid + mid.hi + hi.lo + mid.mid +
  lo.hi, the form of XLA's f32 emulation that the TPU runs for
  Precision.HIGHEST (``fused.py:89-91``): within about 1e-6 of fp32, so its
  contract (1.2e-4 of the float64 golden) holds;
- ``"bf16x3"``: the first three, hi(x)*hi(W) + hi(x)*lo(W) + lo(x)*hi(W)
  with lo the two-way split's, which is mid;
- ``"default"``: hi(x)*hi(W) alone.

All three run on one bf16 tensor-core kernel, ``csrc/signal_mma.cu``
(``wgmma``), counted in :data:`mma_launches`, with the constants split and
packed on the host and cached per config and device (:func:`mma_blocks`).

The twin (:func:`signal_features_reference`) runs the same products as f32
matrix products of the bf16 pieces (:func:`mm`), TF32 off, so the kernel
and the twin differ only in the order of their f32 sums; what that allows
is ``kernels/_tolerance.py``'s.

What bounds it on an H100 (estimates from the shapes; the measured times
are in PERF.md): the dual Whisper-80 + MFCC-13 call at B=128 x 30 s is about
3.15e11 FLOP of DFT and mel products against about 0.6 GB moved: 1.91 ms
for "highest"'s six passes at the published 989 TFLOP/s bf16 dense peak,
0.96 ms for bf16x3's three, 0.18 ms at 3.35 TB/s (H100 SXM, 700 W). The
kernel keeps frames, spectrum and mel on the SM, so device memory sees only
the signal, the constants and the features.

The kernel's tile is MMA_TILE_FRAMES frames of the whole call, across
utterances and streams, in two warpgroups of 64. It stages the samples the
tile's frames cover once, as one span per row of ``buf`` (or, where the
spans do not fit, frame by frame in windows of the depth:
:func:`tile_plan`, :func:`staged_rows`), and streams CS's and FB's slices,
MMA_DEPTH deep and packed on the host in ``wgmma``'s 128-byte swizzle
(:func:`mma_blocks`), through a ring that every frame of the tile shares.
z comes in chunks of MMA_COLS columns; z*z stays in registers as the mel
product's operand.

Bits: the tile and the order of every sum are fixed, whatever the call's
shape, so a frame's features do not depend on where it falls in a call or
on how its samples were staged. It takes any n_mels, in slabs of
MMA_MEL_SLAB bands.

The staged kernels (``kernels/staged.py``) live in the same library and
share this module's binding (:func:`lib`), constants and twin body.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch import framing, matrices
from tpufeat_torch.config import FeatureConfig
from tpufeat_torch.kernels import _build

MMA_TILE_FRAMES = 128  # frames per tile: TM in csrc/signal_mma.cu
MMA_COLS = 128         # DFT columns per chunk of z: NT
MMA_DEPTH = 64         # depth of a ring slice (a swizzled row): KS
MMA_MEL_SLAB = 128     # mel bands per pass: SLAB
#: samples that fit each staged plane of the signal at each pass count:
#: 128 KiB of shared memory as bf16 pieces at one pass (one plane) and
#: three (two), f32 at six, 16 bytes of padding after every 128
#: (csrc/signal_mma.cu Sig::CAP)
SPAN_SAMPLES = {1: 58240, 3: 29120, 6: 29120}
#: bf16 passes per product of each matmul_precision
PASSES = {"highest": 6, "bf16x3": 3, "default": 1}
#: the (x piece, W piece) of each pass, in the order every product sums
#: them: hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi; P passes take the
#: first P (csrc/signal_mma.cu a_piece, b_piece)
PASS_ORDER = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
#: pieces per operand at each pass count
PIECES = {1: 1, 3: 2, 6: 3}
#: the kernel's launches so far (the twin never adds to them)
mma_launches = 0

_LOG_KIND = {"none": 0, "natural": 1, "log10": 2, "whisper": 2}


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False      # cached: every caller shares one array
    return a


@contextlib.contextmanager
def no_tf32():
    """Full fp32 matrix products inside the block (a plain twin, and every
    product of the plain path, states its precision). The caller's setting
    of cuBLAS and cuDNN is saved and restored through the API the caller
    used: the legacy ``allow_tf32`` flags, or ``fp32_precision`` (torch
    refuses to read the legacy flags once it is set, and a parent's
    ``fp32_precision`` overrides them). A setting that already keeps fp32
    is not touched."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    parents = any(getattr(b, "fp32_precision", "none") != "none"
                  for b in (torch.backends, cudnn))
    saved = []
    for legacy, leaf in ((matmul, matmul), (cudnn, cudnn.conv)):
        try:
            if parents:
                raise RuntimeError("the caller set fp32_precision")
            owner, attr, pinned = legacy, "allow_tf32", False
            old = legacy.allow_tf32
        except RuntimeError:
            owner, attr, pinned = leaf, "fp32_precision", "ieee"
            old = leaf.fp32_precision
        if old != pinned:
            saved.append((owner, attr, old))
            setattr(owner, attr, pinned)
    try:
        yield
    finally:
        for owner, attr, old in reversed(saved):
            setattr(owner, attr, old)


def passes(cfg: FeatureConfig) -> int:
    """bf16 passes per product at ``cfg.matmul_precision``."""
    return PASSES[cfg.matmul_precision]


def split_pieces(x: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    """The first ``n`` bf16 pieces of x: hi = bf16_rn(x), mid =
    bf16_rn(x - hi), lo = bf16_rn(x - hi - mid), round to nearest even (the
    TPU kernels' ``astype(bfloat16)``). Each difference is exact in f32, so
    for f32 x of exponent -110 to 127 hi + mid + lo is x exactly."""
    rest = x.to(torch.float32)
    out = []
    for _ in range(n):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].to(torch.float32)
    return tuple(out)


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 with hi = bf16_rn(x), lo = bf16_rn(x - hi): bf16x3's
    split."""
    return split_pieces(x, 2)


def split3_bf16(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(hi, mid, lo) bf16: the split of "highest"'s six passes."""
    return split_pieces(x, 3)


def mm(x: torch.Tensor, w: torch.Tensor, n_passes: int) -> torch.Tensor:
    """x @ w with ``n_passes`` bf16 passes (:data:`PASSES`): the first
    ``n_passes`` products of :data:`PASS_ORDER` over the pieces of x and w,
    summed in that order. The bf16 pieces are multiplied as f32, where
    their products are exact."""
    n = PIECES[n_passes]
    xs = [t.to(torch.float32) for t in split_pieces(x, n)]
    ws = [t.to(torch.float32) for t in split_pieces(w, n)]
    out = None
    for a, b in PASS_ORDER[:n_passes]:
        term = xs[a] @ ws[b]
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=None)
def cs_constant(cfg: FeatureConfig, fold_kaldi: bool = True) -> np.ndarray:
    """Combined windowed Re/Im DFT matrix [frame_length, 2*n_bins - 2],
    float32. Columns: Re of bins 0..n_bins-1, then Im of bins 1..n_bins-2
    (``matrices.dft_matrix_combined``). ``fold_kaldi`` folds kaldi_mode's
    per-frame conditioning in, for the signal kernel, which sees the raw
    signal; the staged kernel gets conditioned frames and must not fold it
    again."""
    cs = matrices.dft_matrix_combined(cfg.frame_length, cfg.n_fft,
                                      cfg.window)
    if fold_kaldi and cfg.kaldi_mode and (cfg.dc_offset or cfg.preemphasis):
        cond = matrices.kaldi_conditioning_matrix(
            cfg.frame_length, cfg.preemphasis if cfg.preemphasis else 0.0,
            cfg.dc_offset)
        cs = cond @ cs
    return _frozen(cs.astype(np.float32))


def _mel_args(cfg: FeatureConfig) -> tuple:
    return (cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax_hz,
            cfg.mel_scale, cfg.mel_norm, cfg.mel_bin_style,
            cfg.vtln_warp, cfg.vtln_low, cfg.vtln_high)


@functools.lru_cache(maxsize=None)
def fb_constant(cfg: FeatureConfig) -> np.ndarray:
    """float32 filterbank for the kernel's spectrum rows: for ``power`` the
    folded bank [2*n_bins - 2, n_mels] (z*z @ it == |X|^2 @ fb, so the power
    spectrum never exists); for ``magnitude`` the plain bank
    [n_bins, n_mels] on the rebuilt |X| rows."""
    if cfg.spectrum == "power":
        fb = matrices.mel_filterbank_folded(*_mel_args(cfg))
    else:
        fb = matrices.mel_filterbank(*_mel_args(cfg))
    return _frozen(fb.astype(np.float32))


@functools.lru_cache(maxsize=None)
def dct_constant(cfg: FeatureConfig) -> np.ndarray | None:
    """float32 DCT-II [n_mels, n_mfcc] with the lifter folded into its
    columns, or None where the kernel stops at the log-mel (n_mfcc == 0,
    and whisper, whose clamp needs the utterance max first)."""
    if cfg.n_mfcc <= 0 or cfg.log == "whisper":
        return None
    dct = matrices.dct_matrix(cfg.n_mels, cfg.n_mfcc) * \
        matrices.lifter_vector(cfg.n_mfcc, cfg.lifter)[None, :]
    return _frozen(dct.astype(np.float32))


def pair_order(n_bins: int) -> np.ndarray:
    """The tensor-core kernel's order of the combined DFT columns: pairs
    (Re_k, Im_k) for k = 1..n_bins-2 after the pair (Re_0, Re_{n_bins-1}),
    so a bin's two columns meet in one thread of an MMA accumulator."""
    order = [0, n_bins - 1]
    for k in range(1, n_bins - 1):
        order += [k, n_bins - 1 + k]
    return np.array(order)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def mma_constants(cfg: FeatureConfig, fold_kaldi: bool = True) -> tuple:
    """The tensor-core kernel's constants, split on the host at ``cfg``'s
    precision into its :data:`PIECES` (hi; hi, lo; hi, mid, lo), as CPU
    tensors: (cs, fb, dct), each a tuple of pieces. cs: bf16
    [round_up(frame_length, MMA_DEPTH), round_up(nc, MMA_COLS)] with
    nc = 2*n_bins - 2 columns in :func:`pair_order`; fb: bf16
    [round_up(nc, MMA_COLS), round_up(n_mels, 8)] with the rows to match
    (for magnitude: pair 0's rows fb[0] and fb[n_bins-1], pair k's fb[k]
    and zeros); dct: float32 with bf16 values [n_mels, n_mfcc], or None
    where the kernel stops at the log-mel. Padding is zeros."""
    nb, nm, fl = cfg.n_bins, cfg.n_mels, cfg.frame_length
    nc = 2 * nb - 2
    order = pair_order(nb)
    cs = np.zeros((_round_up(fl, MMA_DEPTH), _round_up(nc, MMA_COLS)),
                  np.float32)
    cs[:fl, :nc] = cs_constant(cfg, fold_kaldi)[:, order]
    fb = np.zeros((cs.shape[1], _round_up(nm, 8)), np.float32)
    if cfg.spectrum == "power":
        fb[:nc, :nm] = fb_constant(cfg)[order]
    else:
        plain = fb_constant(cfg)
        fb[0, :nm], fb[1, :nm] = plain[0], plain[nb - 1]
        fb[2:nc:2, :nm] = plain[1:nb - 1]
    n = PIECES[passes(cfg)]
    dct = dct_constant(cfg)
    return (split_pieces(torch.from_numpy(cs), n),
            split_pieces(torch.from_numpy(fb), n),
            None if dct is None else tuple(
                t.to(torch.float32)
                for t in split_pieces(torch.tensor(dct), n)))


@functools.lru_cache(maxsize=None)
def _swizzle_index(rows: int) -> torch.Tensor:
    n = torch.arange(rows)[:, None]
    k = torch.arange(64)[None, :]
    return (n * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8).reshape(-1)


def swizzled(blocks: torch.Tensor) -> torch.Tensor:
    """[..., n, 64] blocks -> [..., n * 64] in wgmma's K-major 128-byte
    swizzle: row n is 128 bytes of bf16, and its eight 16-byte pieces are
    permuted by n % 8."""
    rows = blocks.shape[-2]
    flat = blocks.reshape(*blocks.shape[:-2], rows * 64)
    out = torch.empty_like(flat)
    out[..., _swizzle_index(rows)] = flat
    return out


@functools.lru_cache(maxsize=None)
def mma_blocks(cfg: FeatureConfig, fold_kaldi: bool = True) -> tuple:
    """:func:`mma_constants` as the kernel's ring reads them, CPU tensors:
    (cs, fb, dct). cs: bf16 [chunks, slices, pieces, 2, 64 * 64], each
    piece of a chunk's MMA_COLS columns by a slice MMA_DEPTH deep as its two
    halves of 64 columns, K-major (a row of 64 depths per column) in
    :func:`swizzled` order, so that the halves of a piece stack into the
    128 rows one wgmma reads; fb: bf16 [slabs, blocks, pieces, 128 * 64], a
    slab's 128 bands (zeros past n_mels) by 64 of z's columns, the same
    way; dct: :func:`mma_constants`'s pieces."""
    cs, fb, dct = mma_constants(cfg, fold_kaldi)
    m = torch.stack(cs)
    n, depth, cols = m.shape
    half = MMA_COLS // 2
    m = m.reshape(n, depth // MMA_DEPTH, MMA_DEPTH, cols // MMA_COLS, 2, half)
    cs_blocks = swizzled(m.permute(3, 1, 0, 4, 5, 2)).contiguous()
    slabs = -(-cfg.n_mels // MMA_MEL_SLAB)
    f = torch.stack(fb)
    f = torch.cat([f, f.new_zeros(n, cols, slabs * MMA_MEL_SLAB - f.shape[2])],
                  2)
    f = f.reshape(n, cols // half, half, slabs, MMA_MEL_SLAB)
    fb_blocks = swizzled(f.permute(3, 1, 0, 4, 2)).contiguous()
    return cs_blocks, fb_blocks, dct


class TilePlan(NamedTuple):
    """How the kernel stages one tile's samples (csrc/signal_mma.cu
    tile_span, stage_spans, stage_window)."""
    valid: int             # the tile's frames (the last tile's may be fewer)
    spans: tuple           # (row of buf, first sample, offset, samples) of
                           # each span in the staged planes; () frame by frame
    bases: np.ndarray | None   # [MMA_TILE_FRAMES]: where each tile row's
                               # frame starts in the planes (rows past valid:
                               # frame 0's); None frame by frame
    window: int            # frame by frame: the depth of a window, its rows
                           # window + 8 samples apart; 0 with spans


def tile_plan(batch: int, M: int, n_frames: int, hop: int, fl: int,
              tile: int, n_passes: int) -> TilePlan:
    """The kernel's plan for ``tile`` of a call over ``buf`` [batch, M]:
    the spans of samples that the tile's frames cover in each row of buf,
    from the first frame's start to the last frame's end, rounded up to 8
    samples, one after the other in the staged planes; or, where they do
    not fit in SPAN_SAMPLES[n_passes] (with 16 samples to spare for the
    last frame's 16-deep step past fl), frame by frame in windows of the
    depth."""
    tm = MMA_TILE_FRAMES
    g0 = tile * tm
    valid = min(tm, batch * n_frames - g0)
    b0, t0 = divmod(g0, n_frames)
    b1, tl = divmod(g0 + valid - 1, n_frames)
    spans, offset = [], 0
    for b in range(b0, b1 + 1):
        first = t0 if b == b0 else 0
        last = tl if b == b1 else n_frames - 1
        n = _round_up((last - first) * hop + fl, 8)
        spans.append((b, first * hop, offset, n))
        offset += n
    cap = SPAN_SAMPLES[n_passes]
    if offset + 16 > cap:
        return TilePlan(valid, (), None,
                        (cap // tm - 8) // MMA_DEPTH * MMA_DEPTH)
    b, t = np.divmod(g0 + np.arange(tm), n_frames)
    start = {row: o - s0 for row, s0, o, _ in spans}
    bases = np.array([start[b[r]] + t[r] * hop if r < valid else 0
                      for r in range(tm)])
    return TilePlan(valid, tuple(spans), bases, 0)


def staged_rows(buf: np.ndarray, n_frames: int, hop: int, fl: int,
                tile: int, n_passes: int) -> np.ndarray:
    """What the kernel's A fragments hold for ``tile`` before the split:
    [MMA_TILE_FRAMES, round_up(fl, 16)] float32, row r tile row r's frame
    as read from the planes staged by :func:`tile_plan` (zeros past M), its
    columns at or past fl zero."""
    batch, M = buf.shape
    plan = tile_plan(batch, M, n_frames, hop, fl, tile, n_passes)
    tm, depth = MMA_TILE_FRAMES, _round_up(fl, 16)
    k = np.arange(depth)
    if not plan.window:
        plane = np.zeros(SPAN_SAMPLES[n_passes], np.float32)
        for b, s0, offset, n in plan.spans:
            real = max(0, min(n, M - s0))
            plane[offset: offset + real] = buf[b, s0: s0 + real]
        rows = plane[plan.bases[:, None] + k[None, :]]
    else:
        fw, rows = plan.window, np.zeros((tm, depth), np.float32)
        r = np.arange(tm)
        for w in range(-(-fl // fw)):
            plane = np.zeros(tm * (fw + 8), np.float32)
            for i in range(plan.valid):
                b, t = divmod(tile * tm + i, n_frames)
                lim = max(0, min(fl, M - t * hop))
                kk = np.arange(w * fw, min((w + 1) * fw, lim))
                plane[i * (fw + 8) + kk - w * fw] = buf[b, t * hop + kk]
            cols = k[(k >= w * fw) & (k < (w + 1) * fw)]
            rows[:, cols] = plane[(r * (fw + 8) - w * fw)[:, None]
                                  + cols[None, :]]
    rows[:, fl:] = 0.0
    return rows


def put(a: np.ndarray | None, device: torch.device) -> torch.Tensor | None:
    """A cached constant as a tensor on ``device`` (None stays None)."""
    return None if a is None else torch.tensor(a, device=device)


@functools.lru_cache(maxsize=None)
def _device_constants(cfg: FeatureConfig, device: torch.device):
    return (put(cs_constant(cfg), device), put(fb_constant(cfg), device),
            put(dct_constant(cfg), device))


def ptrs(tensors: tuple) -> list:
    """Data pointers, None for None."""
    return [None if t is None else t.data_ptr() for t in tensors]


@functools.lru_cache(maxsize=None)
def _mma_device_constants(cfg: FeatureConfig, fold_kaldi: bool,
                          device: torch.device) -> tuple:
    """The packed cs and fb on ``device``, and the DCT's pieces padded with
    None to three (the kernel's hi, mid, lo arguments)."""
    cs, fb, dct = mma_blocks(cfg, fold_kaldi)
    return (cs.to(device), fb.to(device),
            tuple([t.to(device).contiguous() for t in dct or ()]
                  + [None] * (3 - len(dct or ()))))


def _check(buf: torch.Tensor, n_frames: int, cfg: FeatureConfig) -> None:
    if not isinstance(buf, torch.Tensor) or buf.dim() != 2:
        raise ValueError("buf must be a [B, M] tensor")
    if buf.dtype != torch.float32:
        raise TypeError(f"buf must be float32, got {buf.dtype}")
    if not buf.is_contiguous():
        raise ValueError("buf must be contiguous")
    if buf.shape[0] < 1 or buf.shape[1] < 1 or n_frames < 1:
        raise ValueError(f"need B, M, n_frames >= 1, got "
                         f"{tuple(buf.shape)}, {n_frames}")
    check_config(cfg)


def check_config(cfg: FeatureConfig) -> None:
    """What the kernel takes: a mel path with an even n_fft."""
    if cfg.n_mels <= 0 or cfg.n_fft % 2:
        raise ValueError("the signal kernel needs n_mels > 0 and an even "
                         f"n_fft (got n_mels={cfg.n_mels}, n_fft={cfg.n_fft})")


def _out_dim(cfg: FeatureConfig) -> int:
    return cfg.n_mels if dct_constant(cfg) is None else cfg.n_mfcc


def log_tail(mel: torch.Tensor, dct: torch.Tensor | None,
             cfg: FeatureConfig) -> torch.Tensor:
    """The twins' shared tail after the mel product: the floored log (or
    none), then the DCT at ``cfg``'s precision when the kernel runs it."""
    kind = _LOG_KIND[cfg.log]
    if kind == 1:
        mel = torch.log(torch.clamp(mel, min=cfg.log_floor))
    elif kind == 2:
        mel = torch.log10(torch.clamp(mel, min=cfg.log_floor))
    return mel if dct is None else mm(mel, dct, passes(cfg))


def dft_tail(frames: torch.Tensor, cs: torch.Tensor, fb: torch.Tensor,
             dct: torch.Tensor | None, cfg: FeatureConfig) -> torch.Tensor:
    """The twins' shared body from frames on, every product at
    ``cfg.matmul_precision``: frames @ CS -> square (or |X|) -> @ fb ->
    :func:`log_tail`."""
    n = passes(cfg)
    z = mm(frames, cs, n)
    sq = z * z
    if cfg.spectrum == "magnitude":
        nb = cfg.n_bins
        im2 = torch.zeros_like(sq[..., :nb])
        im2[..., 1: nb - 1] = sq[..., nb:]
        sq = torch.sqrt(sq[..., :nb] + im2)
    return log_tail(mm(sq, fb, n), dct, cfg)


def signal_features_reference(buf: torch.Tensor, n_frames: int,
                              cfg: FeatureConfig) -> torch.Tensor:
    """Plain torch twin of :func:`signal_features`, the same decomposition:
    frames -> frames @ CS -> square (or |X|) -> @ fb -> log -> @ dct."""
    _check(buf, n_frames, cfg)
    cs, fb, dct = _device_constants(cfg, buf.device)
    frames = framing.frames_from_buffer(buf, n_frames, cfg.frame_length,
                                        cfg.hop_length)
    with no_tf32():
        return dft_tail(frames, cs, fb, dct, cfg)


@functools.lru_cache(maxsize=None)
def lib(csrc: str) -> ctypes.CDLL:
    """The kernel library of ``csrc``, built at the first call, with every
    entry point's argument types declared."""
    so = _build.load(csrc).lib
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    ll, out = ctypes.c_longlong, ctypes.POINTER(i)
    for name, args in (
            ("tpufeat_signal_features_mma",
             [i, p, i, ll, i, i, i, p, i, p, i, i, i, f, p, p, p, i, p, i,
              p]),
            ("tpufeat_mel_log_dct_mma",
             [i, p, ll, i, p, i, i, f, p, i, p, i, p]),
            ("tpufeat_signal_mma_resources", [i, i, out, out, out, out]),
            ("tpufeat_tail_mma_resources",
             [i, i, i, i, out, out, out, out, out])):
        getattr(so, name).argtypes = args
        getattr(so, name).restype = i
    so.tpufeat_cuda_error_string.argtypes = [i]
    so.tpufeat_cuda_error_string.restype = ctypes.c_char_p
    return so


def raise_on(so: ctypes.CDLL, err: int, what: str) -> None:
    """Turn an entry point's CUDA error code into an exception."""
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({so.tpufeat_cuda_error_string(err).decode()})")


def query_resources(query, *args, outputs: int = 2) -> tuple[int, ...]:
    """The ``outputs`` integers of one of the library's resource queries
    (dynamic shared memory per block in bytes and blocks per SM first), on
    the current CUDA device."""
    so = lib(str(_build.CSRC))
    got = [ctypes.c_int() for _ in range(outputs)]
    raise_on(so, getattr(so, query)(*args, *map(ctypes.byref, got)),
             "occupancy query")
    return tuple(v.value for v in got)


def mma_resources(cfg: FeatureConfig) -> tuple[int, int, int, int]:
    """(dynamic shared memory per block in bytes, blocks per SM, registers
    per thread at launch, local memory per thread in bytes: spills) of the
    kernel's launch at ``cfg``'s precision and n_mels on the current CUDA
    device, K1 and K3 alike."""
    return query_resources("tpufeat_signal_mma_resources", passes(cfg),
                           cfg.n_mels, outputs=4)


def launch_mma(buf: torch.Tensor, n_frames: int, hop: int,
               cfg: FeatureConfig, fold_kaldi: bool, out: torch.Tensor,
               what: str) -> None:
    """Launch the tensor-core kernel over ``buf`` [B, M] (frame t of a row
    at t*hop) into ``out`` [B * n_frames, D] on the current stream; raises
    if the launch fails. K1 and K3 (``kernels/staged.py``) both come here."""
    so = lib(str(_build.CSRC))
    cs, fb, dct = _mma_device_constants(cfg, fold_kaldi, buf.device)
    B, M = buf.shape
    err = so.tpufeat_signal_features_mma(
        buf.device.index, buf.data_ptr(), B, M, n_frames, hop,
        cfg.frame_length, cs.data_ptr(), 2 * cfg.n_bins - 2, fb.data_ptr(),
        cfg.n_mels, int(cfg.spectrum == "magnitude"), _LOG_KIND[cfg.log],
        cfg.log_floor, *ptrs(dct), out.shape[-1], out.data_ptr(),
        passes(cfg), torch.cuda.current_stream(buf.device).cuda_stream)
    raise_on(so, err, what)


def signal_features(buf: torch.Tensor, n_frames: int,
                    cfg: FeatureConfig) -> torch.Tensor:
    """Fused signal -> features [B, n_frames, D] (see the module docstring).

    A CUDA tensor launches the kernel at ``cfg.matmul_precision`` on the
    current stream (the library builds at the first such call) and raises
    if the launch fails; a CPU tensor runs the plain twin. Nothing falls
    back."""
    global mma_launches
    _check(buf, n_frames, cfg)
    if buf.device.type == "cpu":
        return signal_features_reference(buf, n_frames, cfg)
    if buf.device.type != "cuda":
        raise ValueError(f"no signal kernel for device {buf.device}")
    B, M = buf.shape
    out = torch.empty(B, n_frames, _out_dim(cfg), device=buf.device,
                      dtype=torch.float32)
    launch_mma(buf, n_frames, cfg.hop_length, cfg, True, out,
               "tensor-core signal kernel launch")
    mma_launches += 1
    return out
