"""Staged spectro kernels: the Hopper kernels' wrappers and their plain twins.

Replaces the two row-blocked TPU kernels of ``tpufeat/pallas/fused.py``:

- K3, ``dft_mel_log_dct`` -> ``_full_kernel`` (the staged GEMM kernel):
  conditioned, unwindowed frames [..., frame_length] -> combined Re/Im DFT
  product -> square (or |X| rebuilt) -> folded mel product -> log -> DCT.
  On Hopper this is the signal kernel itself (``csrc/signal_mma.cu``)
  launched over the rows as ONE buffer with hop = frame_length, and given
  the DFT matrix without the kaldi fold (its frames arrive conditioned).
- K4, ``mel_log_dct`` -> ``_tail_kernel``: power or magnitude spectrum rows
  [..., n_bins] -> mel product -> log -> DCT, the tail after an rFFT. Its
  CUDA kernel (``tail_mma_kernel``, same source) brings tiles of 64 rows
  into shared memory with bulk copies, a persistent grid stepping over
  them, and runs the mel product and the DCT on the tensor cores against
  fb's and the DCT's pieces packed as MMA fragments
  (:func:`tail_mma_constants`), with the signal kernel's split, passes and
  log.

:func:`spectro_features` routes between them as ``fused.spectro_features``
does; the rFFT is ``torch.fft.rfft`` (cuFFT on the card), outside the
kernel as XLA's rFFT is outside the Pallas one.

What bounds them on an H100 (from the shapes; the measured times are in
PERF.md): K3 does the signal kernel's FLOPs per frame (about 4.4e5 for
MFCC-13 at fl=400, times the passes of its precision) against 1.6 KB in per
row, so it is operation-bound; K4 is load-bound: 1 KB in per row
(n_bins=257) for about 1.3e4 FLOP times the passes.

Precision: both run every product at ``cfg.matmul_precision``, as the TPU
runs every product of ``_full_kernel`` and ``_tail_kernel`` at it
(``fused._cdot``): six bf16 passes for ``"highest"``, three for
``"bf16x3"``, one for ``"default"`` (``kernels/signal.py``). The twins
compute the same products (``signal.mm``), so a kernel and its twin differ
in the order of their f32 sums only; ``kernels/_tolerance.py`` holds them.

Bits: both compute each row with a fixed tile and fixed-order sums, so a
row's features depend neither on R nor on the row's place in the call.
That keeps every hop-aligned streaming chunk plan bit-identical on the
card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpufeat_torch import matrices, spectrum
from tpufeat_torch.config import FeatureConfig
from tpufeat_torch.kernels import _build, signal

#: kernel launches so far, one count per wrapper (the twins never add): K3
#: (the signal kernel over rows), K4
dft_mel_log_dct_mma_launches = 0
mel_log_dct_launches = 0

_MAX_ROWS = 2**31 - 1            # the kernels index rows with an int


@functools.lru_cache(maxsize=None)
def tail_fb_constant(cfg: FeatureConfig) -> np.ndarray:
    """float32 plain filterbank [n_bins, n_mels] for the tail kernel's
    spectrum rows, power or magnitude alike (``fused._tail_constants``
    without its lane padding)."""
    fb = matrices.mel_filterbank(*signal._mel_args(cfg))
    return signal._frozen(fb.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _dft_constants(cfg: FeatureConfig, device: torch.device):
    """(CS without the kaldi fold, folded or plain fb, dct or None)."""
    return (signal.put(signal.cs_constant(cfg, fold_kaldi=False), device),
            signal.put(signal.fb_constant(cfg), device),
            signal.put(signal.dct_constant(cfg), device))


@functools.lru_cache(maxsize=None)
def _tail_constants(cfg: FeatureConfig, device: torch.device):
    return (signal.put(tail_fb_constant(cfg), device),
            signal.put(signal.dct_constant(cfg), device))


def b_fragments(w: np.ndarray, n_pieces: int) -> np.ndarray:
    """A matrix w [K, N] as the B operands of ``mma.sync`` m16n8k16 (16 x 8,
    column-major), zero-padded to [16 * ks, 8 * nt] and split into
    ``n_pieces`` bf16 pieces: int32 [ks, nt, n_pieces, 32, 2], entry
    [s, j, p, lane, r] the register r of lane = 4 * g + t for piece p of
    the block rows 16 s .., columns 8 j ..: the bf16 pair (w[16 s + 8 r +
    2 t, 8 j + g], w[16 s + 8 r + 2 t + 1, 8 j + g]), the first in the low
    half. A warp reads one piece of one block as 256 contiguous bytes."""
    k, n = w.shape
    ks, nt = -(-k // 16), -(-n // 8)
    pad = np.zeros((16 * ks, 8 * nt), np.float32)
    pad[:k, :n] = w
    out = []
    for piece in signal.split_pieces(torch.from_numpy(pad), n_pieces):
        u = piece.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
        # row 16 s + 8 r + 2 t + e, column 8 j + g
        u = u.reshape(ks, 2, 4, 2, nt, 8).transpose(0, 4, 5, 2, 1, 3)
        out.append((u[..., 0] | (u[..., 1] << 16)).reshape(ks, nt, 32, 2))
    return np.ascontiguousarray(np.stack(out, axis=2)).view(np.int32)


@functools.lru_cache(maxsize=None)
def tail_mma_constants(cfg: FeatureConfig) -> tuple:
    """K4's constants at ``cfg``'s precision, as CPU tensors: the plain
    filterbank [n_bins, n_mels] and the DCT [n_mels, n_mfcc] (the lifter
    folded in; None where the kernel stops at the log-mel), each as its
    pieces' B fragments (:func:`b_fragments`)."""
    n = signal.PIECES[signal.passes(cfg)]
    dct = signal.dct_constant(cfg)
    return tuple(None if w is None else torch.from_numpy(b_fragments(w, n))
                 for w in (tail_fb_constant(cfg), dct))


@functools.lru_cache(maxsize=None)
def _tail_mma_device_constants(cfg: FeatureConfig, device: torch.device):
    return tuple(None if t is None else t.to(device)
                 for t in tail_mma_constants(cfg))


def _rows(x: torch.Tensor, width: int, what: str) -> torch.Tensor:
    """[..., width] floats -> contiguous float32 rows [R, width] (the cast
    of ``fused``'s ``astype(float32)``), on a device that has the kernel."""
    if not isinstance(x, torch.Tensor) or x.dim() < 1 \
            or x.shape[-1] != width:
        raise ValueError(f"the {what} kernel takes [..., {width}] rows, got "
                         f"{getattr(x, 'shape', type(x))}")
    if not x.is_floating_point():
        raise TypeError(f"the {what} kernel takes floats, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {x.device}")
    rows = x.reshape(-1, width).to(torch.float32).contiguous()
    if rows.shape[0] > _MAX_ROWS:
        raise ValueError(f"{rows.shape[0]} rows exceed the kernel's "
                         f"{_MAX_ROWS}: split the call")
    return rows


def _check_mel(cfg: FeatureConfig) -> None:
    if cfg.n_mels <= 0:
        raise ValueError("the staged kernels are mel-path kernels: need "
                         f"n_mels > 0, got {cfg.n_mels}")


def _dft_twin(rows: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    cs, fb, dct = _dft_constants(cfg, rows.device)
    with signal.no_tf32():
        return signal.dft_tail(rows, cs, fb, dct, cfg)


def _tail_twin(rows: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """The TPU's ``_mel_log_dct_tail``: the mel product and the DCT at
    ``cfg``'s passes."""
    fb, dct = _tail_constants(cfg, rows.device)
    with signal.no_tf32():
        return signal.log_tail(signal.mm(rows, fb, signal.passes(cfg)), dct,
                               cfg)


def _check_dft(frames: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    _check_mel(cfg)
    if cfg.n_fft % 2:
        raise ValueError(f"the staged GEMM kernel needs an even n_fft, got "
                         f"{cfg.n_fft}")
    signal.check_config(cfg)
    return _rows(frames, cfg.frame_length, "staged GEMM")


def _check_tail(spec: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    _check_mel(cfg)
    return _rows(spec, cfg.n_bins, "tail")


def dft_mel_log_dct_reference(frames: torch.Tensor,
                              cfg: FeatureConfig) -> torch.Tensor:
    """Plain torch twin of :func:`dft_mel_log_dct`, the same decomposition:
    rows @ CS -> square (or |X|) -> @ fb -> log -> @ dct."""
    rows = _check_dft(frames, cfg)
    return _dft_twin(rows, cfg).reshape(*frames.shape[:-1],
                                        signal._out_dim(cfg))


def mel_log_dct_reference(spec: torch.Tensor,
                          cfg: FeatureConfig) -> torch.Tensor:
    """Plain torch twin of :func:`mel_log_dct`: rows @ fb -> log -> @ dct."""
    rows = _check_tail(spec, cfg)
    return _tail_twin(rows, cfg).reshape(*spec.shape[:-1],
                                         signal._out_dim(cfg))


def _stream(rows: torch.Tensor) -> int:
    return torch.cuda.current_stream(rows.device).cuda_stream


def dft_mel_log_dct(frames: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Staged GEMM kernel (K3): conditioned, unwindowed frames
    [..., frame_length] -> features [..., D], D = n_mfcc, or n_mels for
    log-mel (log10 for whisper, which the caller then normalizes).

    A CUDA tensor launches the kernel at ``cfg.matmul_precision`` on the
    current stream and raises if the launch fails; a CPU tensor runs the
    plain twin."""
    global dft_mel_log_dct_mma_launches
    rows = _check_dft(frames, cfg)
    lead, d = frames.shape[:-1], signal._out_dim(cfg)
    if rows.device.type == "cpu":
        return _dft_twin(rows, cfg).reshape(*lead, d)
    out = torch.empty(rows.shape[0], d, device=rows.device,
                      dtype=torch.float32)
    if rows.shape[0]:
        # the signal kernel over the buffer [1, R*fl], hop = fl
        R, fl = rows.shape
        signal.launch_mma(rows.reshape(1, R * fl), R, fl, cfg, False, out,
                          "staged GEMM tensor-core kernel launch")
        dft_mel_log_dct_mma_launches += 1
    return out.reshape(*lead, d)


def mel_log_dct(spec: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Tail kernel (K4): power or magnitude spectrum [..., n_bins] ->
    features [..., D], D as in :func:`dft_mel_log_dct`.

    A CUDA tensor launches the Hopper kernel at ``cfg.matmul_precision``
    on the current stream and raises if the launch fails; a CPU tensor runs
    the plain twin. The kernel's bulk copies need 16-byte aligned rows, so
    rows that start elsewhere (a view at an odd offset) are copied first."""
    global mel_log_dct_launches
    rows = _check_tail(spec, cfg)
    lead, d = spec.shape[:-1], signal._out_dim(cfg)
    if rows.device.type == "cpu":
        return _tail_twin(rows, cfg).reshape(*lead, d)
    out = torch.empty(rows.shape[0], d, device=rows.device,
                      dtype=torch.float32)
    if rows.shape[0]:
        if rows.data_ptr() % 16:
            rows = rows.clone()
        so = signal.lib(str(_build.CSRC))
        fb, dct = _tail_mma_device_constants(cfg, rows.device)
        err = so.tpufeat_mel_log_dct_mma(
            rows.device.index, rows.data_ptr(), rows.shape[0], cfg.n_bins,
            fb.data_ptr(), cfg.n_mels, signal._LOG_KIND[cfg.log],
            cfg.log_floor, *signal.ptrs((dct,)), d, out.data_ptr(),
            signal.passes(cfg), _stream(rows))
        signal.raise_on(so, err, "tail kernel launch")
        mel_log_dct_launches += 1
    return out.reshape(*lead, d)


def tail_resources(cfg: FeatureConfig) -> tuple[int, int, int, int, int]:
    """(dynamic shared memory per block in bytes, blocks per SM, rows per
    tile, tiles in the ring, 1 where the constants' fragments are staged in
    shared memory) of K4's launch at ``cfg``'s precision on the current
    CUDA device."""
    dct = signal.dct_constant(cfg)
    return signal.query_resources(
        "tpufeat_tail_mma_resources", signal.passes(cfg), cfg.n_bins,
        cfg.n_mels, 0 if dct is None else dct.shape[1], outputs=5)


def spectro_features(frames: torch.Tensor, mask: torch.Tensor,
                     cfg: FeatureConfig) -> torch.Tensor:
    """Conditioned (unwindowed) frames [B, F, fl] -> features [B, F, D]:
    K3 with ``gemm_dft``, else the rFFT (|X| when ``spectrum`` is
    magnitude) and K4. Whisper's clamp needs the utterance max over valid
    frames, so it is applied here after the kernel, then its DCT."""
    if cfg.gemm_dft:
        out = dft_mel_log_dct(frames, cfg)
    else:
        w = torch.as_tensor(matrices.window(cfg.window, cfg.frame_length),
                            dtype=frames.dtype, device=frames.device)
        out = mel_log_dct(spectrum.power_spectrum_rfft(frames * w, cfg), cfg)
    if cfg.log == "whisper":
        from tpufeat_torch.features import dct_lifter, whisper_normalize
        out = whisper_normalize(out, mask)
        if cfg.n_mfcc > 0:
            out = dct_lifter(out, cfg)
    return out
