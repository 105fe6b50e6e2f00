"""Fused signal -> features: the Hopper kernel's wrapper and its plain twin.

Replaces the TPU kernels of ``tpufeat/pallas/fused.py`` that frame inside
the kernel — ``signal_features`` -> ``_signal_kernel`` (v4 hop-split layout)
and ``_signal_features_phase`` -> ``_phase_signal_kernel`` (v5 phase-packed
layout) — with ONE CUDA kernel, ``tpufeat_torch/csrc/signal_features.cu``.
The two TPU layouts exist only to fit 128-lane rows; a Hopper block stages a
contiguous span of the signal in shared memory and reads its overlapping
frames straight out of it.

Contract (that of ``fused.signal_features``): ``buf`` [B, M] float32 is the
framing buffer, frame t covers ``buf[t*hop : t*hop + frame_length]`` and
reads past M are zeros. The result is [B, n_frames, D] float32, with
D = n_mfcc (MFCCs) or n_mels (log-mel; log10 for whisper, which the caller
then normalizes).

What bounds it on an H100: fp32 FLOPs. An estimate from the shapes, not a
measurement: the dual Whisper-80 + MFCC-13 call at B=128 x 30 s is about
3.2e11 FLOP against about 0.6 GB moved, so about 4.7 ms at the published
67 TFLOP/s fp32 peak and about 0.2 ms at 3.35 TB/s (H100 SXM, 700 W). The
design keeps frames, spectrum and mel in shared memory, so device memory
sees only the signal and the features, and it register-blocks the DFT
(8 frames x 8 columns per thread) to keep the FMA pipes fed.

Precision: every ``matmul_precision`` value runs in fp32 FFMA. Each value's
fidelity contract is an upper bound on error, and fp32 meets all three.
The tensor-core mappings are later work.

Bits: the tile (TILE_FRAMES frames) and the order of every sum are fixed,
whatever the call's shape, so a frame's features do not depend on where it
falls in a call.

The staged kernels (``kernels/staged.py``) live in the same library and
share this module's binding (:func:`lib`), constants and twin body.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from tpufeat_torch import framing, matrices
from tpufeat_torch.config import FeatureConfig
from tpufeat_torch.kernels import _build

TILE_FRAMES = 32       # frames per block: TF in csrc/signal_features.cu
#: kernel launches so far (a plain count; the plain twin never adds to it)
launches = 0

_LOG_KIND = {"none": 0, "natural": 1, "log10": 2, "whisper": 2}


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False      # cached: every caller shares one array
    return a


@contextlib.contextmanager
def no_tf32():
    """Full fp32 matrix products inside the block (a plain twin states its
    precision); the caller's TF32 flags are restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


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


def put(a: np.ndarray | None, device: torch.device) -> torch.Tensor | None:
    """A cached constant as a tensor on ``device`` (None stays None)."""
    return None if a is None else torch.tensor(a, device=device)


@functools.lru_cache(maxsize=None)
def _device_constants(cfg: FeatureConfig, device: torch.device):
    return (put(cs_constant(cfg), device), put(fb_constant(cfg), device),
            put(dct_constant(cfg), device))


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
    if cfg.n_mels <= 0 or cfg.n_fft % 2:
        raise ValueError("the signal kernel needs n_mels > 0 and an even "
                         f"n_fft (got n_mels={cfg.n_mels}, n_fft={cfg.n_fft})")


def _out_dim(cfg: FeatureConfig) -> int:
    return cfg.n_mels if dct_constant(cfg) is None else cfg.n_mfcc


def log_tail(mel: torch.Tensor, dct: torch.Tensor | None,
             cfg: FeatureConfig) -> torch.Tensor:
    """The twins' shared tail after the mel product: the floored log (or
    none), then the DCT when the kernel runs it."""
    kind = _LOG_KIND[cfg.log]
    if kind == 1:
        mel = torch.log(torch.clamp(mel, min=cfg.log_floor))
    elif kind == 2:
        mel = torch.log10(torch.clamp(mel, min=cfg.log_floor))
    return mel if dct is None else mel @ dct


def dft_tail(frames: torch.Tensor, cs: torch.Tensor, fb: torch.Tensor,
             dct: torch.Tensor | None, cfg: FeatureConfig) -> torch.Tensor:
    """The twins' shared body from frames on: frames @ CS -> square (or
    |X|) -> @ fb -> :func:`log_tail`."""
    z = frames @ cs
    sq = z * z
    if cfg.spectrum == "magnitude":
        nb = cfg.n_bins
        im2 = torch.zeros_like(sq[..., :nb])
        im2[..., 1: nb - 1] = sq[..., nb:]
        sq = torch.sqrt(sq[..., :nb] + im2)
    return log_tail(sq @ fb, dct, cfg)


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
            ("tpufeat_signal_features",
             [i, p, i, ll, i, i, i, p, i, p, i, i, i, i, i, f, p, i, p, p]),
            ("tpufeat_mel_log_dct", [i, p, i, i, p, i, i, f, p, i, p, p]),
            ("tpufeat_signal_resources", [i, i, i, i, out, out]),
            ("tpufeat_tail_resources", [i, i, out, out])):
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


def query_resources(query, *args) -> tuple[int, int]:
    """(dynamic shared memory per block in bytes, blocks per SM) from one
    of the library's resource queries, on the current CUDA device."""
    so = lib(str(_build.CSRC))
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    raise_on(so, getattr(so, query)(*args, ctypes.byref(smem),
                                    ctypes.byref(blocks)), "occupancy query")
    return smem.value, blocks.value


def resources(cfg: FeatureConfig) -> tuple[int, int]:
    """(dynamic shared memory per block in bytes, blocks per SM) of the
    kernel's launch for ``cfg`` on the current CUDA device."""
    return query_resources("tpufeat_signal_resources", cfg.hop_length,
                           cfg.frame_length, 2 * cfg.n_bins - 2, cfg.n_mels)


def signal_features(buf: torch.Tensor, n_frames: int,
                    cfg: FeatureConfig) -> torch.Tensor:
    """Fused signal -> features [B, n_frames, D] (see the module docstring).

    A CUDA tensor launches the Hopper kernel on the current stream (the
    library builds at the first such call) and raises if the launch fails;
    a CPU tensor runs the plain twin. Nothing falls back."""
    global launches
    _check(buf, n_frames, cfg)
    if buf.device.type == "cpu":
        return signal_features_reference(buf, n_frames, cfg)
    if buf.device.type != "cuda":
        raise ValueError(f"no signal kernel for device {buf.device}")
    so = lib(str(_build.CSRC))
    cs, fb, dct = _device_constants(cfg, buf.device)
    B, M = buf.shape
    out = torch.empty(B, n_frames, _out_dim(cfg), device=buf.device,
                      dtype=torch.float32)
    magnitude = cfg.spectrum == "magnitude"
    err = so.tpufeat_signal_features(
        buf.device.index, buf.data_ptr(), B, M, n_frames, cfg.hop_length,
        cfg.frame_length, cs.data_ptr(), cs.shape[1], fb.data_ptr(),
        fb.shape[0], cfg.n_mels, int(magnitude), cfg.n_bins,
        _LOG_KIND[cfg.log], cfg.log_floor,
        None if dct is None else dct.data_ptr(), out.shape[-1],
        out.data_ptr(), torch.cuda.current_stream(buf.device).cuda_stream)
    raise_on(so, err, "signal kernel launch")
    launches += 1
    return out
