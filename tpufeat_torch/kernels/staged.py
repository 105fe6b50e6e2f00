"""Staged spectro kernels: the Hopper kernels' wrappers and their plain twins.

Replaces the two row-blocked TPU kernels of ``tpufeat/pallas/fused.py``:

- K3, ``dft_mel_log_dct`` -> ``_full_kernel`` (the staged GEMM kernel):
  conditioned, unwindowed frames [..., frame_length] -> combined Re/Im DFT
  product -> square (or |X| rebuilt) -> folded mel product -> log -> DCT.
  On Hopper this is the signal kernel itself (``csrc/signal_features.cu``
  or ``csrc/signal_mma.cu``, by precision) launched over the rows as ONE
  buffer with hop = frame_length, and given the DFT matrix without the
  kaldi fold (its frames arrive conditioned).
- K4, ``mel_log_dct`` -> ``_tail_kernel``: power or magnitude spectrum rows
  [..., n_bins] -> mel product -> log -> DCT, the tail after an rFFT. Its
  CUDA kernel (``mel_log_dct_kernel``, same source) stages 32 rows in
  shared memory and runs the signal kernel's own mel/log and DCT code.

:func:`spectro_features` routes between them as ``fused.spectro_features``
does; the rFFT is ``torch.fft.rfft`` (cuFFT on the card), outside the
kernel as XLA's rFFT is outside the Pallas one.

What bounds them on an H100 (from the shapes; the measured times are in
PERF.md): K3 does the signal kernel's FLOPs per frame (about 4.4e5 for
MFCC-13 at fl=400, times the passes of its precision) against 1.6 KB in per
row, so it is operation-bound; K4 is load-bound: 1 KB in per row
(n_bins=257) for about 1.3e4 FLOP.

Precision: K3 runs the signal kernels at ``cfg.matmul_precision``, as the
TPU runs every product of ``_full_kernel`` at it: ``"highest"`` the fp32
FFMA kernel (``csrc/signal_features.cu``, counted in
:data:`dft_mel_log_dct_launches`), ``"bf16x3"`` and ``"default"`` the bf16
tensor-core kernel (``csrc/signal_mma.cu``, counted in
:data:`dft_mel_log_dct_mma_launches`), with the twins of
``kernels/signal.py`` and its tolerances. K4 computes fp32 FFMA at every
precision, which meets each one's fidelity contract; its twin is fp32.

Bits: both routes compute each row with a fixed tile and fixed-order sums,
so a row's features depend neither on R nor on the row's place in the
call. That keeps every hop-aligned streaming chunk plan bit-identical on
the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpufeat_torch import matrices, spectrum
from tpufeat_torch.config import FeatureConfig
from tpufeat_torch.kernels import _build, signal

#: kernel launches so far, one count per kernel and route (the twins never
#: add): K3 on the FFMA kernel, K3 on the tensor-core kernel, K4
dft_mel_log_dct_launches = 0
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
    fb, dct = _tail_constants(cfg, rows.device)
    with signal.no_tf32():
        return signal.log_tail(rows @ fb, dct, cfg)


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

    A CUDA tensor launches the kernel of ``cfg.matmul_precision`` on the
    current stream and raises if the launch fails; a CPU tensor runs the
    plain twin."""
    global dft_mel_log_dct_launches, dft_mel_log_dct_mma_launches
    rows = _check_dft(frames, cfg)
    lead, d = frames.shape[:-1], signal._out_dim(cfg)
    if rows.device.type == "cpu":
        return _dft_twin(rows, cfg).reshape(*lead, d)
    out = torch.empty(rows.shape[0], d, device=rows.device,
                      dtype=torch.float32)
    if rows.shape[0]:
        # the signal kernels over the buffer [1, R*fl], hop = fl
        R, fl = rows.shape
        if signal.passes(cfg):
            signal.launch_mma(rows.reshape(1, R * fl), R, fl, cfg, False,
                              out, "staged GEMM tensor-core kernel launch")
            dft_mel_log_dct_mma_launches += 1
            return out.reshape(*lead, d)
        so = signal.lib(str(_build.CSRC))
        cs, fb, dct = _dft_constants(cfg, rows.device)
        err = so.tpufeat_signal_features(
            rows.device.index, rows.data_ptr(), 1, R * fl, R, fl, fl,
            cs.data_ptr(), cs.shape[1], fb.data_ptr(), fb.shape[0],
            cfg.n_mels, int(cfg.spectrum == "magnitude"), cfg.n_bins,
            signal._LOG_KIND[cfg.log], cfg.log_floor,
            None if dct is None else dct.data_ptr(), d, out.data_ptr(),
            _stream(rows))
        signal.raise_on(so, err, "staged GEMM kernel launch")
        dft_mel_log_dct_launches += 1
    return out.reshape(*lead, d)


def mel_log_dct(spec: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Tail kernel (K4): power or magnitude spectrum [..., n_bins] ->
    features [..., D], D as in :func:`dft_mel_log_dct`.

    A CUDA tensor launches the Hopper kernel on the current stream and
    raises if the launch fails; a CPU tensor runs the plain twin."""
    global mel_log_dct_launches
    rows = _check_tail(spec, cfg)
    lead, d = spec.shape[:-1], signal._out_dim(cfg)
    if rows.device.type == "cpu":
        return _tail_twin(rows, cfg).reshape(*lead, d)
    out = torch.empty(rows.shape[0], d, device=rows.device,
                      dtype=torch.float32)
    if rows.shape[0]:
        so = signal.lib(str(_build.CSRC))
        fb, dct = _tail_constants(cfg, rows.device)
        err = so.tpufeat_mel_log_dct(
            rows.device.index, rows.data_ptr(), rows.shape[0], cfg.n_bins,
            fb.data_ptr(), cfg.n_mels, signal._LOG_KIND[cfg.log],
            cfg.log_floor, None if dct is None else dct.data_ptr(), d,
            out.data_ptr(), _stream(rows))
        signal.raise_on(so, err, "tail kernel launch")
        mel_log_dct_launches += 1
    return out.reshape(*lead, d)


def dft_resources(cfg: FeatureConfig) -> tuple[int, int]:
    """(dynamic shared memory per block in bytes, blocks per SM) of K3's
    FFMA launch for ``cfg`` on the current CUDA device: the signal kernel's
    launch with hop = frame_length (the tensor-core launch is
    ``signal.mma_resources``, K1's own)."""
    return signal.query_resources(
        "tpufeat_signal_resources", cfg.frame_length, cfg.frame_length,
        2 * cfg.n_bins - 2, cfg.n_mels)


def tail_resources(cfg: FeatureConfig) -> tuple[int, int]:
    """The same for K4's launch."""
    return signal.query_resources("tpufeat_tail_resources", cfg.n_bins,
                                  cfg.n_mels)


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
