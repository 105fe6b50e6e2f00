"""Framed signal -> power/magnitude spectrum — counterpart of
``tpufeat/spectrum.py``.

Two interchangeable plain paths:

1. ``rfft``: ``torch.fft.rfft`` (cuFFT on the card); frames are zero-padded
   frame_length -> n_fft by the transform.
2. ``gemm``: the DFT as two matmuls against precomputed [frame_length,
   n_bins] cos/sin matrices with the analysis window folded in — the
   formulation the fused signal kernel runs. The products run in fp32
   whatever the caller's TF32 setting, as the reference pins them to
   HIGHEST.
"""

from __future__ import annotations

import torch

from tpufeat_torch import matrices
from tpufeat_torch.config import FeatureConfig
from tpufeat_torch.kernels.signal import no_tf32


def power_spectrum_rfft(windowed: torch.Tensor,
                        cfg: FeatureConfig) -> torch.Tensor:
    """[..., frame_length] windowed frames -> [..., n_bins] spectrum."""
    if windowed.numel() == 0:          # MKL's FFT refuses an empty batch
        return windowed.new_zeros(*windowed.shape[:-1], cfg.n_bins)
    spec = torch.fft.rfft(windowed, n=cfg.n_fft, dim=-1)
    p = spec.real * spec.real + spec.imag * spec.imag
    return p if cfg.spectrum == "power" else torch.sqrt(p)


def power_spectrum_gemm(raw_frames: torch.Tensor,
                        cfg: FeatureConfig) -> torch.Tensor:
    """[..., frame_length] RAW (conditioned, unwindowed) frames -> spectrum.

    The window is folded into the DFT matrices, so this consumes frames
    *before* the window multiply."""
    c, s = matrices.dft_matrices(cfg.frame_length, cfg.n_fft, cfg.window)
    kw = dict(dtype=raw_frames.dtype, device=raw_frames.device)
    with no_tf32():
        re = raw_frames @ torch.as_tensor(c, **kw)
        im = raw_frames @ torch.as_tensor(s, **kw)
    p = re * re + im * im
    return p if cfg.spectrum == "power" else torch.sqrt(p)
