"""Multi-channel front-end: GCC-PHAT time-delay estimation and steered
delay-and-sum beamforming (BeamformIt-style array preprocessing ahead of a
single-channel front-end) — counterpart of ``tpufeat/beamform.py``.

Batched rFFTs (``torch.fft``) and elementwise complex arithmetic at static
power-of-two lengths: the correlation window is two slices, the taps
around the peak for sub-sample refinement are gathers, and fractional
steering is a frequency-domain phase ramp, so the whole align-and-sum is
three FFT passes per channel.

Conventions: ``delays[..., c] = d`` means channel c is LATE by ``d``
samples against the reference channel; steering ADVANCES each channel by
its delay so the summed wavefronts align. Float64 goldens:
``tpufeat_torch.reference.cpu.gcc_phat`` / ``delay_and_sum``. Tensors
live on the caller's device, the card unless it names the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufeat_torch import features

__all__ = ["gcc_phat", "steer", "delay_and_sum"]


def _pow2_len(n: int, max_delay: int) -> int:
    """FFT length: zero headroom >= max_delay keeps the circular
    correlation linear over the +-max_delay window."""
    p = 1
    while p < n + 2 * max_delay:
        p *= 2
    return p


def _check(x, max_delay: int, device):
    x = features.placed(x, device).to(torch.float32)
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    if x.dim() != 3:
        raise ValueError(f"expected [C, N] or [B, C, N], got "
                         f"{tuple(x.shape)}")
    if x.shape[1] < 2:
        raise ValueError(f"need >= 2 channels, got {x.shape[1]}")
    if not 1 <= max_delay < x.shape[2]:
        raise ValueError(f"max_delay {max_delay} outside [1, N)")
    return x, squeeze


def gcc_phat(x, *, max_delay: int = 64, ref: int = 0,
             subsample: bool = True, lengths=None,
             device=None) -> torch.Tensor:
    """GCC-PHAT time-difference-of-arrival estimates: [C, N] (or
    [B, C, N]) time-aligned recordings -> delays [C] (or [B, C]) float32,
    ``delays[ref] == 0``, searched over +-``max_delay`` samples;
    ``subsample`` adds parabolic interpolation around the peak.
    ``lengths`` [B] zeroes each row's padding first."""
    x, squeeze = _check(x, max_delay, device)
    B, C, N = x.shape
    if not 0 <= ref < C:
        raise ValueError(f"ref {ref} out of range for {C} channels")
    if lengths is not None:
        ln = features.on_device(lengths, x.device)
        x = x * (torch.arange(N, device=x.device)[None, None, :]
                 < ln[:, None, None]).to(x.dtype)
    w = int(max_delay)
    p = _pow2_len(N, w)
    X = torch.fft.rfft(x, n=p, dim=-1)
    cross = X * torch.conj(X[:, ref: ref + 1])
    phat = cross / torch.clamp(torch.abs(cross), min=1e-12)
    corr = torch.fft.irfft(phat, n=p, dim=-1)
    # circular lags -w..w as a linear window of 2w + 1
    win = torch.cat([corr[..., p - w:], corr[..., : w + 1]], dim=-1)
    idx = torch.argmax(win, dim=-1)                       # [B, C]
    delay = idx.to(torch.float32) - w
    if subsample:
        def pick(off):
            j = torch.clamp(idx + off, 0, 2 * w)
            return torch.gather(win, -1, j[..., None])[..., 0]
        cm, c0, cp = pick(-1), pick(0), pick(1)
        denom = cm - 2.0 * c0 + cp
        frac = torch.where(torch.abs(denom) > 1e-12,
                           0.5 * (cm - cp) / denom, 0.0)
        interior = (idx > 0) & (idx < 2 * w)
        delay = delay + torch.where(interior, torch.clamp(frac, -1.0, 1.0),
                                    0.0)
    # the reference channel's own peak is at 0 by construction
    delay[:, ref] = 0.0
    return delay[0] if squeeze else delay


def steer(x, delays, device=None) -> torch.Tensor:
    """Advance each channel by its (fractional) delay: with ``delays =
    gcc_phat(x)`` the channels come back aligned to the reference. [C, N]
    + [C] (or batched) -> the same shape."""
    x = features.placed(x, device).to(torch.float32)
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    d = features.on_device(delays, x.device).to(torch.float32)
    d = d[None] if d.dim() == 1 else d
    if x.dim() != 3 or tuple(d.shape) != tuple(x.shape[:2]):
        raise ValueError(f"shapes {tuple(x.shape)} / {tuple(d.shape)} "
                         "inconsistent")
    n = x.shape[2]
    p = _pow2_len(n, 1)
    X = torch.fft.rfft(x, n=p, dim=-1)
    k = torch.arange(p // 2 + 1, dtype=torch.float32, device=x.device)
    # y[t] = x[t + d]  <=>  Y_k = X_k * exp(+2 pi i k d / P)
    ang = 2.0 * np.pi * k[None, None, :] * d[..., None] / p
    ramp = torch.polar(torch.ones_like(ang), ang)
    out = torch.fft.irfft(X * ramp, n=p, dim=-1)[..., :n]
    return out[0] if squeeze else out


def delay_and_sum(x, *, max_delay: int = 64, ref: int = 0,
                  subsample: bool = True, weights=None, lengths=None,
                  device=None):
    """Steered delay-and-sum: GCC-PHAT delays against ``ref``, each
    channel advanced by its delay, then the mean (or the ``weights``
    average, [C] or [B, C], normalized to sum to 1). [C, N] -> [N] (or
    [B, C, N] -> [B, N]); returns ``(beamformed, delays)``."""
    x, squeeze = _check(x, max_delay, device)
    d = gcc_phat(x, max_delay=max_delay, ref=ref, subsample=subsample,
                 lengths=lengths)
    y = steer(x, d)
    if weights is None:
        out = torch.mean(y, dim=1)
    else:
        wt = features.on_device(weights, x.device).to(
                torch.float32)
        wt = wt[None] if wt.dim() == 1 else wt
        if tuple(wt.shape) != tuple(x.shape[:2]):
            raise ValueError(f"weights {tuple(wt.shape)} vs channels "
                             f"{tuple(x.shape[:2])}")
        tot = torch.sum(wt, dim=1, keepdim=True)
        if bool((tot <= 0).any()):
            raise ValueError("weights must sum to > 0 per batch row")
        out = torch.sum(y * (wt / tot)[..., None], dim=1)
    return (out[0], d[0]) if squeeze else (out, d)
