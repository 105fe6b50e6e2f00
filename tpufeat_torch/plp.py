"""Perceptual Linear Prediction (PLP) cepstra — counterpart of
``tpufeat/plp.py``.

The Kaldi/HTK-style chain, applied to the filterbank energies the rest of
the package computes (log "none"), so the fused signal kernel, the staged
route and the streaming steps all feed it unchanged; the tail is
frame-local:

  filterbank energies E[m]
    -> equal-loudness weighting  E * El(f_m)
    -> intensity-loudness power law  (.)^plp_compress
    -> symmetric IDFT -> autocorrelation r[0..p] (one small product)
    -> Levinson-Durbin -> LPC a[1..p], residual E_p
    -> LPC-to-cepstrum recursion -> c[1..p]; c[0] = ln(E_p)
    -> optional sinusoidal lifter (cfg.lifter, shared with MFCC)

Conventions (published PLP variants differ): the autocorrelation is
r_k = (1/N) sum_n S[n] cos(2 pi k n / N) of the even-symmetric spectrum
extension, N = 2 (M + 1), with Kaldi's duplicated endpoints a_0 := E_1,
a_{M+1} := E_M; LPC predicts x_n ~= sum_i a_i x_{n-i}; the cepstra are
those of the minimum-phase model 1 / (1 - sum a_i z^-i). The float64
golden (``reference/cpu.py``) computes the same quantities by other
algorithms (ifft, Toeplitz solves).

Precision: Levinson-Durbin multiplies the error of its input by the
frame's Toeplitz condition number, so the autocorrelation product runs in
full fp32 through ``features.matmul`` whatever the caller's TF32 setting.
TF32 keeps a 10-bit mantissa, as one bf16 pass keeps 8, and one such pass
put the chain far outside the golden budget in the reference package.
"""

from __future__ import annotations

import torch

from tpufeat_torch import matrices
from tpufeat_torch.config import FeatureConfig


def plp_from_energies(mel: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """[..., F, n_mels] filterbank energies -> [..., F, plp_order+1] PLP."""
    from tpufeat_torch import features
    order = cfg.plp_order
    el = features._const(matrices.equal_loudness_vector(
        cfg.n_mels, cfg.fmin, cfg.fmax_hz, cfg.mel_scale), mel)
    p = torch.clamp(mel * el, min=cfg.log_floor) ** cfg.plp_compress
    # duplicated endpoints, then the [M+2, order+1] IDFT product in fp32
    a = torch.cat([p[..., :1], p, p[..., -1:]], dim=-1)
    r = features.matmul(a, matrices.plp_idft_matrix(cfg.n_mels, order))
    lpc, err = durbin(r, order, floor=cfg.log_floor)
    c = lpc_to_cepstrum(lpc, order)
    c0 = torch.log(torch.clamp(err, min=cfg.log_floor))[..., None]
    out = torch.cat([c0, c], dim=-1)
    if cfg.lifter > 0:
        out = out * features._const(
            matrices.lifter_vector(order + 1, cfg.lifter), out)
    return out


def durbin(r: torch.Tensor, order: int, floor: float = 1e-10
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Levinson-Durbin: autocorrelation [..., order+1] -> (LPC [..., order],
    prediction-error energy [...]), unrolled over the order as elementwise
    operations over the leading dimensions. The error energy is floored at
    every step, so silence (r ~ 0) gives zero reflection coefficients, not
    0/0."""
    e = torch.clamp(r[..., 0], min=floor)
    a: list = []                       # a[i-1] == a_i at the current order
    for m in range(1, order + 1):
        acc = r[..., m]
        for i in range(1, m):
            acc = acc - a[i - 1] * r[..., m - i]
        k = acc / e
        a = [a[i - 1] - k * a[m - i - 1] for i in range(1, m)] + [k]
        e = torch.clamp(e * (1.0 - k * k), min=floor)
    return torch.stack(a, dim=-1), e


def lpc_to_cepstrum(lpc: torch.Tensor, order: int) -> torch.Tensor:
    """LPC [..., order] -> cepstra c_1..c_order [..., order] of the
    minimum-phase all-pole model, unrolled like :func:`durbin`."""
    c: list = []                       # c[i-1] == c_i
    for n in range(1, order + 1):
        acc = lpc[..., n - 1]
        for k in range(1, n):
            acc = acc + (k / n) * c[k - 1] * lpc[..., n - k - 1]
        c.append(acc)
    return torch.stack(c, dim=-1)
