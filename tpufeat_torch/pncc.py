"""Power-Normalized Cepstral Coefficients (PNCC, Kim & Stern 2012) —
counterpart of ``tpufeat/pncc.py``.

The chain takes the spectral stage everything else takes (a gammatone power
filterbank is one more filterbank matrix, ``mel_bin_style="gammatone"``,
through the fused signal kernel with log "none") and replaces the log with
the published noise-suppression stack:

  gammatone power P[m, l]
    -> medium-time power Q: mask-aware 5-frame mean
    -> asymmetric noise floor Qle (lambda_a / lambda_b lowpass: rises slowly
       toward bursts, falls fast after them), half-wave Q0 = max(Q - Qle, 0)
    -> temporal masking: peak tracker Qp (lambda_t), suppression mu_t; a
       second asymmetric filter on Q0 gives the floor Qf
    -> excitation switch: R = Qtm where Q >= c * Qle, else Qf
    -> spectral weight smoothing S = channel mean_{+-4}(R / Q); T = P * S
    -> mean power normalization: running mu (lambda_mu), U = T / mu
    -> power law V = U^(1/15) -> DCT-II, keep pncc_ceps

The two frame recursions (noise floor and peak tracker; power mean) are
Python loops over frames of [B, M]-wide elementwise steps, the reference's
two ``lax.scan``s. Each row starts its carries at its own first valid
frame and freezes them through padding, and every windowed mean is
mask-aware, so a padded batch gives each row what the row alone gives.
The float64 golden (``reference.cpu.pncc_from_power``) computes the same
equations by direct loops.

The published constants (Kim & Stern 2012, §III) are fixed here, as in the
reference; the golden takes them from this module.
"""

from __future__ import annotations

import torch

from tpufeat_torch import matrices
from tpufeat_torch.config import FeatureConfig

LAMBDA_A = 0.999      # asymmetric lowpass, rising branch
LAMBDA_B = 0.5        # asymmetric lowpass, falling branch
LAMBDA_T = 0.85       # temporal-masking peak decay
MU_T = 0.2            # temporal-masking suppression
C_EXC = 2.0           # excitation / non-excitation switch
LAMBDA_MU = 0.999     # mean-power normalization decay
POWER = 1.0 / 15.0    # power-law nonlinearity
M_MED = 2             # medium-time window: l +- 2
N_SPEC = 4            # spectral smoothing: m +- 4


def _asym_step(prev: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """One step of the asymmetric lowpass: fast attack, slow release."""
    lam = torch.where(q >= prev, LAMBDA_A, LAMBDA_B).to(q.dtype)
    return lam * prev + (1.0 - lam) * q


def _shifted(x: torch.Tensor, off: int, dim: int) -> torch.Tensor:
    """y[..., i, ...] = x[..., i + off, ...] along ``dim``, zeros past the
    ends."""
    n = x.shape[dim]
    if off == 0:
        return x
    if abs(off) >= n:
        return torch.zeros_like(x)
    if off > 0:
        body = x.narrow(dim, off, n - off)
        pad = torch.zeros_like(x.narrow(dim, 0, off))
        return torch.cat([body, pad], dim=dim)
    body = x.narrow(dim, 0, n + off)
    pad = torch.zeros_like(x.narrow(dim, 0, -off))
    return torch.cat([pad, body], dim=dim)


def _window_mean(x: torch.Tensor, mask: torch.Tensor, half: int,
                 dim: int) -> torch.Tensor:
    """Mask-aware moving average along ``dim`` over the window +-``half``:
    the sum of the valid neighbours over their count."""
    num = x * mask
    n = sum(_shifted(num, off, dim) for off in range(-half, half + 1))
    d = sum(_shifted(mask, off, dim) for off in range(-half, half + 1))
    return n / torch.clamp(d, min=1e-20)


def pncc_from_power(p: torch.Tensor, mask: torch.Tensor,
                    cfg: FeatureConfig) -> torch.Tensor:
    """[B, F, M] gammatone power (+ [B, F] mask) -> [B, F, pncc_ceps] PNCC.
    Padding frames give zeros and never touch the recursions' carries."""
    from tpufeat_torch import features
    B, F, M = p.shape
    dt, dev = p.dtype, p.device
    m3 = mask.to(dt)[..., None]                           # [B, F, 1]
    q = _window_mean(p, m3, M_MED, dim=1)                 # medium-time
    valid = mask.to(device=dev, dtype=torch.bool)[..., None]   # [B, F, 1]

    # noise floor, peak tracker and excitation switch, frame by frame
    qle = torch.zeros(B, M, dtype=dt, device=dev)
    qf = torch.zeros_like(qle)
    qp = torch.zeros_like(qle)
    seen = torch.zeros(B, 1, dtype=torch.bool, device=dev)
    r = torch.empty_like(q)
    for l in range(F):
        q_l, keep = q[:, l], valid[:, l]
        fresh = keep & ~seen           # the row's first valid frame
        qle_l = torch.where(fresh, 0.9 * q_l, _asym_step(qle, q_l))
        q0 = torch.clamp(q_l - qle_l, min=0.0)
        qf_l = torch.where(fresh, q0, _asym_step(qf, q0))
        qp_prev = torch.where(fresh, q0, qp)
        qtm = torch.where(q0 >= LAMBDA_T * qp_prev, q0, MU_T * qp_prev)
        qp_l = torch.maximum(LAMBDA_T * qp_prev, q0)
        r[:, l] = torch.where(q_l >= C_EXC * qle_l, qtm, qf_l)
        # the carries freeze through padding
        qle = torch.where(keep, qle_l, qle)
        qf = torch.where(keep, qf_l, qf)
        qp = torch.where(keep, qp_l, qp)
        seen = seen | keep

    # spectral weight smoothing over channels (every channel valid)
    w = r / torch.clamp(q, min=1e-20)
    s = _window_mean(w, torch.ones_like(w), N_SPEC, dim=2)
    t = p * s

    # mean power normalization: a running mean of the channel mean
    tbar = t.mean(dim=2)                                  # [B, F]
    mu = torch.empty_like(tbar)
    mu_c = torch.zeros(B, dtype=dt, device=dev)
    seen = torch.zeros(B, dtype=torch.bool, device=dev)
    for l in range(F):
        tb, keep = tbar[:, l], valid[:, l, 0]
        mu_l = torch.where(keep & ~seen, tb,
                           LAMBDA_MU * mu_c + (1.0 - LAMBDA_MU) * tb)
        mu[:, l] = mu_l
        mu_c = torch.where(keep, mu_l, mu_c)
        seen = seen | keep
    u = t / torch.clamp(mu[..., None], min=1e-20)
    v = torch.clamp(u, min=cfg.log_floor) ** POWER

    out = features.matmul(v, matrices.dct_matrix(M, cfg.pncc_ceps))
    if cfg.lifter > 0:
        out = out * features._const(
            matrices.lifter_vector(cfg.pncc_ceps, cfg.lifter), out)
    return out * m3
