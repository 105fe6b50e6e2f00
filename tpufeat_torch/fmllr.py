"""fMLLR (constrained MLLR) speaker adaptation — the Kaldi
``gmm-est-fmllr`` / ``transform-feats`` pair over the port's
:class:`tpufeat_torch.ivector.DiagUbm`; counterpart of
``tpufeat/fmllr.py``.

Model (Gales 1998): an affine feature transform ``W = [A | b]`` chosen
to maximize the adaptation data's likelihood under the diagonal GMM,

    Q(W) = beta * log|det A| + sum_d [ w_d^T k_d - 1/2 w_d^T G_d w_d ]

with per-row statistics over extended frames ``x^ = [x; 1]``:

    beta = sum_t sum_g gamma_tg
    k_d  = sum_t sum_g gamma_tg * mu_gd / sigma2_gd * x^_t        [D+1]
    G_d  = sum_t sum_g gamma_tg / sigma2_gd * x^_t x^_t^T         [D+1, D+1]

The O(T·G·D) statistics are products on the device (the UBM's posteriors,
then ``gamma @ (mu/sigma2)`` and ``gamma @ (1/sigma2)``, then two batched
products against ``x^``), in fp32 with TF32 off; the estimation is the
classic row-wise cofactor update on the tiny [D, D+1] system in float64
numpy, each row's alpha the closed-form root of ``alpha^2 (p·m) + alpha
(p·n) - beta = 0``.

Apply the result with :func:`tpufeat_torch.data.apply_transform`. Float64
golden for the statistics: ``tpufeat_torch.reference.cpu.fmllr_stats``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufeat_torch import features
from tpufeat_torch.ivector import DiagUbm, _cached, _frames, _posteriors
from tpufeat_torch.kernels.signal import no_tf32

__all__ = ["fmllr_stats", "estimate_fmllr", "est_fmllr",
           "fmllr_objective", "estimate_vtln_warp"]


def fmllr_stats(ubm: DiagUbm, feats, mask=None, *, min_post: float = 0.0,
                per_row: bool = False, device=None):
    """Accumulate fMLLR sufficient statistics for one speaker's
    adaptation data: [T, D] frames or a padded batch [B, T, D] (+ [B, T]
    or [B] ``mask``/lengths) -> ``(beta, K [D, D+1], G [D, D+1, D+1])``
    as float64 numpy (ready for :func:`estimate_fmllr`).

    ``per_row=True`` keeps the batch axis — ``(beta [B], K [B, D, D+1],
    G [B, D, D+1, D+1])`` — so a caller grouping utterances by speaker
    (the corpus pipeline) gets every row's statistics from one padded
    call."""
    x = _frames(feats, device)
    if x.dim() == 2:
        x = x[None]
    if x.dim() != 3 or x.shape[-1] != ubm.dim:
        raise ValueError(f"feats {tuple(np.shape(feats))} vs UBM dim "
                         f"{ubm.dim}")
    B, T, D = x.shape
    if mask is None:
        m = torch.ones(B, T, device=x.device)
    else:
        m = features.on_device(mask, x.device)
        if m.dim() == 1:                     # lengths
            m = torch.arange(T, device=x.device)[None, :] < m[:, None]
        m = m.to(torch.float32)
        if tuple(m.shape) != (B, T):
            raise ValueError(f"mask {tuple(m.shape)} vs frames {(B, T)}")
    muinv, inv = _cached(
        ubm, "fmllr", lambda: ((ubm.means / ubm.vars).astype(np.float32),
                               (1.0 / ubm.vars).astype(np.float32)),
        x.device)
    post = _posteriors(x, ubm.device_operands(x.device), min_post)
    post = post * m[..., None]                               # [B, T, G]
    xe = torch.cat([x, torch.ones(B, T, 1, device=x.device)], dim=-1)
    with no_tf32():
        wk = post @ muinv                                    # [B, T, D]
        wg = post @ inv
        K = wk.transpose(1, 2) @ xe                          # [B, D, D+1]
        # G[b, d] = sum_t wg[t, d] xe_t xe_t^T, one product a row
        G = ((wg[..., None] * xe[:, :, None, :]).reshape(B, T, -1)
             .transpose(1, 2) @ xe).reshape(B, D, D + 1, D + 1)
    beta = post.sum(dim=(1, 2))
    if not per_row:
        beta, K, G = beta.sum(), K.sum(dim=0), G.sum(dim=0)
    beta, K, G = (v.double().cpu().numpy() for v in (beta, K, G))
    return (beta, K, G) if per_row else (float(beta), K, G)


def estimate_fmllr(beta: float, K: np.ndarray, G: np.ndarray, *,
                   iters: int = 20, min_count: float = 500.0,
                   ridge: float = 1e-8):
    """Row-wise iterative fMLLR estimation (Gales 1998; Kaldi
    ``ComputeFmllrMatrixDiagGmm``) from :func:`fmllr_stats` output.
    Returns ``W`` [D, D+1] float64 (identity-affine when ``beta <
    min_count`` — Kaldi's ``--fmllr-min-count`` fallback).

    Each row solves ``w_d = G_d^{-1}(k_d + alpha p_d)`` where ``p_d`` is
    the cofactor row of the current square part and alpha is the
    positive-determinant root of the quadratic stationarity condition;
    ``iters`` full sweeps. ``ridge`` scales a diagonal loading of each G_d
    relative to its mean diagonal (guards rank-deficient small-count
    stats)."""
    K = np.asarray(K, np.float64)
    G = np.asarray(G, np.float64)
    D = K.shape[0]
    if K.shape != (D, D + 1) or G.shape != (D, D + 1, D + 1):
        raise ValueError(f"bad stats shapes {K.shape} {G.shape}")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    W = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
    if beta < min_count:
        return W
    Gl = G + (ridge * np.einsum("dii->d", G)[:, None, None]
              / (D + 1) * np.eye(D + 1)[None])
    for _ in range(iters):
        for d in range(D):
            A = W[:, :D]
            # cofactor row d: det(A) * inv(A)^T row d; any positive scale
            # of p leaves the optimum invariant (alpha rescales), so use
            # inv(A).T with the current det's sign
            sign = np.sign(np.linalg.det(A)) or 1.0
            p = np.zeros(D + 1)
            p[:D] = sign * np.linalg.inv(A).T[d]
            n = np.linalg.solve(Gl[d], K[d])
            m = np.linalg.solve(Gl[d], p)
            pm = p @ m
            pn = p @ n
            if pm <= 0:
                raise np.linalg.LinAlgError(
                    "fMLLR G_d not positive definite (too few frames? "
                    "raise min_count or ridge)")
            disc = np.sqrt(pn * pn + 4.0 * pm * beta)
            roots = [(-pn + disc) / (2 * pm), (-pn - disc) / (2 * pm)]

            # the root maximizing the row objective
            # beta*log|pn + alpha*pm| - 1/2 alpha^2 pm
            def row_obj(alpha):
                det_term = pn + alpha * pm
                if det_term == 0.0:
                    return -np.inf
                return beta * np.log(abs(det_term)) - 0.5 * alpha ** 2 * pm
            alpha = max(roots, key=row_obj)
            W[d] = n + alpha * m
    return W


def fmllr_objective(beta: float, K: np.ndarray, G: np.ndarray,
                    W: np.ndarray) -> float:
    """The fMLLR auxiliary Q(W) (up to a W-independent constant) — the
    quantity :func:`estimate_fmllr` maximizes."""
    W = np.asarray(W, np.float64)
    D = W.shape[0]
    logdet = np.linalg.slogdet(W[:, :D])[1]
    quad = sum(W[d] @ K[d] - 0.5 * W[d] @ G[d] @ W[d] for d in range(D))
    return float(beta * logdet + quad)


def est_fmllr(ubm: DiagUbm, feats, mask=None, *, iters: int = 20,
              min_count: float = 500.0, min_post: float = 0.0,
              device=None):
    """One-call estimation: adaptation frames -> ``W`` [D, D+1] (apply
    with ``tpufeat_torch.data.apply_transform(feat, W)``)."""
    beta, K, G = fmllr_stats(ubm, feats, mask, min_post=min_post,
                             device=device)
    return estimate_fmllr(beta, K, G, iters=iters, min_count=min_count)


def estimate_vtln_warp(ubm: DiagUbm, signal, lengths=None, *, cfg=None,
                       warps=None, device=None):
    """Per-speaker VTLN warp-factor estimation by UBM-likelihood grid
    search (pick the warp whose warped-filterbank features the
    speaker-independent model likes best). ``signal``: [N] or padded
    [B, N] (+ lengths) of one speaker's audio; ``cfg``: the feature
    config whose ``vtln_warp`` field is swept (default MFCC13_HTK);
    ``warps``: candidate factors (default 0.80..1.20 in 0.02 steps,
    Kaldi's grid). Each candidate is one ``extract`` and one UBM scoring
    pass on ``device``.

    Returns ``(best_warp, per_warp_loglikes)``."""
    from tpufeat_torch.config import MFCC13_HTK

    cfg = MFCC13_HTK if cfg is None else cfg
    if cfg.feature_dim != ubm.dim:
        raise ValueError(f"cfg feature_dim {cfg.feature_dim} != UBM dim "
                         f"{ubm.dim}")
    if warps is None:
        warps = np.round(np.arange(0.80, 1.2001, 0.02), 2)
    x = features.placed(signal, device).to(torch.float32)
    if x.dim() == 1:
        x = x[None]
    if lengths is None:
        lengths = np.full(x.shape[0], x.shape[1], np.int32)
    if cfg.num_frames(int(np.max(np.asarray(lengths)))) <= 0:
        raise ValueError("no valid frames: every utterance is shorter "
                         f"than one {cfg.frame_length}-sample frame")
    scores = []
    for w in warps:
        res = features.extract(x, lengths,
                               dataclasses.replace(cfg, vtln_warp=float(w)))
        tot = torch.logsumexp(ubm.log_likes(res.features), dim=-1)
        mask = res.mask.to(tot.dtype)
        scores.append(float((tot * mask).sum() / mask.sum()))
    best = int(np.argmax(scores))
    return float(warps[best]), dict(zip(map(float, warps), scores))
