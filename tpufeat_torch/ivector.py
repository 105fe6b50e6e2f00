"""I-vector speaker embeddings (Kaldi ``ivector-extractor-*`` and the
online2 ``OnlineIvectorFeature``) — counterpart of ``tpufeat/ivector.py``.

Every hot step is a GEMM or a small batched Cholesky solve, with TF32 off
whatever the caller's setting (the reference's HIGHEST):

- diag-GMM log-likelihoods are two fp32 products, ``ll = gconst + x @ A.T
  + x² @ B.T`` with ``A = μ/σ²`` and ``B = -1/(2σ²)`` made once on the
  host, and the posteriors their fp32 softmax;
- an estimate needs only the zeroth-order counts ``N [G]`` and the
  projected linear term ``b [K] = Σ_g M_gᵀΣ_g⁻¹ (F_g − N_g μ_g)``. The
  first-order statistics ``F`` of a group of frames (a period block, a
  prefix up to a boundary, a window's block) are one batched product
  ``[D, n] @ [n, G]``, projected by one GEMM ``[rows, D·G] @ [D·G, K]``
  (:func:`_first_order`), in row chunks of at most :data:`CHUNK_BYTES`.
  The reference forms the per-frame term ``[.., T, G, D]`` instead; in
  eager torch that would be 1.1 GB at the serving step and 10 GB offline;
- the posterior precision ``L = I + Σ_g N_g M_gᵀΣ_g⁻¹M_g`` is SPD with
  eigenvalues >= 1, so each estimate is ``cholesky_ex`` and
  ``cholesky_solve`` (no LU, no inverse, and no host sync inside a
  streaming step: the factorization's ``info`` is checked once at the end
  of an offline call, and at the end of a stream).

Departure from the reference: the statistics from the posteriors on (the
products for N, F and b, the streaming carry, L and its solve) are
float64, as Kaldi accumulates its i-vector statistics in double. At
Kaldi's width (G=512, K=100) L's condition number makes the estimate
move with the f32 rounding of its statistics: in fp32, the stream and
``ivector_features`` (the same statistics summed in another order) then
miss the 1e-4 contract; in float64 they agree to rounding. The card runs
float64 GEMMs on its FP64 tensor cores at the rate it runs fp32 products
without TF32.

Model: classic total variability (Dehak et al.), ``x_t ~ N(μ_g + M_g w,
Σ_g)`` with prior ``w ~ N(0, I)`` and Σ_g the diagonal UBM variances.

Parameters stay float64 numpy, as in the reference; each object makes its
operands once per device and keeps them there (U alone is 41 MB in
float64 at G=512, K=100). The host M-steps and the initial draws are numpy, the
reference's own arithmetic, so with the same seed the initial values are
bit-equal. Float64 goldens: ``tpufeat_torch.reference.cpu``
(``diag_gmm_log_likes`` ... ``ivector_features``). Tensors live on the
caller's device, the card unless it names the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch import features
from tpufeat_torch.kernels.signal import no_tf32

__all__ = [
    "DiagUbm", "train_diag_ubm", "avg_log_like", "IvectorExtractor",
    "train_ivector_extractor", "utterance_ivector", "ivector_features",
    "StreamingIvector",
]

#: the most bytes one row chunk of a first-order product (``[rows, D·G]``)
#: or of a batch of precision matrices (``[rows, K, K]``) may take: 256 MiB
CHUNK_BYTES = 1 << 28


def _cached(obj, name: str, make, device: torch.device) -> tuple:
    """``make()``'s arrays as tensors on ``device``, made once per object
    and device (the object's fields never change: frozen dataclasses)."""
    cache = obj.__dict__.setdefault("_device_cache", {})
    key = (name, torch.device(device))
    if key not in cache:
        cache[key] = tuple(torch.as_tensor(np.ascontiguousarray(a),
                                           device=device) for a in make())
    return cache[key]


def _frames(feats, device) -> torch.Tensor:
    return features.placed(feats, device).to(torch.float32)


def _row_chunks(rows: int, row_bytes: int):
    """Slices of at most :data:`CHUNK_BYTES` worth of rows."""
    step = max(1, CHUNK_BYTES // max(row_bytes, 1))
    return [slice(r, min(r + step, rows)) for r in range(0, rows, step)]


def check_info(info: torch.Tensor, what: str) -> None:
    """Raise when a Cholesky factorization failed (one host sync)."""
    bad = int((info != 0).sum())
    if bad:
        raise torch.linalg.LinAlgError(
            f"{what}: {bad} posterior precision matrices are not positive "
            "definite")


# ---------------------------------------------------------------------------
# Diagonal-covariance UBM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiagUbm:
    """Diagonal-covariance GMM (the universal background model); float64
    numpy parameters."""

    weights: np.ndarray   # [G]
    means: np.ndarray     # [G, D]
    vars: np.ndarray      # [G, D]

    def __post_init__(self):
        w = np.asarray(self.weights, np.float64)
        mu = np.asarray(self.means, np.float64)
        var = np.asarray(self.vars, np.float64)
        if mu.ndim != 2 or var.shape != mu.shape or w.shape != mu.shape[:1]:
            raise ValueError(f"inconsistent UBM shapes {w.shape} "
                             f"{mu.shape} {var.shape}")
        if (var <= 0).any():
            raise ValueError("UBM variances must be positive")
        if not np.isclose(w.sum(), 1.0, atol=1e-6) or (w <= 0).any():
            raise ValueError("UBM weights must be positive and sum to 1")
        object.__setattr__(self, "weights", w)
        object.__setattr__(self, "means", mu)
        object.__setattr__(self, "vars", var)

    @property
    def num_gauss(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def _gemm_operands(self):
        """(gconst [G], A [G, D], B [G, D]) f32 — see the module
        docstring."""
        inv = 1.0 / self.vars
        gconst = (np.log(self.weights)
                  - 0.5 * (np.log(2.0 * np.pi * self.vars)
                           + self.means ** 2 * inv).sum(axis=1))
        return (gconst.astype(np.float32),
                (self.means * inv).astype(np.float32),
                (-0.5 * inv).astype(np.float32))

    def device_operands(self, device) -> tuple:
        """(gconst, A, B) on ``device``, made once."""
        return _cached(self, "gemm", self._gemm_operands, device)

    def log_likes(self, feats, device=None) -> torch.Tensor:
        """[..., T, D] frames -> [..., T, G] per-gaussian
        log-likelihoods (two products)."""
        x = _frames(feats, device)
        return _log_likes(x, self.device_operands(x.device))

    def posteriors(self, feats, *, min_post: float = 0.0,
                   device=None) -> torch.Tensor:
        """[..., T, D] -> [..., T, G] responsibilities; entries below
        ``min_post`` are zeroed and the rest renormalized (Kaldi's
        posterior pruning)."""
        x = _frames(feats, device)
        return _posteriors(x, self.device_operands(x.device), min_post)

    def save(self, path: str) -> None:
        np.savez(path, weights=self.weights, means=self.means,
                 vars=self.vars)

    @classmethod
    def load(cls, path: str) -> "DiagUbm":
        z = np.load(path)
        return cls(z["weights"], z["means"], z["vars"])


def _log_likes(x: torch.Tensor, ops) -> torch.Tensor:
    gconst, a, b = ops[:3]
    with no_tf32():
        return gconst + x @ a.T + (x * x) @ b.T


def _posteriors(x: torch.Tensor, ops, min_post: float) -> torch.Tensor:
    post = torch.softmax(_log_likes(x, ops), dim=-1)
    if min_post > 0.0:
        post = torch.where(post >= min_post, post, 0.0)
        post = post / post.sum(dim=-1, keepdim=True).clamp(min=1e-20)
    return post


def train_diag_ubm(feats, num_gauss: int, *, iters: int = 8,
                   final_iters: int = 12, seed: int = 0,
                   var_floor: float = 1e-3, perturb: float = 0.1,
                   device=None) -> DiagUbm:
    """Train a diagonal UBM by binary splitting + EM (the
    ``gmm-global-init-from-feats`` recipe): start from the global
    gaussian, split the heaviest components toward ``num_gauss`` with
    ``iters`` EM sweeps per stage and ``final_iters`` at full size. Each
    sweep's statistics are products on ``device`` (likelihoods,
    postsᵀ@x, postsᵀ@x²); the M-step is float64 numpy.

    ``feats``: [F, D] frames. ``var_floor`` is a fraction of the global
    variance, per dimension."""
    x = _frames(feats, device)
    if x.dim() != 2 or x.shape[0] < 2:
        raise ValueError(f"need [F>=2, D] training frames, got "
                         f"{tuple(x.shape)}")
    if num_gauss < 1:
        raise ValueError("num_gauss must be >= 1")
    rng = np.random.default_rng(seed)
    x64 = x.double()
    gmean = x64.mean(dim=0).cpu().numpy()
    gvar = x64.var(dim=0, correction=0).cpu().numpy()
    del x64
    if (gvar <= 0).any():
        raise ValueError("training frames are constant along a dimension")
    floor = np.maximum(var_floor * gvar, 1e-20)

    w = np.ones(1, np.float64)
    mu = gmean[None, :].copy()
    var = gvar[None, :].copy()
    x2 = x * x

    def em(n_iters):
        nonlocal w, mu, var
        for _ in range(n_iters):
            ops = [torch.as_tensor(a, device=x.device) for a in
                   DiagUbm(w / w.sum(), mu, var)._gemm_operands()]
            post = torch.softmax(_log_likes(x, ops), dim=-1)
            with no_tf32():
                stats = (post.sum(dim=0), post.T @ x, post.T @ x2)
            nk, xk, x2k = (s.double().cpu().numpy() for s in stats)
            nk = np.maximum(nk, 1e-10)
            w = nk / nk.sum()
            mu = xk / nk[:, None]
            var = np.maximum(x2k / nk[:, None] - mu * mu, floor[None, :])

    em(iters)
    while w.shape[0] < num_gauss:
        n_split = min(w.shape[0], num_gauss - w.shape[0])
        order = np.argsort(-w)[:n_split]
        d = perturb * np.sqrt(var[order]) * rng.standard_normal(
            (n_split, mu.shape[1]))
        mu = np.concatenate([mu, mu[order] + d], axis=0)
        mu[order] -= d
        var = np.concatenate([var, var[order]], axis=0)
        w = np.concatenate([w, w[order] * 0.5], axis=0)
        w[order] *= 0.5
        em(iters)
    em(final_iters)
    return DiagUbm(w / w.sum(), mu, var)


def avg_log_like(ubm: DiagUbm, feats, device=None) -> float:
    """Mean total log-likelihood per frame (EM's monotone objective)."""
    ll = ubm.log_likes(feats, device)
    return float(torch.logsumexp(ll, dim=-1).mean())


# ---------------------------------------------------------------------------
# I-vector extractor (total-variability model)
# ---------------------------------------------------------------------------

class Operands(NamedTuple):
    """An extractor's operands on one device: fp32 for the posteriors,
    float64 for the statistics."""
    gconst: torch.Tensor   # [G]      fp32
    a: torch.Tensor        # [G, D]   fp32  μ/σ²
    b: torch.Tensor        # [G, D]   fp32  -1/(2σ²)
    pdg: torch.Tensor      # [D·G, K] f64   Σ⁻¹M, d-major (F's order)
    u: torch.Tensor        # [G, K·K] f64   M_gᵀΣ_g⁻¹M_g
    q: torch.Tensor        # [G, K]   f64   μ_gᵀΣ_g⁻¹M_g
    means: torch.Tensor    # [G, D]   f64


@dataclasses.dataclass(frozen=True)
class IvectorExtractor:
    """Total-variability model over a :class:`DiagUbm`:
    ``x_t ~ N(μ_g + M_g w, Σ_g)``, ``w ~ N(0, I_K)``; ``M`` [G, D, K]
    float64."""

    ubm: DiagUbm
    M: np.ndarray         # [G, D, K]

    def __post_init__(self):
        m = np.asarray(self.M, np.float64)
        if m.ndim != 3 or m.shape[:2] != self.ubm.means.shape:
            raise ValueError(f"M shape {m.shape} inconsistent with UBM "
                             f"{self.ubm.means.shape}")
        object.__setattr__(self, "M", m)

    @property
    def ivector_dim(self) -> int:
        return self.M.shape[2]

    @functools.cached_property
    def _operands(self):
        """float64 (P [G,D,K], U [G,K,K], q [G,K])."""
        inv = 1.0 / self.ubm.vars                       # [G, D]
        P = inv[:, :, None] * self.M                    # Σ⁻¹M
        U = np.einsum("gdk,gdl->gkl", self.M, P)
        q = np.einsum("gd,gdk->gk", self.ubm.means, P)
        return P, U, q

    def device_operands(self, device) -> Operands:
        """Every operand of the estimation paths on ``device``, made once
        per device (the counterpart of the reference's
        ``_online_operands``)."""
        def make():
            G, D, K = self.M.shape
            P, U, q = self._operands
            return (*self.ubm._gemm_operands(),
                    P.transpose(1, 0, 2).reshape(D * G, K),
                    U.reshape(G, K * K), q, self.ubm.means)
        return Operands(*_cached(self, "estimate", make, device))

    def stats(self, feats, mask=None, *, posterior_scale: float = 1.0,
              min_post: float = 0.0, device=None):
        """Zeroth/centered-first-order Baum-Welch stats: [..., T, D]
        frames (+ optional [..., T] validity mask) -> ``(N [..., G],
        F [..., G, D])`` float64, with ``F_g = Σ_t γ_tg (x_t − μ_g)``."""
        x = _frames(feats, device)
        ops = self.device_operands(x.device)
        post = _posteriors(x, ops, min_post)
        if mask is not None:
            post = post * features.on_device(mask, x.device).to(
                post.dtype)[..., None]
        post = (post * posterior_scale).double()
        n = post.sum(dim=-2)
        f = post.transpose(-1, -2) @ x.double() - n[..., None] * ops.means
        return n, f

    def estimate(self, n, f, device=None) -> torch.Tensor:
        """Posterior-mean i-vector from :meth:`stats` output: [..., G] +
        [..., G, D] -> [..., K] fp32 (one batched K×K Cholesky solve)."""
        n = features.placed(n, device).double()
        f = features.on_device(f, n.device).double()
        ops = self.device_operands(n.device)
        b = f.transpose(-1, -2).reshape(*f.shape[:-2], -1) @ ops.pdg
        w, info = _damped_solve(n, b, ops, 0.0)
        check_info(info, "IvectorExtractor.estimate")
        return w.float()

    def save(self, path: str) -> None:
        np.savez(path, weights=self.ubm.weights, means=self.ubm.means,
                 vars=self.ubm.vars, M=self.M)

    @classmethod
    def load(cls, path: str) -> "IvectorExtractor":
        z = np.load(path)
        return cls(DiagUbm(z["weights"], z["means"], z["vars"]), z["M"])


def _damped_solve(N: torch.Tensor, b: torch.Tensor, ops: Operands,
                  max_count: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(N [..., G], b [..., K]) float64 -> (i-vectors [..., K] float64,
    Cholesky info [...]), with optional max_count damping of the stats;
    the [K, K] precisions are made and factored in row chunks of at most
    :data:`CHUNK_BYTES`."""
    lead = N.shape[:-1]
    G, K = ops.q.shape
    N = N.reshape(-1, G)
    b = b.reshape(-1, K)
    if max_count > 0.0:
        cnt = N.sum(dim=-1, keepdim=True)
        factor = (max_count / cnt.clamp(min=1e-20)).clamp(max=1.0)
        N = N * factor
        b = b * factor
    eye = torch.eye(K, dtype=torch.float64, device=N.device)
    ws, infos = [], []
    for sl in _row_chunks(N.shape[0], 2 * K * K * 8):
        L = eye + (N[sl] @ ops.u).reshape(-1, K, K)
        chol, info = torch.linalg.cholesky_ex(L)
        ws.append(torch.cholesky_solve(b[sl, :, None], chol)[..., 0])
        infos.append(info)
    return (torch.cat(ws).reshape(*lead, K),
            torch.cat(infos).reshape(lead))


def _first_order(x: torch.Tensor, post: torch.Tensor, ops: Operands,
                 weights: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroth-order counts and the projected linear term of groups of
    frames: ``x`` [R, n, D] and ``post`` [R, n, G] (scaled, masked) ->
    (N [R, S, G], b [R, S, K]) float64 with ``b = F·P − N·q`` and
    ``F [D, G] = Σ_t w_st x_t γ_tᵀ``, for S sets of frame weights
    ``weights`` [R, S, n] (0/1 prefix masks), or S = 1 and every frame
    when None. Per row chunk: one batched product for F, one GEMM for its
    projection, both float64."""
    R, n, D = x.shape
    G, K = ops.q.shape
    S = 1 if weights is None else weights.shape[1]
    Ns, bs = [], []
    for sl in _row_chunks(R, S * D * G * 8):
        xt = x[sl].transpose(1, 2).double()                 # [r, D, n]
        p = post[sl].double()
        r = xt.shape[0]
        if weights is None:
            N = p.sum(dim=1, keepdim=True)
            xw = xt
        else:
            w = weights[sl].double()
            N = w @ p
            xw = (w[:, :, None, :] * xt[:, None]).reshape(r, S * D, n)
        F = xw @ p                                          # [r, S·D, G]
        b = (F.reshape(r * S, D * G) @ ops.pdg
             - N.reshape(r * S, G) @ ops.q)
        Ns.append(N)
        bs.append(b.reshape(r, S, K))
    return torch.cat(Ns), torch.cat(bs)


def utterance_ivector(extractor: IvectorExtractor, feats, mask=None, *,
                      posterior_scale: float = 1.0, min_post: float = 0.0,
                      device=None) -> torch.Tensor:
    """One i-vector per utterance: [T, D] -> [K] (or [B, T, D] + mask ->
    [B, K])."""
    n, f = extractor.stats(feats, mask, posterior_scale=posterior_scale,
                           min_post=min_post, device=device)
    return extractor.estimate(n, f)


def train_ivector_extractor(ubm: DiagUbm, feats, lengths=None, *,
                            ivector_dim: int = 64, iters: int = 5,
                            seed: int = 0, return_objective: bool = False,
                            device=None):
    """EM-train the total-variability matrix ``M`` (the
    ``ivector-extractor-acc-stats`` / ``ivector-extractor-est`` pair).

    ``feats``: padded utterance batch [B, T, D] (+ ``lengths`` [B]) or a
    list of [T_i, D] arrays (padded here). The E-step runs on ``device``
    (posterior products, a batched K×K Cholesky inverse for every
    utterance, the accumulator products); the M-step ``M_g = Y_g A_g⁻¹``
    is a batched float64 numpy solve. Variances stay the UBM's."""
    if isinstance(feats, (list, tuple)):
        lens = np.array([np.asarray(u).shape[0] for u in feats], np.int64)
        dim = np.asarray(feats[0]).shape[1]
        pad = np.zeros((len(feats), int(lens.max()), dim), np.float32)
        for i, u in enumerate(feats):
            pad[i, : lens[i]] = np.asarray(u, np.float32)
        feats, lengths = pad, lens
    x = _frames(feats, device)
    if x.dim() != 3 or x.shape[2] != ubm.dim:
        raise ValueError(f"feats {tuple(x.shape)} vs UBM dim {ubm.dim}")
    if lengths is None:
        lengths = np.full(x.shape[0], x.shape[1], np.int64)
    mask = (torch.arange(x.shape[1], device=x.device)[None, :]
            < features.on_device(lengths, x.device)[:, None]).to(
                torch.float32)

    rng = np.random.default_rng(seed)
    # columns scaled like the per-dim stddev so iteration 1's posteriors
    # are in a sane range regardless of the feature scaling
    M = (rng.standard_normal((ubm.num_gauss, ubm.dim, ivector_dim))
         * np.sqrt(ubm.vars)[:, :, None])
    objs = []
    B, K = x.shape[0], ivector_dim
    for _ in range(iters):
        ext = IvectorExtractor(ubm, M)
        ops = ext.device_operands(x.device)
        n, f = ext.stats(x, mask)                           # float64
        L = (torch.eye(K, dtype=torch.float64, device=x.device)
             + (n @ ops.u).reshape(B, K, K))
        b = f.transpose(1, 2).reshape(B, -1) @ ops.pdg
        chol, info = torch.linalg.cholesky_ex(L)
        Linv = torch.cholesky_inverse(chol)
        Ew = (Linv @ b[:, :, None])[..., 0]
        Eww = Linv + Ew[:, :, None] * Ew[:, None, :]
        Y = f.reshape(B, -1).T @ Ew                         # [G·D, K]
        A = n.T @ Eww.reshape(B, K * K)                     # [G, K·K]
        # EM auxiliary (up to const): Σ_u [E[w]ᵀb − ½ tr(L E[wwᵀ])]
        obj = (Ew * b).sum() - 0.5 * (L * Eww.transpose(1, 2)).sum()
        check_info(info, "train_ivector_extractor E-step")
        objs.append(float(obj))
        A64 = A.cpu().numpy().reshape(-1, K, K)
        jitter = 1e-6 * np.trace(A64, axis1=1, axis2=2).mean()
        A64 = A64 + jitter * np.eye(K)[None]
        Y64 = Y.cpu().numpy().reshape(ubm.num_gauss, ubm.dim, K)
        # M_g A_g = Y_g  (A symmetric) -> solve per gaussian
        M = np.linalg.solve(A64, np.transpose(Y64, (0, 2, 1))).transpose(
            0, 2, 1)
    ext = IvectorExtractor(ubm, M)
    return (ext, objs) if return_objective else ext


# ---------------------------------------------------------------------------
# Online i-vector features (Kaldi online2 OnlineIvectorFeature)
# ---------------------------------------------------------------------------

def ivector_features(extractor: IvectorExtractor, feats, lengths=None, *,
                     period: int = 10, posterior_scale: float = 0.1,
                     max_count: float = 0.0, min_post: float = 0.0,
                     device=None) -> torch.Tensor:
    """Per-frame online i-vectors, offline (the oracle for
    :class:`StreamingIvector`): frame ``t`` carries the i-vector estimated
    from the scaled stats of frames ``[0, floor(t/period)·period)`` —
    strictly causal, refreshed every ``period`` frames; frames before the
    first boundary emit the prior mean (zeros). ``max_count > 0`` damps
    the stats by ``max_count / count`` once the scaled count exceeds it.

    The period blocks' statistics are summed by an exclusive cumsum of the
    block sums, shift first: ``cumsum − v`` would leak the current block's
    rounding into the "past-only" estimate, and the frames before a
    boundary must not change (bit for bit) when later frames do.

    [T, D] -> [T, K]; [B, T, D] (+ lengths) -> [B, T, K]."""
    x = _frames(feats, device)
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    B, T, D = x.shape
    if period < 1:
        raise ValueError("period must be >= 1")
    ops = extractor.device_operands(x.device)
    post = _posteriors(x, ops, min_post) * posterior_scale
    if lengths is not None:
        post = post * (torch.arange(T, device=x.device)[None, :]
                       < features.on_device(lengths, x.device)[:, None]
                       )[..., None]
    nblk = -(-T // period)                  # boundaries at 0, p, 2p, ...
    pad = nblk * period - T
    G, K = ops.q.shape
    blkN, blkb = _first_order(
        torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(
            B * nblk, period, D),
        torch.nn.functional.pad(post, (0, 0, 0, pad)).reshape(
            B * nblk, period, G), ops)

    def exclusive(v):
        v = v.reshape(B, nblk, -1)
        return torch.cumsum(torch.cat([torch.zeros_like(v[:, :1]),
                                       v[:, :-1]], dim=1), dim=1)

    est, info = _damped_solve(exclusive(blkN), exclusive(blkb), ops,
                              max_count)
    check_info(info, "ivector_features")
    out = est.float().repeat_interleave(period, dim=1)[:, :T]
    return out[0] if squeeze else out


class StreamingIvector:
    """Online twin of :func:`ivector_features` for any chunk plan (the
    same boundary grid: each row refreshes its i-vector at absolute frame
    indices that are multiples of ``period``, from strictly-past stats).

    Carry per row: scaled zeroth-order counts N [G] and projected linear
    term b [K] (float64), the in-force estimate [K] and a per-row frame
    counter, so
    :meth:`reset_rows` restarts a recycled serving slot on its own
    boundary grid while the other rows keep their bits. A chunk of n rows
    holds at most ceil(n / period) boundaries a row (at the serving shape
    n == period, one Cholesky a row, not two); each boundary's prefix
    statistics are one masked product, and each frame picks its estimate
    by an index (the reference's one-hot products avoid a gather on the
    TPU). The Cholesky info is kept per row on the device and checked by
    :meth:`check`, never inside a step."""

    def __init__(self, extractor: IvectorExtractor, batch_size: int = 1,
                 *, period: int = 10, posterior_scale: float = 0.1,
                 max_count: float = 0.0, min_post: float = 0.0,
                 device=None):
        if period < 1:
            raise ValueError("period must be >= 1")
        self.extractor = extractor
        self.period, self.scale = int(period), float(posterior_scale)
        self.max_count, self.min_post = float(max_count), float(min_post)
        self.device = features.default_device(device)
        self._ops = extractor.device_operands(self.device)
        G, K = extractor.ubm.num_gauss, extractor.ivector_dim
        self.N = torch.zeros(batch_size, G, dtype=torch.float64,
                             device=self.device)
        self.b = torch.zeros(batch_size, K, dtype=torch.float64,
                             device=self.device)
        self.in_force = torch.zeros(batch_size, K, device=self.device)
        self.n_seen = torch.zeros(batch_size, dtype=torch.int32,
                                  device=self.device)
        self._bad = torch.zeros(batch_size, dtype=torch.bool,
                                device=self.device)

    @property
    def dim(self) -> int:
        return self.extractor.ivector_dim

    def process(self, feats) -> torch.Tensor:
        """[B, n, D] feature rows -> [B, n, K] per-frame i-vectors (1:1,
        no emission delay)."""
        rows = _frames(feats, self.device)
        B = self.N.shape[0]
        if rows.dim() != 3 or rows.shape[0] != B:
            raise ValueError(f"expected [B={B}, n, D], got "
                             f"{tuple(rows.shape)}")
        n = rows.shape[1]
        if n == 0:
            return torch.zeros(B, 0, self.dim, device=self.device)
        p, K = self.period, self.dim
        nb = -(-n // p)
        post = _posteriors(rows, self._ops, self.min_post) * self.scale
        j = torch.arange(n, device=self.device)
        jb = (torch.remainder(-self.n_seen, p)[:, None]
              + p * torch.arange(nb, device=self.device)[None])  # [B, nb]
        valid = jb < n
        # prefix masks: frame t counts for boundary s iff t < jb_s; the
        # last set is the whole chunk (the carry's update)
        weights = torch.cat([(j[None, None] < jb[:, :, None]).float(),
                             torch.ones(B, 1, n, device=self.device)], 1)
        Nw, bw = _first_order(rows, post, self._ops, weights)
        Nb = self.N[:, None] + Nw
        bb = self.b[:, None] + bw
        est, info = _damped_solve(Nb[:, :nb], bb[:, :nb], self._ops,
                                  self.max_count)
        self._bad |= ((info != 0) & valid).any(dim=-1)
        # frame t emits the in-force estimate (segment 0) or that of the
        # last boundary <= t: segment = number of valid boundaries <= t
        seg = ((jb[:, None, :] <= j[None, :, None])
               & valid[:, None, :]).sum(dim=-1)             # [B, n]
        allest = torch.cat([self.in_force[:, None], est.float()], dim=1)
        out = torch.gather(allest, 1, seg[..., None].expand(B, n, K))
        self.in_force = allest[torch.arange(B, device=self.device),
                               valid.sum(dim=-1)]
        self.N, self.b = Nb[:, nb], bb[:, nb]
        self.n_seen = self.n_seen + n
        return out

    def check(self) -> None:
        """Raise if a step of any row met a precision that is not
        positive definite (one host sync)."""
        check_info(self._bad, "StreamingIvector")

    def state(self) -> dict:
        return {"N": self.N, "b": self.b, "in_force": self.in_force,
                "n_seen": self.n_seen}

    def set_state(self, s: dict) -> None:
        dev = self.device
        self.N = features.on_device(s["N"], dev).to(torch.float64)
        self.b = features.on_device(s["b"], dev).to(torch.float64)
        self.in_force = features.on_device(s["in_force"], dev).to(
            torch.float32)
        self.n_seen = features.on_device(s["n_seen"], dev).to(torch.int32)

    def reset_rows(self, rows) -> None:
        from tpufeat_torch.streaming import zero_rows
        self.N = zero_rows(self.N, rows)
        self.b = zero_rows(self.b, rows)
        self.in_force = zero_rows(self.in_force, rows)
        self.n_seen = zero_rows(self.n_seen, rows)
        self._bad = zero_rows(self._bad, rows)

    def reset(self) -> None:
        for name in ("N", "b", "in_force", "n_seen", "_bad"):
            setattr(self, name, torch.zeros_like(getattr(self, name)))
