"""PLDA speaker-verification backend over i-vectors (the Kaldi
``ivector-compute-plda`` / ``ivector-plda-scoring`` pair) — counterpart of
``tpufeat/plda.py``, completing the speaker-ID loop that
:mod:`tpufeat_torch.ivector` opens: UBM -> total variability -> i-vector
-> mean/length normalization -> PLDA log-likelihood-ratio scoring.

Model: two-covariance PLDA (Ioffe 2006; the variant Kaldi implements):

    x = m + y + e,   y ~ N(0, Phi_b)  (speaker),   e ~ N(0, Phi_w)  (channel)

Training runs EM in float64 numpy (the solves are K x K), then
simultaneously diagonalizes: a transform ``A`` with ``A Phi_w A^T = I``
and ``A Phi_b A^T = diag(psi)``. In that basis the verification
log-likelihood ratio is elementwise-diagonal, and the whole [E, T] trial
matrix is two GEMMs plus rank-1 broadcasts on the device, in fp32 with
TF32 off (:func:`_llr`).

Float64 goldens for scoring and the transform:
``tpufeat_torch.reference.cpu`` (``plda_log_likelihood_ratio``);
``to_kaldi_bytes``/``from_kaldi_bytes`` speak Kaldi's binary ``<Plda>``
object format, byte for byte the reference's.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from tpufeat_torch import features
from tpufeat_torch.kernels.signal import no_tf32
from tpufeat_torch.reference.cpu import plda_transform_ivector

__all__ = ["Plda", "train_plda", "length_normalize", "ivector_mean"]


def length_normalize(x, *, scale_to_sqrt_dim: bool = True):
    """Kaldi ``ivector-normalize-length``: scale each vector to norm
    ``sqrt(dim)`` (or unit norm with ``scale_to_sqrt_dim=False``).
    [..., K] -> [..., K]; zero vectors pass through unchanged."""
    x = np.asarray(x, np.float64)
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    target = np.sqrt(x.shape[-1]) if scale_to_sqrt_dim else 1.0
    return x * (target / np.where(norm > 0, norm, 1.0))


def ivector_mean(vectors, spk_ids):
    """Per-speaker mean of utterance i-vectors (``ivector-mean``):
    [N, K] + N labels -> (means [S, K], counts [S], speakers list) with
    speakers in first-appearance order."""
    x = np.asarray(vectors, np.float64)
    if x.ndim != 2:
        raise ValueError(f"expected [N, K] i-vectors, got {x.shape}")
    if len(spk_ids) != x.shape[0]:
        raise ValueError(f"{len(spk_ids)} labels for {x.shape[0]} vectors")
    order: dict = {}
    for s in spk_ids:
        order.setdefault(s, len(order))
    idx = np.array([order[s] for s in spk_ids])
    S = len(order)
    counts = np.bincount(idx, minlength=S).astype(np.float64)
    sums = np.zeros((S, x.shape[1]))
    np.add.at(sums, idx, x)
    return sums / counts[:, None], counts, list(order)


@dataclasses.dataclass(frozen=True)
class Plda:
    """Trained PLDA model in Kaldi's parametrization: ``mean`` [K] (the
    global i-vector mean), ``transform`` [K, K] (``A``: within-class
    covariance -> I, between-class -> diag), ``psi`` [K] (the diagonal
    between-class variances, sorted descending). Stored float64 like
    every precomputed matrix in this package; scoring takes fp32
    operands on the device."""

    mean: np.ndarray       # [K]
    transform: np.ndarray  # [K, K]
    psi: np.ndarray        # [K]

    def __post_init__(self):
        m = np.asarray(self.mean, np.float64)
        a = np.asarray(self.transform, np.float64)
        p = np.asarray(self.psi, np.float64)
        if (m.ndim != 1 or a.shape != (m.size, m.size)
                or p.shape != m.shape):
            raise ValueError(f"inconsistent Plda shapes {m.shape} "
                             f"{a.shape} {p.shape}")
        if (p < 0).any():
            raise ValueError("psi must be non-negative")
        object.__setattr__(self, "mean", m)
        object.__setattr__(self, "transform", a)
        object.__setattr__(self, "psi", p)

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def transform_ivector(self, x, n_examples=1, *,
                          normalize_length: bool = True):
        """Project raw i-vectors into the diagonalized PLDA space:
        ``y = A (x - mean)``, then (Kaldi ``Plda::TransformIvector`` /
        ``GetNormalizationFactor``) scale each row so its squared norm
        under its OWN covariance matches expectation: ``y *= sqrt(K /
        sum(y^2 / (psi + 1/n)))`` — an average of ``n_examples``
        utterance i-vectors has within-class variance 1/n, so
        enrollment means normalize with their count (Kaldi's default
        ``--simple-length-norm=false`` behaviour). ``n_examples`` is a
        scalar or per-row [...] array. [..., K] -> [..., K] float64
        (host-side prep; scoring is the device's hot path)."""
        x = np.asarray(x, np.float64)
        y = (x - self.mean) @ self.transform.T
        if normalize_length:
            n = np.asarray(n_examples, np.float64)
            if (n < 1).any():
                raise ValueError("n_examples must be >= 1")
            if n.ndim:                      # per-row counts [E]
                n = n[:, None]
            inv_tot = 1.0 / (self.psi + 1.0 / n)
            sq = (y * y * inv_tot).sum(axis=-1, keepdims=True)
            y = y * np.sqrt(self.dim / np.where(sq > 0, sq, 1.0))
        return y

    def log_likelihood_ratio(self, enroll, test, n_enroll=1,
                             device=None) -> torch.Tensor:
        """Batched verification scores from TRANSFORMED vectors
        (:meth:`transform_ivector` output): ``enroll`` [E, K] per-speaker
        transformed means, ``test`` [T, K], ``n_enroll`` scalar or [E]
        utterance counts behind each enrollment mean -> [E, T] LLR matrix
        on ``device`` (Kaldi ``Plda::LogLikelihoodRatio`` for every pair,
        two GEMMs)."""
        e = features.placed(enroll, device).to(torch.float32)
        t = features.on_device(test, e.device).to(torch.float32)
        if e.dim() != 2 or t.dim() != 2 or e.shape[1] != t.shape[1]:
            raise ValueError(f"want [E, K] x [T, K], got {tuple(e.shape)} "
                             f"{tuple(t.shape)}")
        n = np.broadcast_to(np.asarray(n_enroll, np.float32),
                            (e.shape[0],))
        if (n < 1).any():
            raise ValueError("n_enroll must be >= 1")
        return _llr(e, torch.tensor(n, device=e.device), t,
                    torch.as_tensor(self.psi, dtype=torch.float32,
                                    device=e.device))

    def score(self, enroll, test, n_enroll=1, *,
              normalize_length: bool = True, device=None) -> torch.Tensor:
        """End-to-end trial scoring from RAW i-vectors: transform both
        sides (:meth:`transform_ivector`) then score every [E, T] pair on
        ``device`` (default the card). ``enroll`` rows are per-speaker
        means of (length-normalized) utterance i-vectors; pass their
        counts as ``n_enroll`` (Kaldi ``ivector-plda-scoring
        --num-utts``); the enrollment side normalizes with its count
        (psi + 1/n), the test side with 1 — Kaldi's default
        ``--simple-length-norm=false``."""
        return self.log_likelihood_ratio(
            self.transform_ivector(_host(enroll), n_enroll,
                                   normalize_length=normalize_length),
            self.transform_ivector(_host(test),
                                   normalize_length=normalize_length),
            n_enroll, device=device)

    def score_host(self, enroll, test, n_enroll=1, *,
                   normalize_length: bool = True) -> np.ndarray:
        """Float64 HOST twin of :meth:`score` (the same transform and GEMM
        factorization as :func:`_llr`, numpy): for callers that score
        small [E, T] problems per decision — the streaming diarizer's
        greedy assignment and ``refine_labels``' shrinking cluster set —
        where a device round trip per call would dominate. Parity with
        the golden loop is tested."""
        psi = np.asarray(self.psi, np.float64)
        n = np.broadcast_to(np.asarray(n_enroll, np.float64),
                            (np.shape(enroll)[0],))
        if (n < 1).any():
            raise ValueError("n_enroll must be >= 1")
        u = plda_transform_ivector(self.mean, self.transform, psi,
                                   enroll, n,
                                   normalize_length=normalize_length)
        v = plda_transform_ivector(self.mean, self.transform, psi,
                                   test,
                                   normalize_length=normalize_length)
        npsi = n[:, None] * psi[None, :]                    # [E, K]
        m = npsi / (npsi + 1.0) * u                         # [E, K]
        vg = 1.0 + psi[None, :] / (npsi + 1.0)              # [E, K]
        c_e = -0.5 * (np.log(2.0 * np.pi * vg) + m * m / vg).sum(-1)
        given = (c_e[:, None] + (m / vg) @ v.T
                 - 0.5 * (1.0 / vg) @ (v * v).T)            # [E, T]
        vn = 1.0 + psi
        without = -0.5 * (np.log(2.0 * np.pi * vn)[None, :]
                          + (v * v) / vn[None, :]).sum(-1)  # [T]
        return given - without[None, :]

    def smooth_within_class_covariance(self, factor: float) -> "Plda":
        """Kaldi ``Plda::SmoothWithinClassCovariance``: add ``factor``
        times the between-class variance to the within-class variance
        (regularizes small-data models), re-normalizing so within stays
        I: per dim, within 1 -> 1 + factor*psi, then rescale that row of
        the transform by 1/sqrt(1 + factor*psi) and psi accordingly."""
        if not 0.0 <= factor:
            raise ValueError("smoothing factor must be >= 0")
        s = 1.0 + factor * self.psi
        return Plda(self.mean, self.transform / np.sqrt(s)[:, None],
                    self.psi / s)

    def adapt(self, vectors, *, mean_diff_scale: float = 1.0,
              within_covar_scale: float = 0.3,
              between_covar_scale: float = 0.7) -> "Plda":
        """Unsupervised domain adaptation (Kaldi ``ivector-adapt-plda``,
        ``PldaUnsupervisedAdaptor``): given UNLABELED in-domain
        i-vectors, move the model mean to theirs (adding
        ``mean_diff_scale`` times the shift as extra variance) and,
        along every direction where the data shows MORE total variance
        than the model predicts, split the excess between the within-
        and between-class covariances by the two scale factors. Returns
        a new re-diagonalized :class:`Plda`."""
        for name, v in (("mean_diff_scale", mean_diff_scale),
                        ("within_covar_scale", within_covar_scale),
                        ("between_covar_scale", between_covar_scale)):
            if v < 0:
                raise ValueError(f"{name} must be >= 0")
        x = np.asarray(vectors, np.float64)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}] i-vectors, got "
                             f"{x.shape}")
        if x.shape[0] < 2:
            raise ValueError("need >= 2 adaptation i-vectors")
        mean = x.mean(axis=0)
        xc = x - mean
        var = xc.T @ xc / x.shape[0]
        diff = mean - self.mean
        var += mean_diff_scale * np.outer(diff, diff)
        # project into the model's diagonalized space (within = I,
        # between = diag(psi)); excess variance along eigdirections of
        # the projected data covariance feeds the two covariances
        var_p = self.transform @ var @ self.transform.T
        evals, evecs = np.linalg.eigh(0.5 * (var_p + var_p.T))
        W1 = np.eye(self.dim)
        B1 = np.diag(self.psi).astype(np.float64)
        for s, w in zip(evals, evecs.T):
            excess = s - (1.0 + self.psi @ (w * w))
            if excess > 0:
                W1 += within_covar_scale * excess * np.outer(w, w)
                B1 += between_covar_scale * excess * np.outer(w, w)
        A2, psi2 = _diagonalize(W1, B1)
        return Plda(mean, A2 @ self.transform, psi2)

    # --- persistence -----------------------------------------------------

    def save(self, path: str) -> None:
        np.savez(path, mean=self.mean, transform=self.transform,
                 psi=self.psi)

    @classmethod
    def load(cls, path: str) -> "Plda":
        import os
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"      # np.savez appends the suffix on save()
        z = np.load(path)
        return cls(z["mean"], z["transform"], z["psi"])

    def to_kaldi_bytes(self) -> bytes:
        """Kaldi binary ``<Plda>`` object (what ``ivector-compute-plda``
        writes): \\0B marker, ``<Plda>`` token, mean (DV), transform
        (DM), psi (DV), ``</Plda>``."""
        out = bytearray(b"\0B<Plda> ")
        for vec in (self.mean,):
            out += _kaldi_dvector(vec)
        out += _kaldi_dmatrix(self.transform)
        out += _kaldi_dvector(self.psi)
        out += b"</Plda> "
        return bytes(out)

    @classmethod
    def from_kaldi_bytes(cls, data: bytes) -> "Plda":
        r = _KaldiReader(data)
        r.expect(b"\0B")
        r.expect_token("<Plda>")
        mean = r.dvector()
        transform = r.dmatrix()
        psi = r.dvector()
        r.expect_token("</Plda>")
        return cls(mean, transform, psi)

    def save_kaldi(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_kaldi_bytes())

    @classmethod
    def load_kaldi(cls, path: str) -> "Plda":
        with open(path, "rb") as f:
            return cls.from_kaldi_bytes(f.read())

    @classmethod
    def load_auto(cls, path: str) -> "Plda":
        """Load either container, dispatching on the file's magic bytes
        (npz is a zip: ``PK``; Kaldi binary objects start ``\\0B``) —
        not on exceptions, so a corrupted npz surfaces as the real
        np.load failure instead of a confusing 'bad <Plda> object'
        error."""
        import os
        p = path
        if not os.path.exists(p) and os.path.exists(p + ".npz"):
            p += ".npz"
        with open(p, "rb") as f:
            magic = f.read(2)
        if magic == b"\0B":
            return cls.load_kaldi(p)
        return cls.load(p)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _llr(u: torch.Tensor, n: torch.Tensor, v: torch.Tensor,
         psi: torch.Tensor) -> torch.Tensor:
    """Kaldi LogLikelihoodRatio over all pairs, GEMM-factored.

    Per pair (e, t) with n = n[e] enrollment utterances behind the
    transformed mean u[e]:

        m   = n*psi/(n*psi + 1) * u[e]        (posterior speaker mean)
        vg  = 1 + psi/(n*psi + 1)             (given-speaker variance)
        LLR = logN(v[t]; m, vg) - logN(v[t]; 0, 1 + psi)

    The (v - m)^2/vg quadratic expands into v^2 @ (-1/2vg)^T (GEMM),
    v @ (m/vg)^T (GEMM), and enroll-only / test-only rank-1 terms."""
    npsi = n[:, None] * psi[None, :]                   # [E, K]
    m = npsi / (npsi + 1.0) * u                        # [E, K]
    vg = 1.0 + psi[None, :] / (npsi + 1.0)             # [E, K]
    c_e = -0.5 * (torch.log(2.0 * np.pi * vg) + m * m / vg).sum(-1)  # [E]
    with no_tf32():
        given = c_e[:, None] + (m / vg) @ v.T + (-0.5 / vg) @ (v * v).T
    vn = 1.0 + psi                                     # [K]
    without = -0.5 * (torch.log(2.0 * np.pi * vn)[None, :]
                      + (v * v) / vn[None, :]).sum(-1)  # [T]
    return given - without[None, :]


# ---------------------------------------------------------------------------
# Training (two-covariance EM, host float64)
# ---------------------------------------------------------------------------

def train_plda(vectors, spk_ids, *, iters: int = 10,
               within_floor: float = 1e-6,
               return_objective: bool = False):
    """EM-train a :class:`Plda` from labeled i-vectors.

    ``vectors``: [N, K] raw utterance i-vectors (apply
    :func:`length_normalize` first for the standard recipe);
    ``spk_ids``: N hashable speaker labels. Per iteration the E-step
    computes each speaker's posterior N(y_hat_s, C_s) over its latent
    (batched K x K solves, grouped by utterance count so each distinct
    count factors once), the M-step re-estimates (Phi_b, Phi_w) in
    closed form. Objective (optional return) is the TRUE marginal
    log-likelihood of the data, evaluated per iteration via the same
    simultaneous diagonalization the final model uses — monotone
    non-decreasing under EM (tested).

    Returns the model (and the per-iteration objective list with
    ``return_objective=True``)."""
    x = np.asarray(vectors, np.float64)
    if x.ndim != 2:
        raise ValueError(f"expected [N, K] i-vectors, got {x.shape}")
    if len(spk_ids) != x.shape[0]:
        raise ValueError(f"{len(spk_ids)} labels for {x.shape[0]} vectors")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    N, K = x.shape
    order: dict = {}
    for s in spk_ids:
        order.setdefault(s, len(order))
    S = len(order)
    if S < 2:
        raise ValueError("need at least 2 speakers to train PLDA")
    idx = np.array([order[s] for s in spk_ids])
    counts = np.bincount(idx, minlength=S).astype(np.float64)   # [S]

    mean = x.mean(axis=0)
    xc = x - mean
    sums = np.zeros((S, K))
    np.add.at(sums, idx, xc)
    spk_mean = sums / counts[:, None]                            # [S, K]
    # total second moment and init covariances (within from residuals,
    # between from count-weighted speaker means)
    T2 = xc.T @ xc                                               # [K, K]
    Bs = (spk_mean * counts[:, None]).T @ spk_mean
    Phi_w = (T2 - Bs) / max(N - S, 1)
    Phi_b = Bs / S
    gvar = np.trace(T2) / (N * K)
    for M in (Phi_w, Phi_b):
        M += within_floor * gvar * np.eye(K)

    objs = []
    for _ in range(iters):
        if return_objective:
            objs.append(_marginal_loglike(Phi_w, Phi_b, xc, idx, counts))
        # E-step: posterior over y_s given n_s obs with mean x_bar_s:
        #   C_s = (Phi_b^-1 + n_s Phi_w^-1)^-1
        #   y_s = C_s Phi_w^-1 (n_s x_bar_s)
        Wi = np.linalg.inv(Phi_w)
        Bi = np.linalg.inv(Phi_b)
        uniq = np.unique(counts)
        C = np.empty((S, K, K))
        for n_s in uniq:                       # few distinct counts
            sel = counts == n_s
            C[sel] = np.linalg.inv(Bi + n_s * Wi)[None]
        y = np.einsum("skl,sl->sk", C, (counts[:, None] * spk_mean) @ Wi.T)
        # M-step
        Phi_b = (C.sum(axis=0) + y.T @ y) / S
        # within: sum_s sum_i (x_i - y_s)(x_i - y_s)^T + n_s C_s
        xy = (sums * 1.0).T @ y                # sum_s (sum_i x_i) y_s^T
        yy = (y * counts[:, None]).T @ y
        nC = np.einsum("s,skl->kl", counts, C)
        Phi_w = (T2 - xy - xy.T + yy + nC) / N
        # symmetrize (f64 round-off) and floor
        Phi_w = 0.5 * (Phi_w + Phi_w.T) + within_floor * gvar * np.eye(K)
        Phi_b = 0.5 * (Phi_b + Phi_b.T)
    if return_objective:
        objs.append(_marginal_loglike(Phi_w, Phi_b, xc, idx, counts))

    A, psi = _diagonalize(Phi_w, Phi_b)
    model = Plda(mean, A, psi)
    return (model, objs) if return_objective else model


def _diagonalize(Phi_w, Phi_b):
    """Simultaneous diagonalization: A with A Phi_w A^T = I and
    A Phi_b A^T = diag(psi), psi sorted descending (the PLDA basis)."""
    L = np.linalg.cholesky(Phi_w)
    W = np.linalg.inv(L)                       # whitens within
    Bt = W @ Phi_b @ W.T
    evals, evecs = np.linalg.eigh(0.5 * (Bt + Bt.T))
    order = np.argsort(-evals)
    psi = np.maximum(evals[order], 0.0)
    A = evecs[:, order].T @ W
    return A, psi


def _marginal_loglike(Phi_w, Phi_b, xc, idx, counts):
    """True marginal log-likelihood of centered data under the
    two-covariance model, via simultaneous diagonalization: per dim k
    a speaker's n obs are jointly N(0, psi_k 1 1^T + I), so
    log|Sigma| = log(1 + n psi_k) and the quadratic splits into
    sum x^2 - psi/(1 + n psi) * (sum x)^2."""
    A, psi = _diagonalize(Phi_w, Phi_b)
    z = xc @ A.T                                            # [N, K]
    S = counts.shape[0]
    zsum = np.zeros((S, z.shape[1]))
    np.add.at(zsum, idx, z)
    npsi = counts[:, None] * psi[None, :]                   # [S, K]
    quad = (z * z).sum(axis=0) - (psi[None, :] / (1.0 + npsi)
                                  * zsum * zsum).sum(axis=0)
    logdet = np.log1p(npsi).sum()
    n_total = z.shape[0]
    # |A| term: data was transformed by A (vol change cancels in EM
    # comparisons only if included — A changes per iteration)
    sign, logdet_a = np.linalg.slogdet(A)
    return float(-0.5 * (quad.sum() + logdet
                         + n_total * z.shape[1] * np.log(2.0 * np.pi))
                 + n_total * logdet_a)


# ---------------------------------------------------------------------------
# Kaldi binary object plumbing (<Plda> uses double vectors/matrices)
# ---------------------------------------------------------------------------

def _kaldi_dvector(v: np.ndarray) -> bytes:
    v = np.ascontiguousarray(v, np.float64)
    return (b"DV \x04" + struct.pack("<i", v.shape[0])
            + v.astype("<f8").tobytes())


def _kaldi_dmatrix(m: np.ndarray) -> bytes:
    m = np.ascontiguousarray(m, np.float64)
    return (b"DM \x04" + struct.pack("<i", m.shape[0])
            + b"\x04" + struct.pack("<i", m.shape[1])
            + m.astype("<f8").tobytes())


class _KaldiReader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated Kaldi <Plda> object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def expect(self, want: bytes) -> None:
        got = self.take(len(want))
        if got != want:
            raise ValueError(f"bad Kaldi <Plda> object: expected "
                             f"{want!r}, got {got!r}")

    def expect_token(self, tok: str) -> None:
        self.expect(tok.encode() + b" ")

    def _dim(self) -> int:
        self.expect(b"\x04")
        return struct.unpack("<i", self.take(4))[0]

    def dvector(self) -> np.ndarray:
        self.expect(b"DV ")
        n = self._dim()
        if not 0 <= n <= (1 << 24):
            raise ValueError(f"implausible vector dim {n}")
        return np.frombuffer(self.take(8 * n), "<f8").astype(np.float64)

    def dmatrix(self) -> np.ndarray:
        self.expect(b"DM ")
        r, c = self._dim(), self._dim()
        if not (0 <= r <= (1 << 16) and 0 <= c <= (1 << 16)):
            raise ValueError(f"implausible matrix dims {r}x{c}")
        return (np.frombuffer(self.take(8 * r * c), "<f8")
                .reshape(r, c).astype(np.float64))


# ---------------------------------------------------------------------------
# CLI (python -m tpufeat_torch.plda): the ivector-plda-scoring tool
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    """Score a Kaldi-style trials list: enrollment + test i-vector
    archives in, ``<spk> <utt> <score>`` lines out. The whole unique
    [speakers x utterances] LLR matrix is one scoring call on the
    device; trials pick their entries from it."""
    import argparse
    import sys

    from tpufeat_torch import cli, feats_io

    p = argparse.ArgumentParser(
        prog="tpufeat_torch.plda",
        description="PLDA trial scoring (ivector-plda-scoring analogue)")
    p.add_argument("trials", help="'<spk> <utt>' per line")
    p.add_argument("scores", help="output: '<spk> <utt> <score>' per "
                                  "line ('-' for stdout)")
    p.add_argument("--plda", required=True,
                   help="Plda.save() npz or Kaldi binary <Plda> object")
    p.add_argument("--enroll", required=True, metavar="ARK",
                   help="Kaldi FV/DV vector archive of per-speaker mean "
                        "i-vectors (ivector-mean output), keyed by spk")
    p.add_argument("--test", required=True, metavar="ARK",
                   help="Kaldi FV/DV vector archive of per-utterance "
                        "i-vectors, keyed by utt")
    p.add_argument("--num-utts", default=None, metavar="FILE",
                   help="'<spk> <count>' per line: utterance counts "
                        "behind each enrollment mean (default 1)")
    p.add_argument("--no-length-norm", action="store_true",
                   help="skip the transform-time length normalization")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; refuses to run without a card), "
                        "cuda:N or cpu")
    args = p.parse_args(argv)
    device = cli.device_of(args.device)

    model = Plda.load_auto(args.plda)
    enroll = feats_io.read_kaldi_vec_ark(args.enroll)
    test = feats_io.read_kaldi_vec_ark(args.test)

    counts = {}
    if args.num_utts:
        with open(args.num_utts) as f:
            for ln, line in enumerate(f, 1):
                parts = line.split()
                if not parts:
                    continue
                if len(parts) != 2 or not parts[1].isdigit():
                    raise ValueError(f"{args.num_utts}:{ln}: want "
                                     f"'<spk> <count>', got {line!r}")
                counts[parts[0]] = int(parts[1])

    pairs = []
    with open(args.trials) as f:
        for ln, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2:
                raise ValueError(f"{args.trials}:{ln}: want '<spk> "
                                 f"<utt>', got {line!r}")
            spk, utt = parts[0], parts[1]
            if spk not in enroll:
                raise ValueError(f"{args.trials}:{ln}: speaker {spk!r} "
                                 f"not in {args.enroll}")
            if utt not in test:
                raise ValueError(f"{args.trials}:{ln}: utterance "
                                 f"{utt!r} not in {args.test}")
            pairs.append((spk, utt))

    if not pairs:
        # empty trials: write an empty scores file, not a stack error
        if args.scores != "-":
            open(args.scores, "w").close()
        print("scored 0 trials", file=sys.stderr)
        return 0
    spks = sorted({s for s, _ in pairs})
    utts = sorted({u for _, u in pairs})
    e = np.stack([enroll[s] for s in spks]).astype(np.float64)
    t = np.stack([test[u] for u in utts]).astype(np.float64)
    n = np.array([counts.get(s, 1) for s in spks], np.float64)
    scores = model.score(e, t, n_enroll=n,
                         normalize_length=not args.no_length_norm,
                         device=device).cpu().numpy()
    si = {s: i for i, s in enumerate(spks)}
    ui = {u: i for i, u in enumerate(utts)}
    out = sys.stdout if args.scores == "-" else open(args.scores, "w")
    try:
        for spk, utt in pairs:
            out.write(f"{spk} {utt} {scores[si[spk], ui[utt]]:.6f}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"scored {len(pairs)} trials ({len(spks)} speakers x "
          f"{len(utts)} utterances)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
