"""Corpus-level CMVN statistics — the port's own copy of ``CmvnStats`` of
``tpufeat/data.py``.

Host-side numpy, as in the reference: accumulation is O(F*D) additions per
utterance, small beside extraction, and one accumulator takes features of
any batch shape. Its statistics are the speaker and global priors of
``features.online_cmvn`` and ``streaming.OnlineCmvn``. The rest of the
reference's ``data.py`` is ROADMAP.md queue 1, item 8.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """``a`` as a float64 numpy array: a tensor is copied to the host."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, np.float64)


class CmvnStats:
    """Kaldi ``compute-cmvn-stats`` / ``apply-cmvn`` statistics: exact
    float64 moments over any number of utterances, then normalization
    against the corpus mean and variance."""

    def __init__(self, dim: int):
        self.count = 0.0
        self.sum = np.zeros(dim, np.float64)
        self.sumsq = np.zeros(dim, np.float64)

    def accumulate(self, feats) -> None:
        """Add one utterance's [F, D] (or a batch's [B, F, D] of VALID
        frames: trim padding first), numpy or a tensor on any device."""
        f = _host(feats).reshape(-1, self.sum.shape[0])
        self.count += f.shape[0]
        self.sum += f.sum(axis=0)
        self.sumsq += (f * f).sum(axis=0)

    @property
    def mean(self) -> np.ndarray:
        return self.sum / max(self.count, 1.0)

    @property
    def var(self) -> np.ndarray:
        m = self.mean
        return np.maximum(self.sumsq / max(self.count, 1.0) - m * m, 0.0)

    def apply(self, feats, norm_vars: bool = False) -> np.ndarray:
        out = _host(feats).astype(np.float32) - self.mean.astype(np.float32)
        if norm_vars:
            out = out / np.sqrt(self.var + 1e-10).astype(np.float32)
        return out

    def to_kaldi(self) -> np.ndarray:
        """The [2, D+1] float64 matrix compute-cmvn-stats writes: row 0 =
        [per-dim sum | frame count], row 1 = [per-dim sum of squares | 0]."""
        top = np.concatenate([self.sum, [self.count]])
        bot = np.concatenate([self.sumsq, [0.0]])
        return np.stack([top, bot])

    @classmethod
    def from_kaldi(cls, mat) -> "CmvnStats":
        mat = np.asarray(mat, np.float64)
        if mat.ndim != 2 or mat.shape[0] != 2 or mat.shape[1] < 2:
            raise ValueError(f"CMVN stats must be [2, D+1], got {mat.shape}")
        st = cls(mat.shape[1] - 1)
        st.count = float(mat[0, -1])
        st.sum = mat[0, :-1].copy()
        st.sumsq = mat[1, :-1].copy()
        return st
