"""Batching, corpus statistics and frame-level transforms — the port's
counterpart of ``tpufeat/data.py``.

- Batching on the host: :func:`pad_batch`, :func:`bucket_length` (padded
  lengths rounded up to a geometric grid, so a corpus runs at a handful of
  shapes), :func:`batched` and :func:`iter_wav_dir`, which decodes with the
  port's Python WAV reader (``tpufeat_torch.io``).
- Frame-level transforms on tensors, computed where the tensor lives:
  :func:`splice_frames`, :func:`paste_feats`, :func:`subsample_frames` and
  :func:`apply_transform` (fp32 whatever the caller's TF32 setting).
- Corpus statistics in float64 numpy, as in the reference: :class:`CmvnStats`
  (Kaldi ``compute-cmvn-stats`` / ``apply-cmvn``; its files are the
  reference's) and :class:`LdaStats` (``acc-lda`` / ``est-lda``).
  Accumulation is O(F*D) additions per utterance, small beside extraction,
  and one accumulator takes features of any batch shape. CMVN statistics
  are also the speaker and global priors of ``features.online_cmvn`` and
  ``streaming.OnlineCmvn``.
"""

from __future__ import annotations

import math
import os
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from tpufeat_torch import io

__all__ = ["pad_batch", "bucket_length", "batched", "iter_wav_dir",
           "splice_frames", "apply_transform", "LdaStats", "CmvnStats",
           "paste_feats", "subsample_frames"]


def _host(a) -> np.ndarray:
    """``a`` as a float64 numpy array: a tensor is copied to the host."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, np.float64)


def pad_batch(signals: Sequence[np.ndarray],
              target_len: int | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length signals -> (padded [B, N] f32, lengths [B])."""
    lengths = np.array([len(s) for s in signals], dtype=np.int32)
    n = int(lengths.max()) if target_len is None else target_len
    out = np.zeros((len(signals), n), dtype=np.float32)
    for b, s in enumerate(signals):
        out[b, : len(s)] = s
    return out, lengths


def bucket_length(n: int, *, grid: float = 2 ** 0.5,
                  minimum: int = 16000) -> int:
    """Round ``n`` up to a geometric grid (default sqrt(2) steps from 1 s
    at 16 kHz): about 2 shapes per octave of length, at most 41 % padding
    and about 17 % expected."""
    if n <= minimum:
        return minimum
    k = math.ceil(math.log(n / minimum, grid) - 1e-12)
    return int(round(minimum * grid ** k))


def batched(signals: Iterable[np.ndarray], batch_size: int,
            *, bucket: bool = True,
            grid: float = 2 ** 0.5) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Group signals into (padded_batch, lengths) tuples. With ``bucket``,
    signals are grouped by bucketed length, so each batch has one of a
    small set of shapes (stable order within a bucket)."""
    if not bucket:
        chunk: list[np.ndarray] = []
        for s in signals:
            chunk.append(np.asarray(s))
            if len(chunk) == batch_size:
                yield pad_batch(chunk)
                chunk = []
        if chunk:
            yield pad_batch(chunk)
        return
    buckets: dict[int, list[np.ndarray]] = {}
    for s in signals:
        s = np.asarray(s)
        key = bucket_length(len(s), grid=grid)
        buckets.setdefault(key, []).append(s)
        if len(buckets[key]) == batch_size:
            yield pad_batch(buckets.pop(key), target_len=key)
    for key in sorted(buckets):
        yield pad_batch(buckets[key], target_len=key)


def iter_wav_dir(path: str, *, native: bool | None = None
                 ) -> Iterator[tuple[str, np.ndarray, int]]:
    """Yield (filename, samples, rate) for every .wav under ``path``, in
    sorted walk order, decoded by ``tpufeat_torch.io.read_wav`` (``native``
    as there: the C++ decoder when it builds)."""
    for root, _, names in sorted(os.walk(path)):
        for name in sorted(names):
            if name.lower().endswith(".wav"):
                full = os.path.join(root, name)
                samples, rate = io.read_wav(full, native=native)
                yield full, samples, rate


def splice_frames(feat: torch.Tensor, num_frames, left: int = 3,
                  right: int = 3) -> torch.Tensor:
    """Kaldi-style frame splicing: each frame stacked with its context,
    [B, F, D] -> [B, F, (left+1+right)*D], replicating each utterance's
    first and true last frame at its edges."""
    B, F, D = feat.shape
    t = torch.arange(F, device=feat.device)
    hi = torch.clamp(torch.as_tensor(num_frames, device=feat.device)
                     .to(torch.int64) - 1, min=0)[:, None]     # [B, 1]
    parts = []
    for off in range(-left, right + 1):
        idx = torch.minimum(torch.clamp(t[None, :] + off, min=0), hi)
        parts.append(torch.gather(feat, 1, idx[..., None].expand(B, F, D)))
    return torch.cat(parts, dim=-1)


def paste_feats(feats, num_frames_list=None):
    """Kaldi ``paste-feats``: feature streams side by side, [B, F, D1] +
    [B, F, D2] + ... -> [B, F, D1+D2+...]. With ``num_frames_list`` the
    streams' per-utterance frame counts must agree (an MFCC | pitch paste
    one frame apart is a silent fault), and the shared counts are
    returned as well."""
    if not feats:
        raise ValueError("paste_feats needs at least one stream")
    shapes = {tuple(f.shape[:-1]) for f in feats}
    if len(shapes) != 1:
        raise ValueError(f"streams disagree on [B, F]: {sorted(shapes)}")
    out = torch.cat([torch.as_tensor(f) for f in feats], dim=-1)
    if num_frames_list is None:
        return out
    counts = [torch.as_tensor(n).cpu() for n in num_frames_list]
    for c in counts[1:]:
        if not torch.equal(c, counts[0]):
            raise ValueError("streams disagree on per-utterance frame "
                             f"counts: {counts[0].tolist()} vs {c.tolist()}")
    return out, torch.as_tensor(num_frames_list[0])


def subsample_frames(feat: torch.Tensor, num_frames, factor: int,
                     offset: int = 0):
    """Kaldi ``subsample-feats --n``: every ``factor``-th frame from
    ``offset``, [B, F, D] -> ([B, ceil((F - offset) / factor), D], new
    frame counts); padding rows stay padding."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    if not 0 <= offset < factor:
        raise ValueError(f"offset {offset} outside [0, {factor})")
    out = feat[..., offset::factor, :]
    nf = torch.as_tensor(num_frames)
    new_nf = torch.clamp(torch.div(nf - offset + factor - 1, factor,
                                   rounding_mode="floor"), min=0)
    return out, new_nf


def apply_transform(feat, mat) -> torch.Tensor:
    """A feature transform (Kaldi ``transform-feats``): [..., F, D_in] @
    A^T, ``mat`` [D_out, D_in] (linear) or [D_out, D_in + 1] (affine, the
    bias last, Kaldi's append-a-1 convention). fp32, TF32 off; numpy
    features are computed on the CPU. The usual matrix is an LDA/MLLT over
    spliced frames (:func:`splice_frames` -> :class:`LdaStats`)."""
    from tpufeat_torch import features
    feat = torch.as_tensor(feat, dtype=torch.float32)
    mat = torch.as_tensor(mat, dtype=torch.float32, device=feat.device)
    d_in = feat.shape[-1]
    if mat.shape[1] == d_in + 1:
        lin, bias = mat[:, :d_in], mat[:, d_in]
    elif mat.shape[1] == d_in:
        lin, bias = mat, None
    else:
        raise ValueError(
            f"transform is {tuple(mat.shape)} but features have "
            f"{d_in} dims (want [D_out, {d_in}] or [D_out, {d_in + 1}])")
    out = features.matmul(feat, lin.T)
    return out if bias is None else out + bias


class LdaStats:
    """LDA estimation from labeled frames (Kaldi ``acc-lda`` /
    ``est-lda``, the usual consumer of :func:`splice_frames`): per-class
    first moments and the global second moment in float64, then a
    whitening LDA transform.

    ``estimate(target_dim)`` returns an AFFINE [k, D+1] matrix (for
    :func:`apply_transform`) under which the accumulated data has zero
    global mean, identity within-class covariance (Kaldi's normalization)
    and directions ordered by between-class variance. Host numpy and scipy,
    as :class:`CmvnStats`: estimation is one pass over a corpus; the hot
    path is only the resulting product."""

    def __init__(self, dim: int):
        self.dim = dim
        self._counts: dict[int, float] = {}
        self._sums: dict[int, np.ndarray] = {}
        self.sumsq = np.zeros((dim, dim), np.float64)

    def accumulate(self, feats, labels) -> None:
        """[F, D] frames (numpy or a tensor on any device) + [F] integer
        class labels (e.g. aligned phone or state ids)."""
        f = _host(feats).reshape(-1, self.dim)
        lab = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor)
                         else labels).reshape(-1)
        if lab.shape[0] != f.shape[0]:
            raise ValueError(f"{f.shape[0]} frames vs {lab.shape[0]} labels")
        self.sumsq += f.T @ f
        for c in np.unique(lab):
            sel = f[lab == c]
            ci = int(c)
            self._counts[ci] = self._counts.get(ci, 0.0) + sel.shape[0]
            if ci not in self._sums:
                self._sums[ci] = np.zeros(self.dim, np.float64)
            self._sums[ci] += sel.sum(axis=0)

    def estimate(self, target_dim: int, *,
                 within_floor: float = 1e-6) -> np.ndarray:
        """-> affine [target_dim, dim + 1] float32 LDA transform.

        Whiten by the within-class covariance (eigh, eigenvalues floored
        at ``within_floor`` * max for spliced features' rank deficiency),
        then rotate to the between-class covariance's top eigenvectors in
        the whitened space."""
        import scipy.linalg
        if not 1 <= target_dim <= self.dim:
            raise ValueError(f"target_dim {target_dim} outside [1, {self.dim}]")
        n = sum(self._counts.values())
        if n < 2 or len(self._counts) < 2:
            raise ValueError("need >= 2 classes and >= 2 frames")
        mean = sum(self._sums.values()) / n
        total = self.sumsq / n - np.outer(mean, mean)
        between = np.zeros_like(total)
        for c, cnt in self._counts.items():
            d = self._sums[c] / cnt - mean
            between += (cnt / n) * np.outer(d, d)
        within = total - between
        w, v = scipy.linalg.eigh(within)
        w = np.maximum(w, within_floor * max(w.max(), 1e-30))
        whiten = (v / np.sqrt(w)) @ v.T                     # W^{-1/2}
        _, bv = scipy.linalg.eigh(whiten @ between @ whiten)
        rot = bv[:, ::-1][:, :target_dim].T                 # top-k rows
        lin = rot @ whiten
        return np.concatenate(
            [lin, -(lin @ mean)[:, None]], axis=1).astype(np.float32)


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

    def save(self, path: str, key: str = "global") -> None:
        """``.ark`` -> Kaldi binary double-matrix statistics under ``key``
        (compute-cmvn-stats interchange); anything else -> npz. The files
        are the reference package's."""
        if path.endswith(".ark"):
            from tpufeat_torch import feats_io
            feats_io.write_kaldi_ark(path, {key: self.to_kaldi()},
                                     dtype="f64")
        else:
            np.savez(path, count=self.count, sum=self.sum,
                     sumsq=self.sumsq)

    @classmethod
    def load(cls, path: str, key: str | None = None) -> "CmvnStats":
        if path.endswith(".ark"):
            from tpufeat_torch import feats_io
            utts = feats_io.read_kaldi_ark(path)
            if key is None:
                if len(utts) != 1:
                    raise ValueError(
                        f"{path}: {len(utts)} stats entries "
                        f"({sorted(utts)[:4]}...) — pass key=")
                key = next(iter(utts))
            return cls.from_kaldi(utts[key])
        with np.load(path) as z:
            st = cls(int(z["sum"].shape[0]))
            st.count = float(z["count"])
            st.sum = z["sum"].astype(np.float64)
            st.sumsq = z["sumsq"].astype(np.float64)
        return st

    def merge(self, other: "CmvnStats") -> "CmvnStats":
        """Combine shards (e.g. per-worker corpus partitions)."""
        self.count += other.count
        self.sum += other.sum
        self.sumsq += other.sumsq
        return self
