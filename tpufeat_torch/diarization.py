"""Speaker diarization: sliding-window segment i-vectors + PLDA affinity +
agglomerative clustering (the Kaldi ``callhome_diarization`` recipe's
shape) on the port's :mod:`tpufeat_torch.ivector` and
:mod:`tpufeat_torch.plda` — counterpart of ``tpufeat/diarization.py``.

Who spoke when: features -> overlapping fixed-length windows (default
1.5 s every 0.75 s, Kaldi's grid) -> one i-vector per window -> PLDA
log-likelihood-ratio affinity between every window pair -> average-link
agglomerative clustering (scipy) cut at a threshold or a known speaker
count -> per-frame labels and (start, end, speaker) segments.

On the device: posteriors are the i-vector module's products; first-order
statistics are taken per PERIOD BLOCK (one ``[D, period] @ [period, G]``
product a block) and projected per block by one GEMM, never per frame; a
window's statistics are the sum of its ``window // period`` blocks (an
index and a short sum: the reference's cumsum-and-difference would
subtract prefixes of a 30-minute recording, and its f32 rounding then
reaches the window's counts); every window estimate is one batched
Cholesky solve; the [N, N] affinity is the PLDA module's two-GEMM
scoring. Clustering runs on the host (N = audio minutes x 80).
"""

from __future__ import annotations

import numpy as np
import torch

from tpufeat_torch import features
from tpufeat_torch.ivector import (IvectorExtractor, _damped_solve,
                                   _first_order, _frames, _posteriors,
                                   check_info)
from tpufeat_torch.plda import Plda, _host

__all__ = ["sliding_windows", "segment_ivectors", "plda_affinity",
           "cluster_affinity", "diarize", "diarize_long",
           "two_stage_cluster", "refine_labels", "write_rttm",
           "StreamingDiarizer"]

#: two_stage_cluster clusters single-stage below this many blocks: with 2
#: blocks the reference's centroid stage had too few fragments to repair
#: (frame agreement 0.746 on a ~1.8k-window recording)
MIN_BLOCKS = 4


def sliding_windows(num_frames: int, *, window: int = 150,
                    period: int = 75, min_window: int = 25) -> np.ndarray:
    """The diarization segment grid: [N, 2] (start, end) frame spans —
    ``window`` frames every ``period`` frames, the tail window clamped
    to ``num_frames`` and dropped when shorter than ``min_window``
    (unless it is the only one). ``window`` must be a multiple of
    ``period`` (the block-sum formulation; Kaldi's 1.5 s/0.75 s default
    grid satisfies it)."""
    if period < 1 or window < 1:
        raise ValueError("window and period must be >= 1")
    if window % period:
        raise ValueError(f"window ({window}) must be a multiple of "
                         f"period ({period})")
    if num_frames < 1:
        raise ValueError("num_frames must be >= 1")
    spans = []
    for start in range(0, num_frames, period):
        end = min(start + window, num_frames)
        if end - start >= min_window or not spans:
            spans.append((start, end))
        if end == num_frames:
            break
    return np.asarray(spans, np.int64)


def segment_ivectors(extractor: IvectorExtractor, feats, *,
                     window: int = 150, period: int = 75,
                     min_window: int = 25, mask=None,
                     posterior_scale: float = 1.0, min_post: float = 0.025,
                     bucket_frames: bool = False, device=None):
    """One i-vector per sliding window: [T, D] features -> ([N, K]
    i-vectors on the device, [N, 2] window spans). ``mask`` ([T],
    optional) zeroes non-speech/padding frames' contributions (VAD
    gating).

    ``bucket_frames=True`` pads T up to a sqrt(2) length grid, as the
    reference does to bound its compiles (torch compiles nothing, so here
    it only keeps the reference's semantics): windows are defined on the
    padded grid and all-padding windows are dropped; a window straddling
    the true end gets exactly the clamped-tail statistics (padding frames
    carry zero posterior mass), and one shorter than ``min_window`` TRUE
    frames is kept rather than dropped."""
    x = _frames(feats, device)
    if x.dim() != 2 or x.shape[1] != extractor.ubm.dim:
        raise ValueError(f"expected [T, {extractor.ubm.dim}] features, "
                         f"got {tuple(np.shape(feats))}")
    T = x.shape[0]
    m = torch.ones(T, device=x.device) if mask is None \
        else features.on_device(mask, x.device).to(torch.float32)
    if tuple(m.shape) != (T,):
        raise ValueError(f"mask {tuple(m.shape)} vs frames {(T,)}")
    Tg = T
    if bucket_frames:
        from tpufeat_torch.data import bucket_length
        Tg = bucket_length(T, minimum=max(window, 256))
    spans = sliding_windows(Tg, window=window, period=period,
                            min_window=min_window)
    ivecs = _window_ivectors(extractor, x, m, spans, window, period,
                             posterior_scale, min_post)
    if not bucket_frames:
        return ivecs, spans
    keep = spans[:, 0] < T
    spans = spans[keep].copy()
    spans[:, 1] = np.minimum(spans[:, 1], T)        # true clamped ends
    return ivecs[torch.from_numpy(np.flatnonzero(keep)).to(x.device)], spans


def _window_ivectors(extractor, x, m, spans, window, period, scale,
                     min_post) -> torch.Tensor:
    """The windows' i-vectors of the frames ``x`` [T, D] (zero-padded to
    the grid of ``spans``, whose windows start on period blocks)."""
    ops = extractor.device_operands(x.device)
    post = _posteriors(x, ops, min_post) * m[:, None] * scale   # [T, G]
    nblk = -(-int(spans[-1, 1]) // period)
    pad = nblk * period - x.shape[0]
    G = post.shape[1]
    blkN, blkb = _first_order(
        torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(
            nblk, period, -1),
        torch.nn.functional.pad(post, (0, 0, 0, pad)).reshape(
            nblk, period, G), ops)
    blkN, blkb = blkN[:, 0], blkb[:, 0]             # [nblk, G], [nblk, K]
    starts = spans[:, 0] // period
    ends = -(-spans[:, 1] // period)                # a clamped tail's end
    idx = starts[:, None] + np.arange(window // period)[None]
    take = torch.from_numpy(np.minimum(idx, nblk - 1)).to(x.device)
    inside = torch.from_numpy(idx < ends[:, None]).to(x.device)[..., None]
    N = (blkN[take] * inside).sum(dim=1)
    b = (blkb[take] * inside).sum(dim=1)
    ivecs, info = _damped_solve(N, b, ops, 0.0)
    check_info(info, "segment_ivectors")
    return ivecs.float()


def _nearest_sorted(centers: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Index of the nearest value in SORTED ``centers`` for every ``t``
    (bisection; ties break low, matching argmin's first occurrence)."""
    hi = np.clip(np.searchsorted(centers, t), 0, len(centers) - 1)
    lo = np.maximum(hi - 1, 0)
    return np.where(np.abs(t - centers[lo]) <= np.abs(t - centers[hi]),
                    lo, hi)


def _host_ivecs(ivecs) -> np.ndarray:
    return np.asarray(_host(ivecs), np.float64)


def plda_affinity(plda: Plda, ivecs, *, normalize_length: bool = True,
                  host: bool = False, device=None) -> np.ndarray:
    """Symmetrized PLDA log-likelihood-ratio affinity between every
    window pair: [N, K] -> [N, N] float32 (one two-GEMM scoring call on
    ``device``, by default where ``ivecs`` lives when it is a tensor, else
    the card; the LLR is not exactly symmetric, so (S + S^T)/2).

    ``host=True`` scores with the float64 numpy twin
    (``Plda.score_host``, parity-tested) instead: the reference's route
    for many small affinities (two_stage_cluster's per-block stage)."""
    if device is None and isinstance(ivecs, torch.Tensor):
        device = ivecs.device
    iv = _host_ivecs(ivecs)
    if host:
        s = plda.score_host(iv, iv, normalize_length=normalize_length)
    else:
        s = plda.score(iv, iv, normalize_length=normalize_length,
                       device=device).cpu().numpy()
    return (0.5 * (s + s.T)).astype(np.float32)


def cluster_affinity(affinity, *, num_speakers: int | None = None,
                     threshold: float = 0.0) -> np.ndarray:
    """Average-linkage agglomerative clustering over a PLDA affinity
    matrix -> [N] integer labels (0..n_clusters-1, relabeled in first-
    appearance order). Stop at ``num_speakers`` clusters when known,
    else keep merging while the linked affinity stays above
    ``threshold`` (0.0 = the PLDA same/different decision boundary)."""
    from scipy.cluster import hierarchy
    aff = np.asarray(affinity, np.float64)
    n = aff.shape[0]
    if aff.shape != (n, n):
        raise ValueError(f"affinity must be square, got {aff.shape}")
    if n == 1:
        return np.zeros(1, np.int64)
    # similarities -> non-negative distances for linkage
    hi = aff.max()
    dist = hi - aff
    iu = np.triu_indices(n, 1)
    Z = hierarchy.linkage(dist[iu], method="average")
    if num_speakers is not None:
        if not 1 <= num_speakers <= n:
            raise ValueError(f"num_speakers {num_speakers} outside "
                             f"[1, {n}]")
        raw = hierarchy.fcluster(Z, num_speakers, criterion="maxclust")
    else:
        raw = hierarchy.fcluster(Z, hi - threshold, criterion="distance")
    return _first_appearance(raw)


def _first_appearance(labels) -> np.ndarray:
    order: dict = {}
    return np.asarray([order.setdefault(v, len(order)) for v in labels],
                      np.int64)


def refine_labels(plda: Plda, ivecs, labels, *, iters: int = 1):
    """Resegmentation-lite: re-assign every window to the PLDA-nearest
    cluster centroid (float64 host scoring: the [E, N] problem is small
    and E shrinks as clusters dissolve), as commonly run after AHC. Empty
    clusters disappear; labels come back compacted in first-appearance
    order. Converges when no label changes."""
    if iters < 0:
        raise ValueError("iters must be >= 0")
    iv = _host_ivecs(ivecs)
    labels = np.asarray(labels, np.int64).copy()
    for _ in range(iters):
        uniq = np.unique(labels)
        means = np.stack([iv[labels == u].mean(axis=0) for u in uniq])
        counts = np.asarray([(labels == u).sum() for u in uniq],
                            np.float64)
        scores = plda.score_host(means, iv, counts)
        new = uniq[scores.argmax(axis=0)]
        if (new == labels).all():
            break
        labels = new
    return _first_appearance(labels)


def _label_frames(labels, spans, T, mask):
    """Window labels -> per-frame labels (nearest window center) and
    (start, end, speaker) runs; masked frames are -1 / excluded."""
    centers = spans.mean(axis=1)                     # [N], sorted
    frame_labels = labels[_nearest_sorted(centers, np.arange(T))]
    if mask is not None:
        m = mask.cpu().numpy() if isinstance(mask, torch.Tensor) \
            else np.asarray(mask)
        frame_labels = np.where(m > 0, frame_labels, -1)
    segments = []
    t = 0
    while t < T:
        lab = frame_labels[t]
        e = t + 1
        while e < T and frame_labels[e] == lab:
            e += 1
        if lab >= 0:
            segments.append((int(t), int(e), int(lab)))
        t = e
    return frame_labels, segments


def diarize(extractor: IvectorExtractor, plda: Plda, feats, *,
            window: int = 150, period: int = 75, min_window: int = 25,
            mask=None, num_speakers: int | None = None,
            threshold: float = 0.0, posterior_scale: float = 1.0,
            min_post: float = 0.025, bucket_frames: bool = False,
            refine_iters: int = 0, device=None):
    """Who-spoke-when for one recording's features [T, D] ->
    ``(frame_labels [T], segments)`` where ``segments`` is a list of
    ``(start_frame, end_frame, speaker)`` runs. Frames take the label of
    the window whose CENTER is nearest; with a VAD ``mask``, non-speech
    frames are labeled -1 and excluded from segments."""
    ivecs, spans = segment_ivectors(
        extractor, feats, window=window, period=period,
        min_window=min_window, mask=mask, posterior_scale=posterior_scale,
        min_post=min_post, bucket_frames=bucket_frames, device=device)
    labels = cluster_affinity(plda_affinity(plda, ivecs),
                              num_speakers=num_speakers,
                              threshold=threshold)
    if refine_iters:
        labels = refine_labels(plda, ivecs, labels, iters=refine_iters)
    return _label_frames(labels, spans, np.shape(feats)[0], mask)


def two_stage_cluster(plda: Plda, ivecs, *, block: int = 512,
                      num_speakers: int | None = None,
                      threshold: float = 0.0,
                      block_threshold: float | None = None,
                      device=None) -> np.ndarray:
    """Long-form clustering: per-block AHC -> centroid AHC (the
    standard hours-scale diarization recipe) -> [N] window labels.

    Windows are clustered within consecutive ``block``-window spans
    first (host-scored [block, block] affinities); each block cluster is
    summarized by its mean raw i-vector and count, and a second AHC over
    those centroids (PLDA-scored with enrollment counts, symmetrized)
    produces the global speakers: O(N*block) affinity work and O(N)
    memory instead of O(N^2). ``block_threshold`` (default
    ``threshold``) stops the within-block merging; leave it at the PLDA
    decision boundary so blocks over-fragment rather than over-merge —
    stage 2 can join fragments but never split them.

    Departure from the reference: with fewer than :data:`MIN_BLOCKS`
    blocks (N <= 3 * block) this clusters single-stage over the full
    [N, N] affinity, scored on ``device``. The reference takes that path
    only for N <= block, and with 2 blocks its centroid stage has too few
    fragments to repair a block's errors (frame agreement fell to 0.746)."""
    iv = _host_ivecs(ivecs)
    N = iv.shape[0]
    if block < 2:
        raise ValueError("block must be >= 2")
    if -(-N // block) < MIN_BLOCKS:
        return cluster_affinity(plda_affinity(plda, iv, device=device),
                                num_speakers=num_speakers,
                                threshold=threshold)
    bt = threshold if block_threshold is None else block_threshold
    frag = np.full(N, -1, np.int64)
    means, counts = [], []
    for b0 in range(0, N, block):
        sl = slice(b0, min(b0 + block, N))
        lab = cluster_affinity(plda_affinity(plda, iv[sl], host=True),
                               threshold=bt)
        for u in range(lab.max() + 1):
            rows = np.flatnonzero(lab == u) + b0
            frag[rows] = len(means)
            means.append(iv[rows].mean(axis=0))
            counts.append(len(rows))
    means = np.stack(means)
    counts = np.asarray(counts, np.float64)
    s = plda.score_host(means, means, counts)
    aff_c = (0.5 * (s + s.T)).astype(np.float32)
    if num_speakers is not None and num_speakers > len(means):
        raise ValueError(
            f"stage 1 produced only {len(means)} fragments but "
            f"num_speakers={num_speakers}; lower block_threshold "
            f"(over-fragment) or use single-stage diarize()")
    glob = cluster_affinity(aff_c, num_speakers=num_speakers,
                            threshold=threshold)
    return _first_appearance(glob[frag])


def diarize_long(extractor: IvectorExtractor, plda: Plda, feats, *,
                 window: int = 150, period: int = 75,
                 min_window: int = 25, mask=None,
                 num_speakers: int | None = None, threshold: float = 0.0,
                 block: int = 512, block_threshold: float | None = None,
                 posterior_scale: float = 1.0, min_post: float = 0.025,
                 refine_iters: int = 2, device=None):
    """Hours-scale :func:`diarize`: the same segment-i-vector front half
    (linear in T on the device), :func:`two_stage_cluster` for the
    quadratic half, then :func:`refine_labels` passes — centroid
    re-assignment repairs fragments the block boundaries split (the
    reference measured the second pass as the accuracy lever and passes
    beyond 2 as no further gain, hence ``refine_iters=2``). ``block``
    stays 512, the reference's robust point. Returns ``(frame_labels
    [T], segments)`` like :func:`diarize`."""
    ivecs, spans = segment_ivectors(
        extractor, feats, window=window, period=period,
        min_window=min_window, mask=mask, posterior_scale=posterior_scale,
        min_post=min_post, bucket_frames=True, device=device)
    iv = _host_ivecs(ivecs)
    labels = two_stage_cluster(plda, iv, block=block,
                               num_speakers=num_speakers,
                               threshold=threshold,
                               block_threshold=block_threshold,
                               device=ivecs.device)
    if refine_iters:
        labels = refine_labels(plda, iv, labels, iters=refine_iters)
    return _label_frames(labels, spans, np.shape(feats)[0], mask)


# ---------------------------------------------------------------------------
# RTTM output + CLI (python -m tpufeat_torch.diarization)
# ---------------------------------------------------------------------------

def write_rttm(file, rec_id: str, segments, *,
               frame_shift: float = 0.010) -> None:
    """Write diarization segments as standard RTTM ``SPEAKER`` lines
    (the NIST scoring format): ``segments`` is :func:`diarize`'s
    (start_frame, end_frame, speaker) list; times are frames x
    ``frame_shift`` seconds. ``file`` is a path or an open text file."""
    own = isinstance(file, str)
    f = open(file, "w") if own else file
    try:
        for s, e, lab in segments:
            f.write(f"SPEAKER {rec_id} 1 {s * frame_shift:.3f} "
                    f"{(e - s) * frame_shift:.3f} <NA> <NA> "
                    f"spk{lab} <NA> <NA>\n")
    finally:
        if own:
            f.close()


def main(argv=None) -> int:
    """CLI: WAV -> RTTM. Requires a trained extractor + PLDA model (see
    the trainers of :mod:`tpufeat_torch.ivector` and
    :mod:`tpufeat_torch.plda`)."""
    import argparse
    import dataclasses
    import json
    import os
    import sys

    from tpufeat_torch import cli, io
    from tpufeat_torch.augment import energy_vad
    from tpufeat_torch.config import PRESETS

    p = argparse.ArgumentParser(
        prog="tpufeat_torch.diarization",
        description="diarize a recording on a CUDA card: WAV in, RTTM out")
    p.add_argument("wav", help="a WAV file, or a DIRECTORY of WAVs "
                               "(corpus mode: one RTTM with every "
                               "recording, bucketed lengths)")
    p.add_argument("rttm", help="output RTTM path ('-' for stdout)")
    p.add_argument("--extractor", required=True, metavar="NPZ",
                   help="IvectorExtractor.save() file trained on this "
                        "preset's features")
    p.add_argument("--plda", required=True, metavar="FILE",
                   help="Plda.save() npz (or Kaldi binary <Plda> object "
                        "written by save_kaldi / ivector-compute-plda)")
    p.add_argument("--preset", default="mfcc13", choices=sorted(PRESETS))
    p.add_argument("--fused", action="store_true",
                   help="the card's kernel route: use_pallas + gemm_dft + "
                        "fused_framing at bf16x3")
    p.add_argument("--num-speakers", type=int, default=None)
    p.add_argument("--threshold", type=float, default=0.0,
                   help="AHC stopping PLDA score (used when the speaker "
                        "count is unknown)")
    p.add_argument("--window", type=int, default=150,
                   help="segment window in frames (150 = 1.5 s)")
    p.add_argument("--period", type=int, default=75,
                   help="segment hop in frames (75 = 0.75 s)")
    p.add_argument("--vad-db", type=float, default=None,
                   help="gate frames more than this many dB below the "
                        "peak frame energy (off by default)")
    p.add_argument("--long", dest="long_form", action="store_true",
                   help="hours-scale recordings: two-stage clustering "
                        "(per-block AHC -> centroid AHC) + centroid "
                        "refinement instead of the full [N, N] affinity "
                        "(diarize_long)")
    p.add_argument("--block", type=int, default=512,
                   help="windows per first-stage block with --long")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; refuses to run without a card), "
                        "cuda:N or cpu")
    args = p.parse_args(argv)

    device = cli.device_of(args.device)
    cfg = PRESETS[args.preset]
    if args.fused:
        cfg = dataclasses.replace(cfg, use_pallas=True, gemm_dft=True,
                                  fused_framing=True,
                                  matmul_precision="bf16x3")
    ext = IvectorExtractor.load(args.extractor)
    if ext.ubm.dim != cfg.feature_dim:
        raise ValueError(f"extractor UBM dim {ext.ubm.dim} != preset "
                         f"feature dim {cfg.feature_dim}")
    model = Plda.load_auto(args.plda)
    if model.dim != ext.ivector_dim:
        raise ValueError(f"PLDA dim {model.dim} != i-vector dim "
                         f"{ext.ivector_dim}")

    if os.path.isdir(args.wav):
        # corpus mode: every WAV under the directory into ONE RTTM
        wavs = sorted(
            os.path.join(root, n)
            for root, _, files in os.walk(args.wav)
            for n in files if n.lower().endswith(".wav"))
        if not wavs:
            raise ValueError(f"no .wav files under {args.wav}")
        bucket = True
    else:
        wavs = [args.wav]
        bucket = False
    out = sys.stdout if args.rttm == "-" else open(args.rttm, "w")
    shift = cfg.hop_length / cfg.sample_rate
    try:
        for path in wavs:
            x, rate = io.read_wav(path)
            if rate != cfg.sample_rate:
                raise ValueError(f"{path} is {rate} Hz; resample to "
                                 f"{cfg.sample_rate} first "
                                 "(tpufeat_torch.resample)")
            feats = features.extract(x, cfg=cfg, device=device).features
            mask = None
            if args.vad_db is not None:
                v = energy_vad(x[None], np.array([x.shape[0]]),
                               cfg.frame_length, cfg.hop_length,
                               threshold_db=-abs(args.vad_db),
                               device=device)[0]
                F = feats.shape[0]
                if v.shape[0] < F:   # centered configs frame wider
                    v = torch.cat([v, v[-1:].expand(F - v.shape[0])])
                mask = v[:F].to(torch.float32)
            if args.long_form:
                labels, segments = diarize_long(
                    ext, model, feats, window=args.window,
                    period=args.period, mask=mask,
                    num_speakers=args.num_speakers,
                    threshold=args.threshold, block=args.block)
            else:
                labels, segments = diarize(
                    ext, model, feats, window=args.window,
                    period=args.period, mask=mask,
                    num_speakers=args.num_speakers,
                    threshold=args.threshold, bucket_frames=bucket)
            rec = os.path.splitext(os.path.basename(path))[0]
            write_rttm(out, rec, segments, frame_shift=shift)
            n_spk = len({lab for _, _, lab in segments})
            print(json.dumps(
                {"recording": rec, "frames": int(len(labels)),
                 "speakers": n_spk, "segments": len(segments)}),
                file=sys.stderr)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# ---------------------------------------------------------------------------
# Online diarization (streaming who-spoke-when)
# ---------------------------------------------------------------------------

def _block_stats(x: torch.Tensor, k: int, period: int, scale: float,
                 min_post: float, ops) -> tuple[np.ndarray, np.ndarray]:
    """``k`` whole period-blocks of feature rows [k·period, D] -> per-block
    projected solve statistics, as float64 numpy: ``L_blk`` [k, K, K]
    (= Σ_g N_g U_g, the precision's contribution) and ``b_blk`` [k, K]
    (= F·P − N·q). The per-frame outer products and the [G, K·K]
    projection stay on the device; only [k, K, K] + [k, K] come back."""
    G, K = ops.q.shape
    post = _posteriors(x, ops, min_post) * scale
    n_blk, b_blk = _first_order(x.reshape(k, period, -1),
                                post.reshape(k, period, G), ops)
    l_blk = (n_blk[:, 0] @ ops.u).reshape(k, K, K)
    return l_blk.cpu().numpy(), b_blk[:, 0].cpu().numpy()


class StreamingDiarizer:
    """Online who-spoke-when over ONE recording's feature stream (the
    live sibling of :func:`diarize`): greedy PLDA clustering of
    sliding-window i-vectors as each window completes.

    Per chunk: incoming frames buffer on the host (at most one period's
    worth held back) until whole ``period`` blocks are available; one
    device call reduces them to per-block projected solve statistics
    (:func:`_block_stats`); every completed window (every ``period``
    frames once ``window`` frames have arrived) solves its i-vector on
    the host (a ring sum and one float64 K x K solve), scores it against
    the running speaker centroids with the float64 PLDA scorer, and
    either joins the best cluster (LLR >= ``threshold``) or starts a new
    one. Labels are first-appearance ids and never relabel.

    ``enroll_cap`` caps the enrollment count fed to the PLDA scorer (an
    uncapped cluster contaminated by one boundary window grows
    over-confident and absorbs everything); ``recenter`` re-assigns all
    past window i-vectors to the current clusters every that-many
    windows and rebuilds the centroids — forward-only: emitted labels
    never change. ``recenter=0`` disables.

    ``process(feats [n, D])`` returns (frame_labels [m], start_frame) for
    the frames whose nearest window center is now decided — output lags
    input by about ``window/2 + period`` frames; ``flush()`` labels the
    tail. Labels are chunk-plan invariant."""

    def __init__(self, extractor: IvectorExtractor, plda: Plda, *,
                 window: int = 150, period: int = 75,
                 threshold: float = 0.0, max_speakers: int | None = None,
                 posterior_scale: float = 1.0, min_post: float = 0.025,
                 enroll_cap: float | None = 3.0, recenter: int = 25,
                 device=None):
        if window % period:
            raise ValueError(f"window ({window}) must be a multiple of "
                             f"period ({period})")
        if plda.dim != extractor.ivector_dim:
            raise ValueError(f"PLDA dim {plda.dim} != i-vector dim "
                             f"{extractor.ivector_dim}")
        self.extractor, self.plda = extractor, plda
        self.window, self.period = int(window), int(period)
        self.threshold = float(threshold)
        self.max_speakers = max_speakers
        self.scale, self.min_post = float(posterior_scale), float(min_post)
        self.enroll_cap = None if enroll_cap is None else float(enroll_cap)
        if recenter < 0:
            raise ValueError(f"recenter must be >= 0, got {recenter}")
        self.recenter = int(recenter)
        self.device = features.default_device(device)
        self._ops = extractor.device_operands(self.device)
        self.reset()

    def reset(self) -> None:
        D = self.extractor.ubm.dim
        K = self.extractor.ivector_dim
        m = self.window // self.period
        self._ring_L = np.zeros((m, K, K))       # projected block stats
        self._ring_b = np.zeros((m, K))
        self._buf = np.zeros((0, D), np.float32)  # sub-period holdback
        self._n_seen = 0                         # frames received
        self._n_blocks = 0                       # completed blocks
        self._centers: list[float] = []          # window centers
        self._wlabels: list[int] = []            # per-window labels
        self._wivs: list[np.ndarray] = []        # window i-vectors
        self._clusters: list[list] = []          # [sum_ivec, count]
        self._emitted = 0                        # frames labeled so far
        self._flushed = False

    @property
    def num_speakers(self) -> int:
        return len(self._clusters)

    def _centroids(self) -> tuple[np.ndarray, np.ndarray]:
        means = np.stack([s / c for s, c in self._clusters])
        counts = np.asarray([c for _, c in self._clusters], np.float64)
        if self.enroll_cap is not None:
            counts = np.minimum(counts, self.enroll_cap)
        return means, counts

    def _window_done(self, end_true: int | None = None) -> None:
        """A window of ``window // period`` blocks just completed;
        ``end_true`` caps the window's real data end (flush tail)."""
        K = self.extractor.ivector_dim
        L = np.eye(K) + self._ring_L.sum(axis=0)
        b = self._ring_b.sum(axis=0)
        w = np.linalg.solve(L, b)
        if self._clusters:
            means, counts = self._centroids()
            llr = self.plda.score_host(means, w[None], counts)[:, 0]
            best = int(np.argmax(llr))
            full = (self.max_speakers is not None
                    and len(self._clusters) >= self.max_speakers)
            if llr[best] >= self.threshold or full:
                self._clusters[best][0] += w
                self._clusters[best][1] += 1
                lab = best
            else:
                self._clusters.append([w.copy(), 1])
                lab = len(self._clusters) - 1
        else:
            self._clusters.append([w.copy(), 1])
            lab = 0
        end = self._n_blocks * self.period
        start = max(0, end - self.window)
        if end_true is not None:
            end = min(end, end_true)
        self._centers.append((start + end) / 2.0)
        self._wlabels.append(lab)
        self._wivs.append(w)
        if (self.recenter and len(self._wlabels) % self.recenter == 0
                and len(self._clusters) > 1):
            # forward-only re-centering: emitted labels are untouched,
            # future scoring sharpens
            H = np.stack(self._wivs)
            means, counts = self._centroids()
            assign = self.plda.score_host(means, H, counts).argmax(axis=0)
            new = []
            for j, old in enumerate(self._clusters):
                mem = H[assign == j]
                # a cluster losing every member keeps its old centroid
                # (ids are stable; it can win windows again later)
                new.append([mem.sum(axis=0), float(len(mem))]
                           if len(mem) else old)
            self._clusters = new

    def _push_blocks(self, k: int, xk: np.ndarray) -> None:
        """Reduce ``k`` whole period-blocks to stats on the device (one
        call) and feed the ring; window solves fire as blocks
        complete."""
        l_blk, b_blk = _block_stats(
            torch.as_tensor(xk, device=self.device), k, self.period,
            self.scale, self.min_post, self._ops)
        m = self.window // self.period
        for j in range(k):
            slot = self._n_blocks % m
            self._ring_L[slot] = l_blk[j]
            self._ring_b[slot] = b_blk[j]
            self._n_blocks += 1
            if self._n_blocks >= m:
                self._window_done()

    def _emit_upto(self, limit: int) -> tuple[np.ndarray, int]:
        start = self._emitted
        n = max(0, limit - start)
        if n == 0 or not self._centers:
            return np.zeros(0, np.int64), start
        t = np.arange(start, start + n, dtype=np.float64)
        nearest = _nearest_sorted(np.asarray(self._centers), t)
        self._emitted = start + n
        return np.asarray(self._wlabels, np.int64)[nearest], start

    def process(self, feats) -> tuple[np.ndarray, int]:
        """[n, D] new feature rows -> (labels for newly-decided frames,
        absolute start frame of those labels)."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset() "
                               "before reusing this diarizer")
        x = feats.detach().cpu().numpy() if isinstance(feats, torch.Tensor)\
            else np.asarray(feats, np.float32)
        x = x.astype(np.float32, copy=False)
        if x.ndim != 2 or x.shape[1] != self.extractor.ubm.dim:
            raise ValueError(f"expected [n, {self.extractor.ubm.dim}], "
                             f"got {x.shape}")
        if x.shape[0]:
            self._buf = x if not self._buf.shape[0] else \
                np.concatenate([self._buf, x])
            self._n_seen += x.shape[0]
            k = self._buf.shape[0] // self.period
            if k:
                xk = self._buf[: k * self.period]
                self._buf = self._buf[k * self.period:]
                self._push_blocks(k, xk)
        # frames up to the LAST decided center are final (no future
        # window center can be nearer)
        limit = int(self._centers[-1]) + 1 if self._centers else 0
        return self._emit_upto(limit)

    def flush(self) -> tuple[np.ndarray, int]:
        """End of stream: complete the final partial window (if any
        frames arrived past the last completed one) and label the tail.
        Terminal: a second flush() emits nothing; process() after flush()
        raises (reset() starts a new stream)."""
        if self._flushed:
            return self._emit_upto(self._n_seen)
        self._flushed = True
        m = self.window // self.period
        tail, self._buf = self._buf, self._buf[:0]
        if tail.shape[0] or (self._n_blocks and self._n_blocks < m):
            # reduce the sub-period tail (if any) as one short block, fold
            # it in and run a final (short) window; its center uses the
            # TRUE data end, not the padded grid
            slot = self._n_blocks % m
            if tail.shape[0]:
                l_blk, b_blk = _block_stats(
                    torch.as_tensor(tail, device=self.device), 1,
                    tail.shape[0], self.scale, self.min_post, self._ops)
                self._ring_L[slot] = l_blk[0]
                self._ring_b[slot] = b_blk[0]
            else:
                self._ring_L[slot] = 0.0
                self._ring_b[slot] = 0.0
            self._n_blocks += 1
            self._window_done(end_true=self._n_seen)
        return self._emit_upto(self._n_seen)


if __name__ == "__main__":
    import sys
    sys.exit(main())
