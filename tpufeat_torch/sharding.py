"""Multi-device execution over ``torch.distributed``: data-parallel batches
and time-sharded long audio — counterpart of ``tpufeat/sharding.py``.

The reference's ``jax.sharding.Mesh`` becomes a process group: every rank
runs the same call (SPMD), computes its part on its own device and meets
the others in collectives. Each function takes ``group=None``, the default
group; with no process group initialised it is a one-rank group and no
collective runs (the reference's one-device case). The reference's 2-D
``(dp, time)`` mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``get_group("dp")`` and ``get_group("time")`` give the two axes. Where the
reference's single controller sees the whole result, every rank here
receives it: the outputs are gathered (``all_gather``) in rank order.

- **Data parallel**: every rank is handed the whole batch [B, N] (the
  single controller's view), extracts rows ``[r * B / W, (r + 1) * B / W)``
  on its device and gathers the features and frame counts. No other
  collective: utterances do not couple.
- **Time sharding**: one long recording (or, on the 2-D mesh, each row of
  a batch) is cut into W equal shards of ``s_loc`` samples. A rank needs
  one sample from its left neighbour (pre-emphasis continuity) and
  ``frame_length - hop`` from its right (frames that cross into the next
  shard); a centred config reflects at the global edges only. With those
  halos its shard is exactly a framing buffer of ``s_loc / hop`` frames,
  so the fused configs run the same signal kernel (K1,
  ``kernels/signal.signal_features``) as :func:`features.extract`, and the
  others the staged route. Whisper's log-mel max is an ``all_reduce(MAX)``
  of the masked local max, CMVN's moments a masked ``all_reduce(SUM)``,
  and the deltas exchange ``delta_window`` frames with each neighbour and
  gather with globally clipped indices.

K1 computes a frame's bits from that frame alone, every halo is an exact
copy and a max does not depend on order, so a sharded call without CMVN
equals the unsharded :func:`features.extract` bit for bit; CMVN's sums are
taken in another order (within 2e-5 scaled).

Collectives all go through :func:`_collective`. On a gloo group, gloo
moves device tensors only for ``all_reduce`` and ``broadcast``, so the
helper stages any other collective's tensor through host memory and moves
the result back to the tensor's device. That is the transport gloo offers,
not a fallback: the computation stays on each rank's device, and a failed
collective raises. (Several ranks sharing one card can only form a gloo
group: NCCL refuses two ranks on one GPU.)

Not ported: the reference's jit caches (``_make_*_fn``), ``check_vma``, and
the erratum row split that ``tpufeat/pipeline.py`` applies around dp — all
TPU-only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from tpufeat_torch import features, framing, pitch
from tpufeat_torch.config import FeatureConfig, MFCC13_HTK
from tpufeat_torch.features import FeatureResult
from tpufeat_torch.kernels import signal as signal_kernel

__all__ = ["default_mesh", "extract_data_parallel", "extract_time_sharded",
           "extract_batch_time_sharded", "pitch_features_data_parallel",
           "shardable_length"]


def rank_and_size(group=None) -> tuple[int, int]:
    """(this process's rank in ``group``, the group's size); (0, 1) when no
    process group is initialised."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def backend_for(device, ranks: int) -> str:
    """The process group's backend for ``ranks`` ranks computing on
    ``device`` on one host: NCCL when each has a card of its own, else
    gloo (NCCL refuses two ranks on one GPU)."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= ranks:
        return "nccl"
    return "gloo"


def default_mesh(axis_name: str = "dp"):
    """The default group's ranks as a one-axis ``DeviceMesh`` named
    ``axis_name`` (``mesh.get_group(axis_name)`` is then the group the
    functions here take). The mesh only names ranks: each rank computes on
    the ``device`` it passes. Raises without an initialised process group,
    where ``group=None`` is already the one-rank case."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise ValueError("no process group is initialised: pass group=None "
                         "for the one-rank case, or init_process_group first")
    return DeviceMesh("cpu", torch.arange(dist.get_world_size()),
                      mesh_dim_names=(axis_name,))


def _collective(kind: str, t: torch.Tensor, group=None,
                op=dist.ReduceOp.SUM):
    """The one path of every collective here: ``"all_reduce"`` (with
    ``op``) and ``"broadcast"`` (from the group's rank 0) return the reduced
    or received tensor, ``"all_gather"`` the group's tensors in rank order.
    On a gloo group a device tensor crosses through host memory for
    ``all_gather`` (gloo moves device tensors only for the other two); the
    result is on ``t``'s device. Without a process group: ``t`` (or
    ``[t]``)."""
    if not dist.is_initialized():
        return [t] if kind == "all_gather" else t
    host = (t.device.type != "cpu" and kind == "all_gather"
            and dist.get_backend(group) == "gloo")
    src = (t.cpu() if host else t).contiguous()
    if kind == "all_reduce":
        dist.all_reduce(src, op=op, group=group)
        return src
    if kind == "broadcast":
        root = 0 if group is None else dist.get_global_rank(group, 0)
        dist.broadcast(src, src=root, group=group)
        return src
    if kind != "all_gather":
        raise ValueError(f"unknown collective {kind!r}")
    parts = [torch.empty_like(src) for _ in range(rank_and_size(group)[1])]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def _gather_rows(tensors, group=None, dim: int = 0) -> list:
    """Each tensor's parts from every rank, concatenated along ``dim`` in
    rank order."""
    return [torch.cat(_collective("all_gather", t, group), dim=dim)
            for t in tensors]


def _own_rows(n_rows: int, group, what: str) -> slice:
    rank, size = rank_and_size(group)
    if n_rows % size:
        raise ValueError(f"{what}: B={n_rows} is not divisible by the "
                         f"group's {size} ranks; pad the batch with zero "
                         "rows of length 0")
    per = n_rows // size
    return slice(rank * per, (rank + 1) * per)


def _lengths(lengths, signal) -> torch.Tensor:
    if lengths is None:
        return torch.full((len(signal),), signal.shape[-1],
                          dtype=torch.int64)
    if isinstance(lengths, torch.Tensor):
        return lengths
    return torch.as_tensor(np.asarray(lengths))


# ---------------------------------------------------------------------------
# Data parallelism: each rank its rows, one gather
# ---------------------------------------------------------------------------

def extract_data_parallel(signal, lengths, cfg: FeatureConfig, group=None,
                          device=None) -> FeatureResult:
    """Batched :func:`features.extract` with the batch axis split over the
    ranks of ``group``.

    Every rank passes the whole ``signal`` [B, N] (numpy, or a tensor) and
    ``lengths`` [B], B divisible by the group's size; each extracts its
    rows on ``device`` (default the card) and the result is gathered: every
    rank returns the whole batch's :class:`FeatureResult`, on its device.
    Utterances do not couple, so the rows equal ``extract`` of the batch."""
    lengths = _lengths(lengths, signal)
    rows = _own_rows(len(signal), group, "extract_data_parallel")
    res = features.extract(signal[rows], lengths[rows], cfg, device=device)
    feats, nf = _gather_rows([res.features, res.num_frames], group)
    mask = torch.arange(feats.shape[1], device=feats.device)[None, :] \
        < nf[:, None]
    return FeatureResult(feats, mask, nf)


def pitch_features_data_parallel(signal, lengths, cfg=None, group=None,
                                 device=None):
    """Batch-split Kaldi-style pitch features -> (feats [B, F, 3], valid
    [B, F]), B divisible by the group's size; every rank passes the whole
    batch and returns the whole result, as in
    :func:`extract_data_parallel`. Pitch is per utterance, so no other
    collective runs. ``cfg`` defaults to ``PitchConfig()``; pass
    ``pitch.config_for(feature_cfg)`` to stay on a feature grid."""
    cfg = pitch.PitchConfig() if cfg is None else cfg
    lengths = _lengths(lengths, signal)
    rows = _own_rows(len(signal), group, "pitch_features_data_parallel")
    feats, valid = pitch.pitch_features(signal[rows], lengths[rows], cfg,
                                        device=device)
    feats, valid = _gather_rows([feats, valid], group)
    return feats, valid


# ---------------------------------------------------------------------------
# Time sharding with halo exchange
# ---------------------------------------------------------------------------

def shardable_length(n: int, cfg: FeatureConfig, n_shards: int) -> int:
    """Smallest padded length >= n divisible by n_shards*hop with a
    >=frame_length shard. Pad the tail with zeros up to this (padding frames
    are masked off by the valid-count logic)."""
    unit = n_shards * cfg.hop_length
    m = -(-n // unit) * unit
    while m // n_shards < cfg.frame_length:
        m += unit
    return m


def _check_time_shardable(cfg: FeatureConfig) -> None:
    """Reject the config corners a time shard cannot compute: the centred
    body neither pre-emphasizes nor makes the extra final frame of
    ``drop_last_frame=False``; PNCC's and sliding CMVN's state spans the
    utterance; dither needs a generator the shards do not share."""
    if cfg.center and (cfg.preemphasis != 0.0 or not cfg.drop_last_frame):
        raise ValueError(
            "time sharding supports centered configs only with "
            "preemphasis=0 and drop_last_frame=True (the Whisper "
            "convention); use extract()/extract_data_parallel for "
            f"center=True with preemphasis={cfg.preemphasis}, "
            f"drop_last_frame={cfg.drop_last_frame}")
    if cfg.pncc:
        raise ValueError(
            "PNCC's noise-floor/peak/power-mean recursions carry state "
            "across the WHOLE utterance — time shards cannot compute "
            "them locally; use extract()/extract_data_parallel "
            "(dp shards are whole utterances and compose fine)")
    if cfg.cmvn.startswith("sliding"):
        raise ValueError(
            "time sharding implements utterance-global CMVN (one "
            "all_reduce); sliding CMVN windows "
            f"({cfg.cmvn_window} frames) would cross shard boundaries — "
            "extract the features time-sharded with cmvn='none' and apply "
            "features.sliding_cmvn afterwards, or use "
            "extract()/extract_data_parallel")
    if cfg.dither > 0:
        raise ValueError("time sharding takes no generator: dither with "
                         "extract(..., generator=)")


def _halos(x: torch.Tensor, left: int, right: int, group,
           dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """(the last ``left`` elements of the left neighbour's ``x``, the first
    ``right`` of the right neighbour's) along ``dim``: zeros past the first
    and last ranks, as one-shot zero padding beyond the signal. One
    all_gather of every rank's two edges."""
    rank, size = rank_and_size(group)
    n = x.shape[dim]
    edges = torch.cat([x.narrow(dim, 0, right), x.narrow(dim, n - left, left)],
                      dim=dim)
    parts = _collective("all_gather", edges, group)
    lo = parts[rank - 1].narrow(dim, right, left) if rank > 0 else \
        torch.zeros_like(x.narrow(dim, 0, left))
    hi = parts[rank + 1].narrow(dim, 0, right) if rank < size - 1 else \
        torch.zeros_like(x.narrow(dim, 0, right))
    return lo, hi


def _sharded_deltas(feat: torch.Tensor, total_valid: torch.Tensor,
                    f_loc: int, window: int, group) -> torch.Tensor:
    """Regression deltas of [B, f_loc, D] across shard boundaries:
    ``window`` feature frames from each neighbour, then gathers at globally
    clipped frame indices, so the edges replicate at each utterance's true
    ends — :func:`features.deltas`' arithmetic, term for term."""
    rank, _ = rank_and_size(group)
    left, right = _halos(feat, window, window, group, dim=-2)
    ext = torch.cat([left, feat, right], dim=-2)        # [B, f_loc + 2w, D]
    B, _, D = feat.shape
    g = rank * f_loc + torch.arange(f_loc, device=feat.device)[None, :]
    hi = torch.clamp(total_valid.to(feat.device, torch.int64) - 1,
                     min=0)[:, None]
    denom = 2.0 * sum(i * i for i in range(1, window + 1))

    def take(frame):
        # frames past an utterance's end index far-off halos; they are
        # masked, so clip them into the buffer
        ix = torch.clamp(frame - rank * f_loc + window, 0,
                         f_loc + 2 * window - 1)
        return torch.gather(ext, 1, ix[..., None].expand(B, f_loc, D))

    out = torch.zeros_like(feat)
    for i in range(1, window + 1):
        plus = take(torch.minimum(g + i, hi))
        minus = take(torch.minimum(torch.clamp(g - i, min=0), hi))
        out = out + i * (plus - minus)
    return out / denom


def _global_whisper_normalize(ls: torch.Tensor, mask: torch.Tensor,
                              group) -> torch.Tensor:
    """:func:`features.whisper_normalize` with the per-utterance max taken
    over every shard's valid frames (``all_reduce(MAX)``)."""
    valid = torch.where(mask[..., None], ls, float("-inf"))
    m = _collective("all_reduce", valid.amax(dim=(-2, -1), keepdim=True),
                    group, dist.ReduceOp.MAX)
    m = torch.where(torch.isfinite(m), m, 0.0)          # all-masked row
    return (torch.maximum(ls, m - 8.0) + 4.0) / 4.0


def _time_shard_body(x: torch.Tensor, total_valid: torch.Tensor,
                     cfg: FeatureConfig, f_loc: int, group) -> torch.Tensor:
    """One rank's shard [B, s_loc] (float32, on its device) with the true
    frame counts [B] -> its features [B, f_loc, D], deltas and CMVN
    included."""
    fl, hop = cfg.frame_length, cfg.hop_length
    rank, size = rank_and_size(group)
    mask = (rank * f_loc + torch.arange(f_loc, device=x.device))[None, :] \
        < total_valid.to(x.device)[:, None]
    if cfg.center:
        pad = cfg.n_fft // 2
        halo_r = max(fl - hop - pad, 0)
        left, right = _halos(x, pad, halo_r, group)
        # reflect at the GLOBAL edges only (the first rank's left, the last
        # rank's right)
        if rank == 0:
            left = x[:, 1: pad + 1].flip(-1)
        if rank == size - 1 and halo_r:
            right = x[:, -halo_r - 1: -1].flip(-1)
        buf = torch.cat([left, x, right], dim=-1)
    else:
        prev, halo = _halos(x, 1, fl - hop, group)
        buf = torch.cat([x, halo], dim=-1)
        if cfg.preemphasis and not cfg.kaldi_mode:
            # Kaldi pre-emphasizes per frame (condition_frames) instead
            buf = framing.preemphasize(buf, cfg.preemphasis, prev[:, 0])
    # frame j of the shard covers buf[j*hop : j*hop + fl]
    buf = buf.contiguous()

    def staged_frames():
        return framing.condition_frames(
            framing.frames_from_buffer(buf, f_loc, fl, hop), cfg)

    whisper = cfg.log == "whisper"
    if cfg.use_pallas and cfg.gemm_dft and cfg.fused_framing:
        feat = signal_kernel.signal_features(buf, f_loc, cfg)   # K1
    elif whisper:
        feat = features.spectro_pipeline(
            staged_frames(), mask, dataclasses.replace(
                cfg, log="log10", n_mfcc=0, lifter=0, use_energy=False,
                plp_order=0))
    else:
        feat = features.spectro_pipeline(staged_frames(), mask, cfg)
    if whisper or cfg.use_pallas and cfg.gemm_dft and cfg.fused_framing:
        if whisper:
            feat = _global_whisper_normalize(feat, mask, group)
            if cfg.n_mfcc > 0:
                feat = features.dct_lifter(feat, cfg)
        feat = features._cepstra(feat, mask, cfg)     # PLP: frame-local
        if cfg.use_energy:
            feat = features._apply_energy(feat, staged_frames(), cfg)

    if cfg.deltas:
        outs, d = [feat], feat
        for _ in range(cfg.delta_order):
            d = _sharded_deltas(d, total_valid, f_loc, cfg.delta_window,
                                group)
            outs.append(d)
        feat = torch.cat(outs, dim=-1)

    if cfg.cmvn != "none":
        m = mask[..., None].to(feat.dtype)             # [B, f_loc, 1]
        moments = _collective("all_reduce", torch.cat(
            [(feat * m).sum(dim=-2, keepdim=True),
             m.sum(dim=-2, keepdim=True)], dim=-1), group)
        cnt = torch.clamp(moments[..., -1:], min=1.0)
        feat = feat - moments[..., :-1] / cnt
        if cfg.cmvn == "meanvar":
            var = _collective("all_reduce", ((feat * m) ** 2).sum(
                dim=-2, keepdim=True), group) / cnt
            feat = feat / torch.sqrt(var + 1e-10)
    if cfg.out_dtype != "float32":
        feat = feat.to(getattr(torch, cfg.out_dtype))
    return feat


def _shard_input(signal, rows, cols, device) -> torch.Tensor:
    """``signal[rows, cols]`` (numpy or a tensor) as float32 on ``device``
    (default: where a tensor lives, else the card)."""
    x = features.placed(signal[rows, cols], device)
    if x.dtype == torch.int16:
        return x.to(torch.float32) / 32768.0
    return x.to(torch.float32)


def extract_time_sharded(signal, cfg: FeatureConfig = MFCC13_HTK,
                         group=None, length: int | None = None,
                         device=None) -> torch.Tensor:
    """Features of ONE long recording, its time axis split over the ranks
    of ``group``: [T_valid, D] on every rank, equal to
    ``extract(signal[:length], cfg=cfg).features``.

    Every rank passes the whole ``signal`` [N] and computes its shard on
    ``device``. ``N`` must be divisible by ``ranks * hop`` with shards of
    at least ``frame_length`` samples: zero-pad to :func:`shardable_length`
    and pass the true ``length`` (center=False configs only: valid frames
    never read past ``length``, and the masked collectives skip the
    padding frames)."""
    _check_time_shardable(cfg)
    _, size = rank_and_size(group)
    fl, hop = cfg.frame_length, cfg.hop_length
    n = signal.shape[-1]
    if signal.ndim != 1 or n % (size * hop) or n // size < fl:
        raise ValueError(
            f"length {n} not shardable over {size} ranks; pad to "
            f"{shardable_length(n, cfg, size)} (shardable_length)")
    if length is None:
        length = n
    elif length != n and cfg.center:
        raise ValueError("centered configs reflect at the true signal end; "
                         "shard exact-length audio (length == len(signal))")
    total_valid = cfg.num_frames(length)
    rank, _ = rank_and_size(group)
    s_loc = n // size
    x = _shard_input(signal[None], slice(None),
                     slice(rank * s_loc, (rank + 1) * s_loc), device)
    feat = _time_shard_body(x, torch.tensor([total_valid]), cfg,
                            s_loc // hop, group)
    full, = _gather_rows([feat], group, dim=-2)
    return full[0, :total_valid]


def extract_batch_time_sharded(signals, lengths, cfg: FeatureConfig, mesh,
                               dp_axis: str = "dp", time_axis: str = "time",
                               device=None) -> FeatureResult:
    """2-D mesh: a BATCH of long recordings split over ``(dp, time)`` at
    once. ``mesh`` is a ``DeviceMesh`` with both axes (``mesh_dim_names``).

    ``signals`` [B, N] with B divisible by the dp axis's size and N by
    ``time_size * hop`` (shards >= frame_length; zero-pad and pass the true
    ``lengths`` — center=False configs only, as in
    :func:`extract_time_sharded`). Each utterance lives on one dp row and
    is split along time over that row's ranks; halos and reductions ride
    the time axis only. Every rank passes the whole batch and returns the
    whole :class:`FeatureResult` ([B, F_total, D] features)."""
    _check_time_shardable(cfg)
    dp_group, time_group = mesh.get_group(dp_axis), mesh.get_group(time_axis)
    _, n_dp = rank_and_size(dp_group)
    t_rank, n_time = rank_and_size(time_group)
    B, n = signals.shape
    fl, hop = cfg.frame_length, cfg.hop_length
    if B % n_dp or n % (n_time * hop) or n // n_time < fl:
        raise ValueError(
            f"[B={B}, N={n}] not shardable over mesh {dp_axis}={n_dp}, "
            f"{time_axis}={n_time}; pad N to "
            f"{shardable_length(n, cfg, n_time)} and B to a multiple of "
            f"{n_dp}")
    lengths = _lengths(lengths, signals)
    if cfg.center and bool((lengths != n).any()):
        raise ValueError("centered configs reflect at the true signal end; "
                         "shard exact-length audio")
    nf = framing.num_frames_dynamic(lengths.to(torch.int64), cfg).to(
        torch.int32)
    rows = _own_rows(B, dp_group, "extract_batch_time_sharded")
    s_loc = n // n_time
    x = _shard_input(signals, rows,
                     slice(t_rank * s_loc, (t_rank + 1) * s_loc), device)
    feat = _time_shard_body(x, nf[rows], cfg, s_loc // hop, time_group)
    feat, = _gather_rows([feat], time_group, dim=-2)
    feat, = _gather_rows([feat], dp_group)
    nf = nf.to(feat.device)
    mask = torch.arange(feat.shape[1], device=feat.device)[None, :] \
        < nf[:, None]
    return FeatureResult(feat, mask, nf)
