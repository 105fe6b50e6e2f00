"""Stateful streaming front-end (config 4) — counterpart of the core of
``tpufeat/streaming.py``.

The contract: concatenating the per-chunk outputs equals the one-shot
output. Through the static step, every HOP-ALIGNED chunk plan gives the
same bits as :func:`extract_scan`, the bit-exact oracle of streaming
semantics: each frame sees the same float32 inputs through the same
kernels, and the kernels' per-row arithmetic does not depend on the call's
shape (a fixed tile and fixed-order sums, ``kernels/signal.py`` and
``kernels/staged.py``). The plain torch twins that a CPU tensor runs go
through BLAS, whose blocking may depend on the row count, so on the CPU
different plans agree to about 1e-6 rather than to the bit.

Two steps, as in the reference:

- **static fill** (:func:`process_chunk_static`, what every driver that
  knows its chunk sizes uses): the buffer fill is a pure function of the
  chunk-length history (:func:`next_fill`), so the step is slices only,
  and with ``use_pallas + gemm_dft + fused_framing`` it runs the fused
  signal kernel;
- **dynamic fill** (:func:`process_chunk`): a per-row fill, frames gathered
  by index, then the staged spectro path (``features.spectro_pipeline``).

State per stream (:class:`StreamState`):

- ``buf`` [B, frame_length-1]: *pre-emphasized* samples, the last ``fill``
  of which are the stream's unconsumed tail (right-aligned);
- ``fill`` [B] int32: the valid samples in ``buf``;
- ``prev_raw`` [B]: the last raw sample, for pre-emphasis continuity.

PyTorch runs eagerly, so the ``make_*_fn`` names of the reference return
plain cached callables, and the device scan is a Python loop over steps.
Tensors live on the device the caller chooses, the card (``"cuda"``)
unless it passes ``device="cpu"``; nothing moves between devices behind
the caller's back.

The online config-3 wrappers follow: :class:`StreamingDeltas`, running
CMVN (:func:`streaming_cmvn`), :class:`StreamingSlidingCMVN`,
:class:`OnlineCmvn`, and :class:`StreamingPipeline`, which composes them
behind the front-end. Their per-step functions are plain torch on the
tensors of the front-end's output. :class:`StreamPool` leases the rows of
one such wrapper to streams that start and end at different times
(``reset_rows`` recycles a row in place), and :class:`PoolRows` hands a
tick's output over as one batched tensor with per-slot trims.

PLP streams like MFCC (its tail is frame-local: the static step's kernel
emits the filterbank energies and ``plp.plp_from_energies`` follows);
PNCC and dither are refused, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch import features, framing, plp, resampling
from tpufeat_torch import ivector as ivmod
from tpufeat_torch import pitch as pitchmod
from tpufeat_torch.config import KALDI39, MFCC13_HTK, FeatureConfig
from tpufeat_torch.kernels import signal as signal_kernel


class StreamState(NamedTuple):
    buf: torch.Tensor       # [B, frame_length-1] pre-emphasized carry
    fill: torch.Tensor      # [B] int32 valid samples in buf (right-aligned)
    prev_raw: torch.Tensor  # [B] last raw sample seen


def zero_rows(x: torch.Tensor, rows, value=None) -> torch.Tensor:
    """Reset the given batch rows of a [B, ...] tensor to ``value``
    (default 0): the slot-recycle primitive of ``reset_rows``. One
    ``where`` per leaf, so the other rows keep their bits."""
    keep = np.ones(x.shape[0], bool)
    keep[np.asarray(list(rows), int)] = False
    k = torch.as_tensor(keep, device=x.device).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    fill = torch.zeros((), dtype=x.dtype, device=x.device) if value is None \
        else torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(k, x, fill)


def _check_streamable(cfg: FeatureConfig) -> None:
    if cfg.center:
        raise ValueError("streaming requires center=False (snip-edges)")
    if cfg.hop_length > cfg.frame_length:
        # the carry buffer holds frame_length-1 samples; hop > frame_length
        # (gapped framing) would need fill < 0, corrupting the state
        raise ValueError("streaming requires hop_length <= frame_length "
                         f"(got hop {cfg.hop_length} > frame "
                         f"{cfg.frame_length}); use one-shot extract()")
    if cfg.log == "whisper":
        raise ValueError("whisper log needs the utterance-global max; "
                         "use one-shot extract() or log='log10'")
    if cfg.deltas or cfg.cmvn != "none":
        raise ValueError("deltas/CMVN are utterance-global; compute them "
                         "offline or use streaming_cmvn running stats")
    if cfg.dither > 0:
        raise ValueError("dither is a training-time augmentation with no "
                         "cross-chunk PRNG state; disable it for streaming "
                         "(or add noise to the chunks yourself)")
    if cfg.pncc:
        raise ValueError(
            "PNCC's noise-floor/peak/power-mean recursions carry state "
            "across the whole utterance and its medium-time window looks "
            "2 frames ahead — a per-chunk step would silently reset them; "
            "use one-shot extract()")


def init_state(batch_size: int = 1, cfg: FeatureConfig = MFCC13_HTK,
               dtype=torch.float32, device=None) -> StreamState:
    """A fresh state for ``batch_size`` streams on ``device`` (default the
    card, ``features.default_device``)."""
    cap = cfg.frame_length - 1
    device = features.default_device(device)
    return StreamState(
        buf=torch.zeros(batch_size, cap, dtype=dtype, device=device),
        fill=torch.zeros(batch_size, dtype=torch.int32, device=device),
        prev_raw=torch.zeros(batch_size, dtype=dtype, device=device),
    )


def max_frames_per_chunk(chunk_len: int, cfg: FeatureConfig) -> int:
    """Static output capacity for a chunk of ``chunk_len`` samples."""
    cap = cfg.frame_length - 1
    return max(0, (cap + chunk_len - cfg.frame_length) // cfg.hop_length + 1)


def next_fill(fill: int, chunk_len: int, cfg: FeatureConfig) -> int:
    """Buffer fill after consuming a chunk of ``chunk_len`` samples.

    ``fill`` depends ONLY on the sequence of chunk lengths, never on sample
    values, so the host tracks it as a plain int and the static step's
    offsets are all known before it runs."""
    total = fill + chunk_len
    n_new = max(0, 1 + (total - cfg.frame_length) // cfg.hop_length)
    return total - n_new * cfg.hop_length


def _preemphasized(state: StreamState, chunk: torch.Tensor,
                   cfg: FeatureConfig) -> torch.Tensor:
    """The chunk after pre-emphasis with the carried last raw sample
    (kaldi_mode pre-emphasizes inside each frame instead)."""
    if cfg.kaldi_mode:
        return chunk
    return framing.preemphasize(chunk, cfg.preemphasis, state.prev_raw)


def _next_prev_raw(state: StreamState, chunk: torch.Tensor,
                   cfg: FeatureConfig) -> torch.Tensor:
    if chunk.shape[-1] == 0 or cfg.kaldi_mode:
        return state.prev_raw
    return chunk[:, -1]


def process_chunk_static(state: StreamState, chunk: torch.Tensor,
                         cfg: FeatureConfig, fill: int
                         ) -> tuple[StreamState, torch.Tensor]:
    """Gather-free streaming step for a statically known buffer ``fill``
    (:func:`next_fill` of the chunk-length history).

    The step is hop-aligned slices and the same kernels as one-shot
    extraction: the fused signal kernel when ``use_pallas + gemm_dft +
    fused_framing`` are on (and ``use_energy`` off), else frames and
    ``features.spectro_pipeline`` (the staged kernels under ``use_pallas``).

    Returns ``(state', feats [B, n_new, D])``; every output frame is valid
    (n_new is known), so there is no mask.
    """
    _check_streamable(cfg)
    B, C = chunk.shape
    fl, hop = cfg.frame_length, cfg.hop_length
    cap = fl - 1
    if not 0 <= fill <= cap:
        raise ValueError(f"fill {fill} outside [0, {cap}]")

    y = _preemphasized(state, chunk, cfg)
    data = torch.cat([state.buf[:, cap - fill:], y], dim=-1)
    total = fill + C
    n_new = max(0, 1 + (total - fl) // hop)

    if n_new == 0:
        feats = data.new_zeros(B, 0, cfg.feature_dim, dtype=torch.float32)
    elif cfg.use_pallas and cfg.gemm_dft and cfg.fused_framing \
            and not cfg.use_energy:
        # the signal kernel's tile and sum order are fixed, so a frame's
        # bits do not depend on the chunk plan (the reference pins its v4
        # layout for the same reason)
        feats = signal_kernel.signal_features(
            data.to(torch.float32).contiguous(), n_new, cfg)
        if cfg.plp_order > 0:
            feats = plp.plp_from_energies(feats, cfg)
    else:
        frames = framing.frames_from_buffer(data, n_new, fl, hop)
        frames = framing.condition_frames(frames, cfg)
        feats = features.spectro_pipeline(
            frames, torch.ones(B, n_new, dtype=torch.bool,
                               device=data.device), cfg)
    if cfg.out_dtype != "float32":
        feats = feats.to(getattr(torch, cfg.out_dtype))

    fill_out = total - n_new * hop          # == next_fill(fill, C)
    leftover = data[:, n_new * hop:]        # [B, fill_out]
    new_buf = torch.cat([data.new_zeros(B, cap - fill_out), leftover],
                        dim=-1)
    new_state = StreamState(
        buf=new_buf,
        fill=torch.full((B,), fill_out, dtype=torch.int32,
                        device=data.device),
        prev_raw=_next_prev_raw(state, chunk, cfg),
    )
    return new_state, feats


@functools.lru_cache(maxsize=None)
def make_stream_fn_static(cfg: FeatureConfig, fill: int):
    """(state, chunk) -> (state', feats) for ``cfg`` at a known ``fill``."""
    return functools.partial(process_chunk_static, cfg=cfg, fill=fill)


def process_chunk(state: StreamState, chunk: torch.Tensor,
                  cfg: FeatureConfig
                  ) -> tuple[StreamState, tuple[torch.Tensor, torch.Tensor]]:
    """One streaming step with a per-row fill: [B, C] samples ->
    (state', (features [B, F_max, D], mask [B, F_max])), with
    F_max = :func:`max_frames_per_chunk`. Frames are gathered by index
    and go through ``features.spectro_pipeline``.

    The fallback for heterogeneous per-row schedules; a driver that knows
    its chunk sizes should use :func:`process_chunk_static`,
    :class:`StreamingFrontend` or :func:`scan_chunks_static`.
    """
    _check_streamable(cfg)
    B, C = chunk.shape
    fl, hop = cfg.frame_length, cfg.hop_length
    cap = fl - 1
    dev = chunk.device

    y = _preemphasized(state, chunk, cfg)
    data = torch.cat([state.buf, y], dim=-1)             # [B, cap + C]
    total = state.fill + C                               # [B] valid samples
    n_new = torch.clamp(1 + (total - fl) // hop, min=0)  # frames this step

    F = max_frames_per_chunk(C, cfg)
    # frame j starts at (cap - fill) + j*hop inside `data`
    starts = (cap - state.fill.long())[:, None] \
        + hop * torch.arange(F, device=dev)[None, :]
    idx = starts[:, :, None] + torch.arange(fl, device=dev)[None, None, :]
    idx = torch.clamp(idx, 0, cap + C - 1)
    frames = torch.gather(data, 1, idx.reshape(B, F * fl)).reshape(B, F, fl)
    mask = torch.arange(F, device=dev)[None, :] < n_new[:, None]

    frames = framing.condition_frames(frames, cfg)
    feats = features.spectro_pipeline(frames, mask, cfg)

    new_state = StreamState(
        buf=data[:, C:],                                 # leftover is the tail
        fill=(total - n_new * hop).to(torch.int32),
        prev_raw=_next_prev_raw(state, chunk, cfg),
    )
    return new_state, (feats, mask)


@functools.lru_cache(maxsize=None)
def make_stream_fn(cfg: FeatureConfig):
    """(state, chunk) -> (state', (features, mask)) for ``cfg``."""
    return functools.partial(process_chunk, cfg=cfg)


def scan_chunks(state: StreamState, chunks: torch.Tensor,
                cfg: FeatureConfig
                ) -> tuple[StreamState, tuple[torch.Tensor, torch.Tensor]]:
    """Run [K, B, C] chunks through :func:`process_chunk`, step by step:
    (state', (features [K, B, F_max, D], masks [K, B, F_max])), the
    per-step outputs stacked as the reference's ``lax.scan`` stacks them.
    Prefer :func:`scan_chunks_static`, which returns packed frames."""
    feats, masks = [], []
    for chunk in chunks:
        state, (f, m) = process_chunk(state, chunk, cfg)
        feats.append(f)
        masks.append(m)
    return state, (torch.stack(feats), torch.stack(masks))


def fill_schedule(fill: int, chunk_lens, cfg: FeatureConfig) -> list[int]:
    """Fill value BEFORE each step (len(chunk_lens)+1 entries, last is the
    final fill) for a known chunk plan — all host ints."""
    fills = [fill]
    for c in chunk_lens:
        fills.append(next_fill(fills[-1], c, cfg))
    return fills


def _find_cycle(fills: list[int]) -> tuple[int, int]:
    """(warmup, period) of the fill sequence: fills[w + i] == fills[w + i %
    p] for all i. fill_{k+1} is a function of fill_k alone (equal chunk
    sizes), so the first repeated value starts the cycle."""
    seen: dict[int, int] = {}
    for k, f in enumerate(fills):
        if f in seen:
            return seen[f], k - seen[f]
        seen[f] = k
    return len(fills), 1      # no repeat within the plan: fully unrolled


def scan_chunks_static(state: StreamState, chunks: torch.Tensor,
                       cfg: FeatureConfig, fill: int = 0, *,
                       max_period: int = 16
                       ) -> tuple[StreamState, torch.Tensor]:
    """Static steps over [K, B, C] chunks -> (state', feats [B, F, D]),
    every output frame valid and packed along the frame axis.

    The fill sequence of equal chunks is eventually periodic with period
    hop/gcd(C, hop). The reference compiles one program per fill of the
    cycle; a Python loop needs no cycle, but keeps the reference's limit on
    the period (``max_period``) so that the two accept the same plans."""
    K, B, C = chunks.shape
    fills = fill_schedule(fill, [C] * K, cfg)
    _, p = _find_cycle(fills[:-1] or [fill])
    if p > max_period:
        raise ValueError(
            f"chunk size {C} gives a fill cycle of period {p} (> "
            f"{max_period}); use a hop-multiple chunk size or the dynamic "
            f"scan_chunks")
    parts = []
    for chunk, f in zip(chunks, fills):
        state, feats = process_chunk_static(state, chunk, cfg, f)
        if feats.shape[1]:
            parts.append(feats)
    if not parts:
        return state, chunks.new_zeros(B, 0, cfg.feature_dim,
                                       dtype=torch.float32)
    return state, torch.cat(parts, dim=1)


@functools.lru_cache(maxsize=None)
def make_scan_fn(cfg: FeatureConfig, fill: int = 0):
    """(state, chunks [K, B, C]) -> (state', feats [B, F, D]) for ``cfg``
    from a known starting ``fill``."""
    return functools.partial(scan_chunks_static, cfg=cfg, fill=fill)


def _as_samples(signal, device) -> torch.Tensor:
    """float32 samples on ``device`` (``features.placed``)."""
    return features.placed(signal, device).to(torch.float32)


def extract_scan(signal, cfg: FeatureConfig = MFCC13_HTK,
                 chunk_len: int = 4800, device=None) -> torch.Tensor:
    """One-shot extraction computed THROUGH the streaming step.

    The result comes from the very per-chunk steps any streaming consumer
    runs, so ``concat(streaming outputs) == extract_scan`` bit for bit for
    hop-aligned chunk plans on the card, whatever the plan's chunk sizes
    (on the CPU, BLAS may round some step shapes differently: about 1e-6).
    Use ``features.extract`` when you just want the fastest one-shot path.

    ``signal``: [N] or [B, N], numpy (sent to ``device``, default the card)
    or a tensor (computed where it lives). Returns features [(B,) F, D] with
    F = cfg.num_frames(N).
    """
    _check_streamable(cfg)
    x = _as_samples(signal, device)
    single = x.dim() == 1
    if single:
        x = x[None]
    B, N = x.shape
    K = N // chunk_len
    state = init_state(B, cfg, x.dtype, x.device)
    parts = []
    if K:
        chunks = x[:, : K * chunk_len].reshape(B, K, chunk_len).movedim(1, 0)
        state, feats = make_scan_fn(cfg, 0)(state, chunks)
        parts.append(feats)
    rem = N - K * chunk_len
    if rem:
        fill = fill_schedule(0, [chunk_len] * K, cfg)[-1]
        _, tail = make_stream_fn_static(cfg, fill)(state, x[:, K * chunk_len:])
        parts.append(tail)
    feats = torch.cat(parts, dim=1) if parts else \
        x.new_zeros(B, 0, cfg.feature_dim)
    return feats[0] if single else feats


class StreamingFrontend:
    """Object-style wrapper over the functional API.

    >>> fe = StreamingFrontend(MFCC13_HTK, batch_size=1, device="cuda")
    >>> for chunk in chunks:                     # [B, C] samples
    ...     feats, mask = fe.process(chunk)      # [B, n_new, D], [B, n_new]

    The wrapper knows each chunk's length, so it tracks the buffer fill as
    a host int and runs the gather-free static step
    (:func:`process_chunk_static`): every returned frame is valid and the
    mask is all True (kept for symmetry with the dynamic step).

    ``fe.state`` is a plain :class:`StreamState` of tensors, which
    :func:`save_state`/:func:`load_state` write and read; assigning to it
    re-syncs the host fill from the state.
    """

    def __init__(self, cfg: FeatureConfig = MFCC13_HTK, batch_size: int = 1,
                 device=None):
        _check_streamable(cfg)
        self.cfg = cfg
        self.device = features.default_device(device)
        self.state = init_state(batch_size, cfg, device=self.device)

    @property
    def state(self) -> StreamState:
        return self._state

    @state.setter
    def state(self, s: StreamState) -> None:
        fills = torch.unique(s.fill.cpu())
        if fills.numel() != 1:
            raise ValueError(
                "StreamingFrontend batches share one chunk schedule, so "
                f"all per-stream fills must agree; got {fills.tolist()}. "
                "Use the functional process_chunk API for heterogeneous "
                "streams.")
        self._state = s
        self._fill = int(fills[0])

    def process(self, chunk) -> tuple[torch.Tensor, torch.Tensor]:
        chunk = _as_samples(chunk, self.device)
        if chunk.dim() == 1:
            chunk = chunk[None]
        fn = make_stream_fn_static(self.cfg, self._fill)
        self._state, feats = fn(self._state, chunk)
        self._fill = next_fill(self._fill, chunk.shape[-1], self.cfg)
        mask = torch.ones(feats.shape[:2], dtype=torch.bool,
                          device=feats.device)
        return feats, mask

    def reset(self) -> None:
        b = self._state.buf.shape[0]
        self.state = init_state(b, self.cfg, device=self.device)

    def reset_rows(self, rows) -> None:
        """Recycle the given batch slots (an utterance ended, a new stream
        takes the row) WITHOUT touching the other rows or the shared chunk
        schedule: the slot's carry and pre-emphasis state are zeroed while
        the shared ``fill`` clock keeps running, so the slot behaves as a
        stream that carried zeros (silence) from the global start. Its
        later features equal :func:`extract_scan` of (zeros-prefix ++ new
        samples) under the same chunk plan; the other rows keep their
        bits (the zeroing is a per-row ``where``)."""
        self._state = StreamState(
            buf=zero_rows(self._state.buf, rows),
            fill=self._state.fill,            # shared schedule clock
            prev_raw=zero_rows(self._state.prev_raw, rows),
        )


# ---------------------------------------------------------------------------
# Online deltas: the streaming twin of features.deltas. Delta_t needs frames
# t-w..t+w, so the stream emits with a fixed lookahead of w frames; the start
# edge replicates as the offline operator does, and flush() finishes the
# last w frames with end replication. Two chained stages give delta-deltas.
# The frames seen so far are a host int, so every step is static slices.
# ---------------------------------------------------------------------------

def init_delta_state(batch_size: int, dim: int, window: int = 2,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Delta carry: the last 2*window base frames [B, 2w, D]."""
    return torch.zeros(batch_size, 2 * window, dim, dtype=dtype,
                       device=features.default_device(device))


def _delta_minus(work: torch.Tensor, i: int, F: int, z0: int,
                 window: int) -> torch.Tensor:
    """work[p - i] for the emitted p, with start-edge replication: work
    positions below z0 (the first real frame) read work[:, z0]."""
    m_lo = window - i
    if m_lo >= z0:
        return work[:, m_lo: m_lo + F]
    k = min(z0 - m_lo, F)
    first = work[:, z0: z0 + 1].expand(work.shape[0], k, work.shape[2])
    return torch.cat([first, work[:, z0: z0 + F - k]], dim=1)


def streaming_delta_step(carry: torch.Tensor, feats: torch.Tensor, *,
                         window: int = 2, n_seen: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One online-delta step: ``feats`` [B, F, D] new base frames ->
    (carry', deltas [B, n_emit, D]), n_emit = F once the stream has flowed
    past the ``window``-frame lookahead (F - window on the first chunks).
    ``n_seen``: base frames BEFORE this chunk, a host int."""
    B, F, D = feats.shape
    w = window
    work = torch.cat([carry, feats], dim=1)                 # [B, 2w + F, D]
    n_emit = min(F, max(0, n_seen + F - w))
    new_carry = work[:, -2 * w:]
    if n_emit == 0:
        return new_carry, feats.new_zeros(B, 0, D)
    z0 = max(2 * w - n_seen, 0)          # work index of global frame 0
    t0 = F - n_emit                      # first emitted t within [0, F)
    denom = 2.0 * sum(i * i for i in range(1, w + 1))
    out = feats.new_zeros(B, n_emit, D)
    for i in range(1, w + 1):
        plus = work[:, w + t0 + i: w + t0 + i + n_emit]
        minus = _delta_minus(work, i, F, z0, w)[:, t0:]
        out = out + i * (plus - minus)
    return new_carry, out / denom


def streaming_delta_flush(carry: torch.Tensor, *, window: int = 2,
                          n_seen: int = 0) -> torch.Tensor:
    """Finish the stream: the last min(window, n_seen) deltas, with the
    offline operator's end-edge replication."""
    B, _, D = carry.shape
    w = window
    n_emit = min(w, n_seen)
    if n_emit == 0:
        return carry.new_zeros(B, 0, D)
    z0 = max(2 * w - n_seen, 0)
    t0 = w - n_emit                      # emitted p in [w + t0, 2w)
    denom = 2.0 * sum(i * i for i in range(1, w + 1))
    last = carry[:, -1:]                 # the stream's last frame
    out = carry.new_zeros(B, n_emit, D)
    for i in range(1, w + 1):
        # p + i, clipped at the final frame 2w - 1
        n_clip = min(n_emit, i)
        plus = torch.cat([carry[:, w + t0 + i: 2 * w],
                          last.expand(B, n_clip, D)], dim=1)[:, :n_emit]
        minus = _delta_minus(carry, i, w, z0, w)[:, t0: t0 + n_emit]
        out = out + i * (plus - minus)
    return out / denom


class StreamingDeltas:
    """Online deltas, chained after a :class:`StreamingFrontend` (and again
    for delta-deltas): emits with a ``window``-frame lookahead; call
    :meth:`flush` at the end of the stream. ``n_seen``, the frames seen, is
    a host int shared by the batch."""

    def __init__(self, dim: int, window: int = 2, batch_size: int = 1,
                 device=None):
        self.window = window
        self.n_seen = 0
        self.carry = init_delta_state(batch_size, dim, window, device=device)

    def _seen(self) -> int:
        # past 2w frames the start edge no longer shows
        return min(self.n_seen, 2 * self.window)

    def process(self, feats: torch.Tensor) -> torch.Tensor:
        self.carry, out = streaming_delta_step(
            self.carry, feats.to(torch.float32), window=self.window,
            n_seen=self._seen())
        self.n_seen += feats.shape[1]
        return out

    def flush(self) -> torch.Tensor:
        return streaming_delta_flush(self.carry, window=self.window,
                                     n_seen=self._seen())

    def reset_rows(self, rows) -> None:
        """Slot recycle: zero the rows' carry (the shared ``n_seen`` clock
        keeps running). The slot's next ``window`` rows regress against the
        zeroed carry; from then on they are the offline deltas of the
        slot's own rows."""
        self.carry = zero_rows(self.carry, rows)


class RunningCMVN(NamedTuple):
    """Causal running CMVN statistics (Welford), the streaming stand-in for
    utterance-global CMVN."""
    count: torch.Tensor  # [B]
    mean: torch.Tensor   # [B, D]
    m2: torch.Tensor     # [B, D] sum of squared deviations


def init_cmvn(batch_size: int, dim: int, dtype=torch.float32,
              device=None) -> RunningCMVN:
    device = features.default_device(device)
    return RunningCMVN(
        count=torch.zeros(batch_size, dtype=dtype, device=device),
        mean=torch.zeros(batch_size, dim, dtype=dtype, device=device),
        m2=torch.zeros(batch_size, dim, dtype=dtype, device=device))


def streaming_cmvn(stats: RunningCMVN, feats: torch.Tensor,
                   mask: torch.Tensor, norm_vars: bool = False
                   ) -> tuple[RunningCMVN, torch.Tensor]:
    """Update the Welford statistics with this chunk's valid frames and
    return the chunk normalized by the UPDATED statistics."""
    m = mask[..., None].to(feats.dtype)
    n_b = m.sum(dim=-2)[..., 0]                             # [B]
    sum_b = (feats * m).sum(dim=-2)                         # [B, D]
    new_count = stats.count + n_b
    safe = torch.clamp(new_count, min=1.0)
    mean_b = sum_b / torch.clamp(n_b, min=1.0)[..., None]
    delta = mean_b - stats.mean
    new_mean = stats.mean + delta * (n_b / safe)[..., None]
    dev = (feats - new_mean[:, None, :]) * m
    chunk_m2 = (dev * dev).sum(dim=-2)
    new_m2 = stats.m2 + chunk_m2 + \
        (delta * delta) * (stats.count * n_b / safe)[..., None]
    out = feats - new_mean[:, None, :]
    if norm_vars:
        var = new_m2 / safe[..., None]
        out = out / torch.sqrt(var + 1e-10)[:, None, :]
    return RunningCMVN(new_count, new_mean, new_m2), out


class StreamingSlidingCMVN:
    """Causal sliding-window CMVN online (Kaldi ``apply-cmvn-sliding``):
    each frame is normalized by the mean (and variance) of the trailing
    ``window`` frames, and the first frames wait until ``min_window``
    frames exist. The online twin of ``features.sliding_cmvn(center=
    False)``, equal to it up to f32 summation order once ``min_window``
    frames are buffered: every window is finite and trailing.

    State: a [B, window, D] ring of raw rows on the device, a host frame
    counter and the start-up buffer. :meth:`process` emits nothing until
    ``min_window`` frames arrived, then the backlog, then chunk for chunk;
    :meth:`flush` drains a stream shorter than ``min_window`` through the
    offline operator."""

    def __init__(self, dim: int, batch_size: int = 1, window: int = 600,
                 min_window: int = 100, norm_vars: bool = False,
                 device=None):
        if window < 1 or min_window < 1:
            raise ValueError("window and min_window must be >= 1")
        if min_window > window:
            # the offline operator borrows future context only for frames
            # t < window, and the first emission here applies the
            # min_window end to every frame (Kaldi asserts the same)
            raise ValueError(f"min_window {min_window} > window {window}")
        self.dim, self.window = dim, window
        self.min_window, self.norm_vars = min_window, norm_vars
        device = features.default_device(device)
        self.carry = torch.zeros(batch_size, window, dim, device=device)
        self.n_seen = 0
        self._pending = torch.zeros(batch_size, 0, dim, device=device)

    def process(self, rows: torch.Tensor) -> torch.Tensor:
        """[B, n, D] rows -> [B, m, D] normalized rows (m = n in steady
        state; 0 while the first min_window frames are buffered)."""
        rows = rows.to(torch.float32)
        if self.n_seen == 0:
            self._pending = torch.cat([self._pending, rows], dim=1)
            if self._pending.shape[1] < self.min_window:
                return rows[:, :0]
            rows, self._pending = self._pending, self._pending[:, :0]
        n = rows.shape[1]
        if n == 0:
            return rows
        out, self.carry = sliding_cmvn_step(
            self.carry, rows, self.n_seen, self.min_window, self.norm_vars)
        self.n_seen += n
        return out

    def flush(self) -> torch.Tensor:
        """Drain a short stream (fewer than min_window frames in all): the
        offline clamps normalize every frame by the whole stream."""
        p, self._pending = self._pending, self._pending[:, :0]
        if p.shape[1] == 0:
            return p
        return features.sliding_cmvn(p, None, window=self.window,
                                     min_window=self.min_window,
                                     center=False, norm_vars=self.norm_vars)

    def state(self) -> dict:
        return {"carry": self.carry, "n_seen": self.n_seen,
                "pending": self._pending}

    def set_state(self, s: dict) -> None:
        self.carry = s["carry"]
        self.n_seen = int(s["n_seen"])
        self._pending = s["pending"]

    def reset_rows(self, rows) -> None:
        """Slot recycle: zero the rows' ring (the batch emits in lockstep,
        so a fresh slot gets no start-up delay of its own): its first
        ``window`` rows are normalized against a partly zero window."""
        self.carry = zero_rows(self.carry, rows)
        if self._pending.shape[1]:
            self._pending = zero_rows(self._pending, rows)


def sliding_cmvn_step(carry: torch.Tensor, rows: torch.Tensor, n_prev: int,
                      min_window: int, norm_vars: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One sliding-CMVN step: the ring ``carry`` [B, w, D] of the last w
    rows (zeros before the stream's start) and ``n`` new ``rows`` after
    ``n_prev`` earlier ones -> (normalized rows [B, n, D], ring'). One
    cumulative sum over ring and rows, pre-centred by their mean (which
    cancels from x - mean exactly); the window ends are shifts of the row
    index but for the start-up borrow and the short-ring floor, one row
    each."""
    w, n = carry.shape[1], rows.shape[1]
    data = torch.cat([carry, rows], dim=1)                  # [B, w+n, D]
    real = min(n_prev, w) + n            # the ring's real rows, and the new
    g = data.sum(dim=1, keepdim=True) / real
    k = torch.arange(w + n, device=data.device)[None, :, None]
    x = (data - g) * (k >= w + n - real).to(data.dtype)

    t_abs = n_prev + torch.arange(n, device=data.device)
    ws = torch.clamp(t_abs - w, min=0)
    we = torch.clamp(t_abs + 1, min=min_window)
    cnt = (we - ws).to(x.dtype)[None, :, None]
    upper_mask = (t_abs + 1 < min_window)[None, :, None]
    lower_mask = (t_abs < w)[None, :, None]
    borrow = min(max(min_window - n_prev + w, 0), w + n)
    floor = min(max(w - n_prev, 0), w + n)

    def winmean(v):
        cs = features._cumsum0(v)                           # [B, w+n+1, D]
        upper = torch.where(upper_mask, cs[:, borrow:borrow + 1],
                            cs[:, w + 1:])                  # cs[j + w + 1]
        lower = torch.where(lower_mask, cs[:, floor:floor + 1],
                            cs[:, :n])                      # cs[j]
        return (upper - lower) / cnt

    mean = winmean(x)
    out = x[:, w:] - mean
    if norm_vars:
        var = torch.clamp(winmean(x * x) - mean * mean, min=1e-10)
        out = out / torch.sqrt(var)
    return out, data[:, n:]


class OnlineCmvn:
    """Kaldi online2 ``OnlineCmvn``: trailing-window normalization smoothed
    with speaker and global priors while the window is short, so frame 0
    is emitted at once (the priors stand in for
    :class:`StreamingSlidingCMVN`'s ``min_window`` delay).

    The online twin of ``features.online_cmvn``, equal to it for any chunk
    plan up to f32 summation order, with Kaldi's ``Freeze()``
    (:meth:`freeze`). State: a [B, window, D] ring, a per-row frame counter
    and the frozen statistics, all tensors, so :meth:`state` /
    :meth:`set_state` go through ``save_state`` / ``load_state``."""

    def __init__(self, dim: int, batch_size: int = 1, window: int = 600,
                 speaker_stats=None, global_stats=None,
                 speaker_frames: int = 600, global_frames: int = 200,
                 norm_vars: bool = False, device=None):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.dim, self.window, self.norm_vars = dim, window, norm_vars
        self.speaker_frames, self.global_frames = speaker_frames, \
            global_frames

        def unpack(st):
            if st is None:
                return 0.0, np.zeros(dim), np.zeros(dim)
            if np.asarray(st.sum).shape != (dim,):
                raise ValueError(f"prior stats dim "
                                 f"{np.asarray(st.sum).shape} != ({dim},)")
            return float(st.count), np.asarray(st.sum, np.float64), \
                np.asarray(st.sumsq, np.float64)

        self._cs, self._ssum, self._ssq = unpack(speaker_stats)
        self._cg, self._gsum, self._gsq = unpack(global_stats)
        device = features.default_device(device)
        self.carry = torch.zeros(batch_size, window, dim, device=device)
        # a frame counter PER ROW: a recycled slot restarts at 0, so its
        # first frames are smoothed against the priors again (reset_rows)
        self.n_seen = torch.zeros(batch_size, dtype=torch.int32,
                                  device=device)
        self.frozen = False
        self._fmean = torch.zeros(batch_size, 1, dim, device=device)
        self._fscale = torch.ones(batch_size, 1, dim, device=device)

    def _smoothed(self, seg: np.ndarray):
        """float64 smoothed (mean, var) of one row's trailing ``seg``
        frames (the golden's arithmetic)."""
        c = float(len(seg))
        tot_sum, tot_sq = seg.sum(axis=0), (seg * seg).sum(axis=0)
        ks = min(max(self.window - c, 0.0), float(self.speaker_frames),
                 self._cs)
        if ks > 0:
            tot_sum = tot_sum + (ks / self._cs) * self._ssum
            tot_sq = tot_sq + (ks / self._cs) * self._ssq
        kg = min(max(self.window - c - ks, 0.0),
                 float(self.global_frames), self._cg)
        if kg > 0:
            tot_sum = tot_sum + (kg / self._cg) * self._gsum
            tot_sq = tot_sq + (kg / self._cg) * self._gsq
        n = c + ks + kg
        mean = tot_sum / n
        return mean, np.maximum(tot_sq / n - mean * mean, 1e-10)

    def freeze(self) -> None:
        """Pin the smoothed statistics at the CURRENT frame (Kaldi
        ``OnlineCmvn::Freeze``): later :meth:`process` calls normalize
        against them and leave the window alone."""
        n_rows = self.n_seen.cpu().numpy()
        if n_rows.max() == 0 and self._cs == 0.0 and self._cg == 0.0:
            raise ValueError("freeze() before any frame needs a speaker "
                             "or global prior to freeze")
        ring = self.carry.cpu().numpy().astype(np.float64)
        means, scales = [], []
        for b in range(ring.shape[0]):
            k = int(min(n_rows[b], self.window))
            mean, var = self._smoothed(ring[b, self.window - k:])
            means.append(mean)
            scales.append(1.0 / np.sqrt(var) if self.norm_vars
                          else np.ones_like(var))
        dev = self.carry.device
        self._fmean = torch.as_tensor(np.stack(means)[:, None],
                                      dtype=torch.float32, device=dev)
        self._fscale = torch.as_tensor(np.stack(scales)[:, None],
                                       dtype=torch.float32, device=dev)
        self.frozen = True

    def process(self, rows: torch.Tensor) -> torch.Tensor:
        """[B, n, D] rows -> [B, n, D] normalized rows (no delay)."""
        rows = rows.to(torch.float32)
        if rows.shape[1] == 0:
            return rows
        if self.frozen:
            return (rows - self._fmean) * self._fscale

        def moments(total, count):
            return torch.as_tensor(total / max(count, 1.0),
                                   dtype=torch.float32, device=rows.device)

        out, self.carry = online_cmvn_step(
            self.carry, rows, self.n_seen, self.norm_vars,
            (self._cs, self.speaker_frames, moments(self._ssum, self._cs),
             moments(self._ssq, self._cs)),
            (self._cg, self.global_frames, moments(self._gsum, self._cg),
             moments(self._gsq, self._cg)))
        self.n_seen = self.n_seen + rows.shape[1]
        return out

    def state(self) -> dict:
        return {"carry": self.carry, "n_seen": self.n_seen,
                "frozen": self.frozen, "fmean": self._fmean,
                "fscale": self._fscale}

    def set_state(self, s: dict) -> None:
        self.carry = s["carry"]
        n = torch.as_tensor(s["n_seen"])
        # a checkpoint of one shared frame count
        self.n_seen = (n.expand(self.carry.shape[0]) if n.dim() == 0 else n
                       ).to(device=self.carry.device, dtype=torch.int32)
        self.frozen = bool(s["frozen"])
        self._fmean = s["fmean"]
        self._fscale = s["fscale"]

    def reset_rows(self, rows) -> None:
        """Slot recycle: zero the rows' ring AND frame counter, so the
        slot's next frames are smoothed against the priors as a fresh Kaldi
        OnlineCmvn's are. A :meth:`freeze` pin stays for every row; the
        other rows keep their bits."""
        self.carry = zero_rows(self.carry, rows)
        self.n_seen = zero_rows(self.n_seen, rows)

    def reset(self) -> None:
        """Restart every row: clear the window, the counters and any
        :meth:`freeze` pin; the priors (model data) stay."""
        self.carry = torch.zeros_like(self.carry)
        self.n_seen = torch.zeros_like(self.n_seen)
        self.frozen = False
        self._fmean = torch.zeros_like(self._fmean)
        self._fscale = torch.ones_like(self._fscale)


def online_cmvn_step(carry: torch.Tensor, rows: torch.Tensor,
                     n_prev: torch.Tensor, norm_vars: bool, speaker: tuple,
                     glob: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """One online-CMVN step over the ring ``carry`` [B, w, D] and ``n`` new
    ``rows``, each row after its own ``n_prev`` [B] earlier frames ->
    (normalized rows, ring'). Kaldi's trailing window [t+1-w, t+1) (one
    frame narrower than apply-cmvn-sliding's), smoothed by the priors,
    each ``(count, frames, mean, mean square)``. The same pre-centred
    cumulative sum as :func:`sliding_cmvn_step`, the short-ring floor
    gathered per row."""
    w, n = carry.shape[1], rows.shape[1]
    B, D = rows.shape[0], rows.shape[2]
    dev = rows.device
    data = torch.cat([carry, rows], dim=1)                  # [B, w+n, D]
    n_prev = n_prev.to(torch.int64)
    nprev = torch.clamp(n_prev, max=w)[:, None, None]       # [B, 1, 1]
    g = data.sum(dim=1, keepdim=True) / (nprev + n).to(data.dtype)
    k = torch.arange(w + n, device=dev)[None, :, None]
    x = (data - g) * (k >= w - nprev).to(data.dtype)

    t_abs = n_prev[:, None] + torch.arange(n, device=dev)[None, :]  # [B, n]
    cnt = torch.clamp(t_abs + 1, max=w).to(x.dtype)[..., None]
    (cs, s_frames, sm, smsq), (cg, g_frames, gm, gmsq) = speaker, glob
    ks, kg = features._prior_counts(cnt, w, cs, s_frames, cg, g_frames)
    # the priors re-centred by the same g
    sm_c, gm_c = sm - g, gm - g
    smsq_c = smsq - 2.0 * g * sm + g * g
    gmsq_c = gmsq - 2.0 * g * gm + g * g
    lower_mask = (t_abs + 1 < w)[..., None]                 # [B, n, 1]
    fidx = torch.clamp(w - n_prev, 0, w + n)[:, None, None].expand(B, 1, D)

    def winsum(v):
        cums = features._cumsum0(v)                         # [B, w+n+1, D]
        upper = cums[:, w + 1:]                             # cs[j + w + 1]
        lower = torch.where(lower_mask, torch.gather(cums, 1, fidx),
                            cums[:, 1:n + 1])               # cs[j + 1]
        return upper - lower

    tot = cnt + ks + kg
    mean = (winsum(x) + ks * sm_c + kg * gm_c) / tot
    out = x[:, w:] - mean
    if norm_vars:
        e2 = (winsum(x * x) + ks * smsq_c + kg * gmsq_c) / tot
        var = torch.clamp(e2 - mean * mean, min=1e-10)
        out = out / torch.sqrt(var)
    return out, data[:, n:]


class StreamingPipeline:
    """The online config-3 pipeline: front-end -> online deltas (one
    :class:`StreamingDeltas` stage per ``cfg.delta_order``) -> optional
    CMVN -> optional transform, behind one ``process()`` / ``flush()``
    pair.

    Give it a full config (``KALDI39`` by default): the front-end runs the
    base 13-dim pipeline, the delta stages add their columns with a
    ``delta_order * delta_window``-frame lookahead, and FIFOs align
    complete [base | delta | delta-delta | ...] rows in stream order. With
    the kernel flags on the card the base columns are the bits of
    :func:`extract_scan` for every hop-aligned chunk plan (the plain path's
    cuFFT and cuBLAS, and the CPU's BLAS, may round a row otherwise with
    the step's row count: about 1e-6); the delta columns are the offline
    ``features.deltas`` of those rows, the same elementwise operations on
    the same values.

    CMVN: ``cfg.cmvn`` "mean" / "meanvar" normalize by causal running
    statistics (:func:`streaming_cmvn`), which converge to the utterance's
    but differ early on; "sliding" / "sliding-meanvar" by
    :class:`StreamingSlidingCMVN`, whose finite trailing windows match the
    offline ``features.extract`` of the same config up to f32 summation
    order, after a ``cfg.cmvn_min_window``-frame delay at the start.
    ``online_cmvn=`` an :class:`OnlineCmvn` (with ``cfg.cmvn="none"``)
    applies Kaldi's prior-smoothed normalization at the same point.

    ``transform=`` a [Do, D] (linear) or [Do, D + 1] (affine, bias last)
    matrix over the D = ``cfg.feature_dim`` columns (Kaldi online2's
    OnlineTransform, an LDA/MLLT or fMLLR matrix) is applied to the rows
    after CMVN, in fp32 whatever the caller's TF32 setting.

    ``pitch=True`` (or a ``pitch.PitchConfig``) appends Kaldi-style pitch
    rows, [POV, mean-subtracted log-pitch, delta-log-pitch], from
    ``pitch.StreamingPitchFeatures`` with ``pitch_lookahead`` frames of
    Viterbi lookahead: the spectral rows (after CMVN and the transform)
    and the pitch rows are joined in stream order, and the flush drops the
    spectral rows past the pitch tracker's last frame (its window is
    longer), as the offline CLI truncates. ``input_rate=`` a rate other
    than ``cfg.sample_rate`` (a 48 kHz capture) puts a
    ``resampling.StreamingResampler`` ahead of both: the pipeline then sees
    the bits of the offline ``resampling.resample`` of the stream, and
    :meth:`flush` drains the resampler first.

    ``ivector=`` an :class:`ivector.IvectorExtractor` trained on the base
    features (13-dim for KALDI39, before CMVN) appends Kaldi online2's
    per-frame i-vectors as the last K columns, after pitch: a
    :class:`ivector.StreamingIvector` (``ivector_period``,
    ``ivector_scale``, ``ivector_max_count``) estimates them from the
    base rows, 1:1, and a FIFO aligns them with the delta lag and the
    pitch lookahead; the flush truncates them with the spectral and pitch
    rows. A recycled slot's i-vector restarts at the prior on its own
    boundary grid. The flush raises if a step met a precision matrix that
    is not positive definite. KALDI39 with pitch and a K=100 extractor
    gives Kaldi nnet3-online's 142-dim rows.

    The state is tensors and host ints: :meth:`state` / :meth:`set_state`
    go through :func:`save_state` / :func:`load_state`. Tensors live on
    ``device``, the card unless the caller passes ``device="cpu"``.
    """

    def __init__(self, cfg: FeatureConfig | None = None, batch_size: int = 1,
                 pitch=False, pitch_lookahead: int = 15,
                 input_rate: int | None = None,
                 online_cmvn: OnlineCmvn | None = None, transform=None,
                 ivector=None, ivector_period: int = 10,
                 ivector_scale: float = 0.1, ivector_max_count: float = 0.0,
                 device=None):
        cfg = KALDI39 if cfg is None else cfg
        if not cfg.deltas:
            raise ValueError("StreamingPipeline is the deltas+CMVN "
                             "composition; use StreamingFrontend for "
                             "base-feature configs")
        self.cfg = cfg
        self.device = features.default_device(device)
        self._input_rate = input_rate
        self._resampler = None
        if input_rate is not None and input_rate != cfg.sample_rate:
            self._resampler = resampling.StreamingResampler(
                input_rate, cfg.sample_rate, batch_size, self.device)
        base_cfg = dataclasses.replace(cfg, deltas=False, cmvn="none")
        self.frontend = StreamingFrontend(base_cfg, batch_size, self.device)
        dim = base_cfg.feature_dim
        # stage i's output is stage i+1's input and column block i+1
        self.stages = [StreamingDeltas(dim, cfg.delta_window, batch_size,
                                       self.device)
                       for _ in range(cfg.delta_order)]
        self.cmvn_stats = self._scmvn = None
        if cfg.cmvn.startswith("sliding"):
            if cfg.cmvn_center:
                raise ValueError(
                    "streaming sliding CMVN is causal; cmvn_center=True "
                    "needs future context — use offline extract()")
            self._scmvn = StreamingSlidingCMVN(
                cfg.feature_dim, batch_size, cfg.cmvn_window,
                cfg.cmvn_min_window, cfg.cmvn.endswith("meanvar"),
                self.device)
        elif cfg.cmvn != "none":
            self.cmvn_stats = init_cmvn(batch_size, cfg.feature_dim,
                                        device=self.device)
        self._ocmvn = online_cmvn
        if online_cmvn is not None:
            if cfg.cmvn != "none":
                raise ValueError("online_cmvn= replaces cfg.cmvn; set "
                                 f"cmvn='none' (got {cfg.cmvn!r})")
            if online_cmvn.dim != cfg.feature_dim:
                raise ValueError(
                    f"online_cmvn dim {online_cmvn.dim} != pipeline "
                    f"feature_dim {cfg.feature_dim}")
        self._stale: set[int] = set()     # rows reset_rows zeroes next
        # _fifos[0] holds base rows, _fifos[i] stage i-1's rows; the last
        # stage's rows are never queued: they drive the emission
        self._fifos = [torch.zeros(batch_size, 0, dim, device=self.device)
                       for _ in range(cfg.delta_order)]
        self._transform = None
        if transform is not None:
            t = torch.as_tensor(transform, dtype=torch.float32,
                                device=self.device)
            if t.dim() != 2 or t.shape[1] not in (cfg.feature_dim,
                                                  cfg.feature_dim + 1):
                raise ValueError(
                    f"transform {tuple(t.shape)} does not apply to "
                    f"{cfg.feature_dim}-dim rows (want [Do, "
                    f"{cfg.feature_dim}] or [Do, {cfg.feature_dim + 1}])")
            self._transform = t
        self._pitch = self._pitch_cfg = None
        self._pitch_lookahead = pitch_lookahead
        if pitch:
            self._pitch_cfg = (pitch if isinstance(pitch,
                                                   pitchmod.PitchConfig)
                               else pitchmod.config_for(base_cfg))
            self._pitch = pitchmod.StreamingPitchFeatures(
                self._pitch_cfg, batch_size, pitch_lookahead, self.device)
            # the spectral rows (transformed) and the pitch rows wait here
            # until both halves of a row are out
            self._main_fifo = torch.zeros(batch_size, 0,
                                          self._spectral_dim(),
                                          device=self.device)
            self._pfeat_fifo = torch.zeros(batch_size, 0, 3,
                                           device=self.device)
        self._ivector = None
        self._iv_args = (ivector_period, ivector_scale, ivector_max_count)
        if ivector is not None:
            if not isinstance(ivector, ivmod.IvectorExtractor):
                raise TypeError("ivector= wants an IvectorExtractor, got "
                                f"{type(ivector).__name__}")
            if ivector.ubm.dim != dim:
                raise ValueError(
                    f"ivector UBM dim {ivector.ubm.dim} != base feature "
                    f"dim {dim} (the extractor must be trained on the "
                    "pipeline's base features)")
            self._ivector = ivmod.StreamingIvector(
                ivector, batch_size, period=ivector_period,
                posterior_scale=ivector_scale, max_count=ivector_max_count,
                device=self.device)
            self._iv_fifo = torch.zeros(batch_size, 0, ivector.ivector_dim,
                                        device=self.device)

    def _spectral_dim(self) -> int:
        return self._transform.shape[0] if self._transform is not None \
            else self.cfg.feature_dim

    @property
    def out_dim(self) -> int:
        """The emitted rows' width: cfg.feature_dim, or the transform's
        output rows; 3 more with pitch, K more with i-vectors."""
        return (self._spectral_dim()
                + (3 if self._pitch is not None else 0)
                + (self._ivector.dim if self._ivector is not None else 0))

    def _emit(self, last_rows: torch.Tensor) -> torch.Tensor:
        """Pop n = last_rows rows off every FIFO and assemble the
        [base | delta | delta-delta | ...] block, normalized and
        transformed."""
        n = last_rows.shape[1]
        cols = []
        for i, fifo in enumerate(self._fifos):
            cols.append(fifo[:, :n])
            self._fifos[i] = fifo[:, n:]
        out = torch.cat(cols + [last_rows], dim=-1)
        if self.cmvn_stats is not None and n:
            self.cmvn_stats, out = streaming_cmvn(
                self.cmvn_stats, out,
                torch.ones(out.shape[:2], dtype=torch.bool,
                           device=out.device),
                norm_vars=self.cfg.cmvn == "meanvar")
        elif self._scmvn is not None:
            out = self._scmvn.process(out)
        elif self._ocmvn is not None and n:
            out = self._ocmvn.process(out)
        # a zero-row chunk is transformed too, to keep its width
        return self._apply_tf(out)

    def _apply_tf(self, out: torch.Tensor) -> torch.Tensor:
        """rows @ A^T (+ bias), in fp32 (the reference's HIGHEST)."""
        t = self._transform
        if t is None:
            return out
        d = out.shape[-1]
        y = features.matmul(out, t[:, :d].T)
        return y + t[:, d] if t.shape[1] == d + 1 else y

    def _join(self, main: torch.Tensor, prows: torch.Tensor) -> torch.Tensor:
        """Queue the spectral and the pitch rows; emit the rows both halves
        of which are out, [main | pov, log-pitch, delta-log-pitch]."""
        self._main_fifo = torch.cat([self._main_fifo, main], dim=1)
        self._pfeat_fifo = torch.cat([self._pfeat_fifo, prows], dim=1)
        n = min(self._main_fifo.shape[1], self._pfeat_fifo.shape[1])
        out_m, self._main_fifo = (self._main_fifo[:, :n],
                                  self._main_fifo[:, n:])
        out_p, self._pfeat_fifo = (self._pfeat_fifo[:, :n],
                                   self._pfeat_fifo[:, n:])
        return torch.cat([out_m, out_p], dim=-1)

    def process(self, chunk) -> torch.Tensor:
        """[B, C] (or [C]) raw samples at ``input_rate`` (default
        ``cfg.sample_rate``) -> [B, n, out_dim] complete rows (n lags the
        input by delta_order * delta_window frames, by the sliding CMVN's
        start-up delay and, with pitch, by the Viterbi lookahead)."""
        self._reset_stale()
        chunk = _as_samples(chunk, self.device)
        if chunk.dim() == 1:
            chunk = chunk[None]
        if self._resampler is not None:
            chunk = self._resampler.process(chunk)
        return self._process_native(chunk)

    def _process_native(self, chunk: torch.Tensor) -> torch.Tensor:
        """The step on samples at ``cfg.sample_rate``."""
        base, _ = self.frontend.process(chunk)
        rows = base
        self._fifos[0] = torch.cat([self._fifos[0], base], dim=1)
        if self._ivector is not None and base.shape[1]:
            self._iv_fifo = torch.cat(
                [self._iv_fifo, self._ivector.process(base)], dim=1)
        for i, stage in enumerate(self.stages):
            rows = stage.process(rows)
            if i + 1 < len(self.stages):
                self._fifos[i + 1] = torch.cat([self._fifos[i + 1], rows],
                                               dim=1)
        out = self._emit(rows)
        if self._pitch is not None:
            out = self._join(out, self._pitch.process(chunk))
        return self._append_ivector(out)

    def _append_ivector(self, out: torch.Tensor) -> torch.Tensor:
        """Pop as many queued i-vector rows as the main block emitted and
        append them as the last columns."""
        if self._ivector is None:
            return out
        n = out.shape[1]
        iv, self._iv_fifo = self._iv_fifo[:, :n], self._iv_fifo[:, n:]
        return torch.cat([out, iv], dim=-1)

    def flush(self) -> torch.Tensor:
        """End of stream: drain the resampler's filter tail, then the delta
        lookaheads with the offline edge replication, the sliding CMVN's
        start-up buffer and the pitch tracker's lookahead."""
        self._reset_stale()
        pre = None
        if self._resampler is not None:
            tail = self._resampler.flush()
            if tail.shape[1]:
                pre = self._process_native(tail)
        pending = None
        for i, stage in enumerate(self.stages):
            rows = stage.flush() if pending is None else torch.cat(
                [stage.process(pending), stage.flush()], dim=1)
            if i + 1 < len(self.stages):
                self._fifos[i + 1] = torch.cat([self._fifos[i + 1], rows],
                                               dim=1)
            pending = rows
        out = self._emit(pending)
        if self._scmvn is not None:
            # a short stream emits every row here: transform them too
            out = torch.cat([out, self._apply_tf(self._scmvn.flush())],
                            dim=1)
        if any(f.shape[1] for f in self._fifos):
            raise RuntimeError("rows left in the alignment FIFOs after flush")
        if self._pitch is not None:
            out = self._join(out, self._pitch.flush())
            if self._pfeat_fifo.shape[1]:
                raise RuntimeError("pitch rows left after flush")
            # the pitch window is longer than the spectral frame, so the
            # tracker decides fewer frames: the spectral tail is dropped
            self._main_fifo = self._main_fifo[:, :0]
        out = self._append_ivector(out)
        if self._ivector is not None:
            if self._pitch is None and self._iv_fifo.shape[1]:
                raise RuntimeError("i-vector rows left after flush")
            # with pitch, the dropped spectral tail's i-vector rows go too
            self._iv_fifo = self._iv_fifo[:, :0]
            self._ivector.check()
        return out if pre is None else torch.cat([pre, out], dim=1)

    def reset(self) -> None:
        """A fresh stream in every row; ``online_cmvn``'s priors, the
        transform, the pitch options, the i-vector extractor and the input
        rate stay."""
        if self._ocmvn is not None:
            self._ocmvn.reset()
        iv_period, iv_scale, iv_max_count = self._iv_args
        self.__init__(self.cfg, self._fifos[0].shape[0],
                      pitch=self._pitch_cfg or False,
                      pitch_lookahead=self._pitch_lookahead,
                      input_rate=self._input_rate,
                      online_cmvn=self._ocmvn, transform=self._transform,
                      ivector=(self._ivector.extractor
                               if self._ivector is not None else None),
                      ivector_period=iv_period, ivector_scale=iv_scale,
                      ivector_max_count=iv_max_count, device=self.device)

    @property
    def warmup_rows(self) -> int:
        """Rows to discard for a slot after :meth:`reset_rows` before its
        output is exact: 2 * delta_order * delta_window for the delta
        stages (the zeroed FIFO rows and the zeroed-carry regression), plus
        the CMVN window while zeros wash out of it. While the sliding CMVN
        still holds back its start-up rows, those rows predate a reset made
        now and come out after it, so they count too (the reference leaves
        them out, and a slot recycled in a pipeline's first min_window
        frames then shows rows that are not yet exact). Pitch adds the
        Viterbi restart and its delta chain, counted twice like the deltas:
        2 * (pitch_lookahead + 2 * delta_window). A zeroed resampler carry
        is the zeros-prefix history, and adds nothing; so do i-vectors, whose
        queued rows are zeroed and whose estimate restarts at the prior."""
        w = 2 * self.cfg.delta_order * self.cfg.delta_window
        if self._scmvn is not None:
            w += self._scmvn.window + self._scmvn._pending.shape[1]
        elif self._ocmvn is not None:
            w += self._ocmvn.window
        if self._pitch is not None:
            w += 2 * (self._pitch_lookahead
                      + 2 * self._pitch_cfg.delta_window)
        return w

    def reset_rows(self, rows) -> None:
        """Recycle the given batch slots for new streams without touching
        the other rows, whose outputs keep their bits, or the shared chunk
        schedule: the front-end slot restarts as a stream that carried
        silence, the delta carries and queued FIFO rows are zeroed
        (:attr:`warmup_rows`), running and sliding CMVN statistics restart,
        :class:`OnlineCmvn` restarts the rows against its priors, the
        resampler's carry is zeroed, the pitch tracker restarts from its
        initial condition (its queued rows zeroed), and the i-vector
        estimate restarts at the prior on the slot's own boundary grid
        (its queued rows zeroed).

        The rows are zeroed at the next :meth:`process`, :meth:`flush` or
        :meth:`state`, all rows reset since in one pass over each state
        tensor (a serving tick that recycles hundreds of slots one by one
        rewrites the sliding-CMVN ring once, not once a slot);
        :meth:`set_state` drops resets not yet made."""
        self._stale.update(int(r) for r in rows)

    def _reset_stale(self) -> None:
        if not self._stale:
            return
        rows = sorted(self._stale)
        self._stale.clear()
        self.frontend.reset_rows(rows)
        for stage in self.stages:
            stage.reset_rows(rows)
        if self.cmvn_stats is not None:
            self.cmvn_stats = RunningCMVN(
                *(zero_rows(leaf, rows) for leaf in self.cmvn_stats))
        if self._scmvn is not None:
            self._scmvn.reset_rows(rows)
        if self._ocmvn is not None:
            self._ocmvn.reset_rows(rows)
        if self._resampler is not None:
            self._resampler.reset_rows(rows)
        self._fifos = [zero_rows(f, rows) if f.shape[1] else f
                       for f in self._fifos]
        if self._pitch is not None:
            self._pitch.reset_rows(rows)
            if self._main_fifo.shape[1]:
                self._main_fifo = zero_rows(self._main_fifo, rows)
            if self._pfeat_fifo.shape[1]:
                self._pfeat_fifo = zero_rows(self._pfeat_fifo, rows)
        if self._ivector is not None:
            self._ivector.reset_rows(rows)
            if self._iv_fifo.shape[1]:
                self._iv_fifo = zero_rows(self._iv_fifo, rows)

    def state(self) -> dict:
        """The whole pipeline state, host counters included, for
        :func:`save_state`."""
        self._reset_stale()
        s = {"frontend": self.frontend.state,
             "deltas": [(st.carry, st.n_seen) for st in self.stages],
             "cmvn": self.cmvn_stats,
             "fifos": list(self._fifos)}
        if self._scmvn is not None:
            s["scmvn"] = self._scmvn.state()
        if self._ocmvn is not None:
            s["ocmvn"] = self._ocmvn.state()
        if self._resampler is not None:
            s["resampler"] = self._resampler.state()
        if self._pitch is not None:
            s["pitch"] = self._pitch.state()
            s["main_fifo"] = self._main_fifo
            s["pfeat_fifo"] = self._pfeat_fifo
        if self._ivector is not None:
            s["ivector"] = self._ivector.state()
            s["iv_fifo"] = self._iv_fifo
        return s

    def set_state(self, s: dict) -> None:
        if len(s["deltas"]) != len(self.stages):
            raise ValueError(
                f"checkpoint has {len(s['deltas'])} delta stages, config "
                f"wants {len(self.stages)} (delta_order mismatch)")
        # a resumed stream at another ingest rate would lose the
        # resampler's buffered samples: refuse it
        if (self._resampler is not None) != ("resampler" in s):
            raise ValueError(
                "checkpoint/config input_rate mismatch: checkpoint "
                f"{'has' if 'resampler' in s else 'lacks'} resampler "
                f"state, pipeline input_rate={self._input_rate}")
        for key, have in (("scmvn", self._scmvn), ("ocmvn", self._ocmvn),
                          ("pitch", self._pitch),
                          ("ivector", self._ivector)):
            if (key in s) != (have is not None):
                raise ValueError(f"checkpoint and pipeline disagree on "
                                 f"{key} state")
        self._stale.clear()
        self.frontend.state = s["frontend"]
        for stage, (carry, n_seen) in zip(self.stages, s["deltas"]):
            stage.carry, stage.n_seen = carry, int(n_seen)
        self.cmvn_stats = s["cmvn"]
        if self._scmvn is not None:
            self._scmvn.set_state(s["scmvn"])
        if self._ocmvn is not None:
            self._ocmvn.set_state(s["ocmvn"])
        if self._resampler is not None:
            self._resampler.set_state(s["resampler"])
        self._fifos = list(s["fifos"])
        if self._pitch is not None:
            self._pitch.set_state(s["pitch"])
            self._main_fifo = s["main_fifo"]
            self._pfeat_fifo = s["pfeat_fifo"]
        if self._ivector is not None:
            self._ivector.set_state(s["ivector"])
            self._iv_fifo = s["iv_fifo"]


class PoolRows(Mapping):
    """One serving tick's per-slot rows: a mapping over the batched
    ``[capacity, n, D]`` tensor the wrapper's step produced.

    Iteration gives the tick's slots; ``rows[slot]`` is that slot's rows
    with its warmup rows dropped, a view of the batched tensor (no copy).
    :meth:`block` hands a bulk consumer the batched tensor itself and the
    per-slot trims, so it can move the whole tick to the host in one copy
    and trim there."""

    __slots__ = ("_out", "_skips")

    def __init__(self, out: torch.Tensor, skips: dict):
        self._out = out          # [capacity, n, D]
        self._skips = skips      # slot -> leading warmup rows to drop

    def __getitem__(self, slot) -> torch.Tensor:
        skip = self._skips[slot]
        return self._out[slot, skip:] if skip else self._out[slot]

    def __iter__(self):
        return iter(self._skips)

    def __len__(self) -> int:
        return len(self._skips)

    def __repr__(self) -> str:
        return (f"PoolRows(slots={sorted(self._skips)}, "
                f"block={tuple(self._out.shape)})")

    def block(self) -> tuple[torch.Tensor, dict]:
        """``(out, skips)``: the batched ``[capacity, n, D]`` tensor (the
        rows of unleased slots are junk: index it by this mapping's keys
        only) and, per slot, how many leading warmup rows of ``out[slot]``
        to drop. The trims are this tick's, whatever later ticks do."""
        return self._out, dict(self._skips)


class StreamPool:
    """Slot manager for batched online serving over ONE fixed-shape
    streaming wrapper (:class:`StreamingPipeline` or
    :class:`StreamingFrontend`): streams start and end at different times,
    but the step has one [capacity, C] shape, so utterance turnover
    recycles batch rows in place.

    :meth:`attach` leases a free slot (its row state reset by the
    wrapper's ``reset_rows``, the other rows' bits untouched);
    :meth:`detach` returns it; :meth:`process` runs one batched step per
    tick, feeding zeros to the rows it is not given, and returns only each
    fed slot's trustworthy rows: the wrapper's ``warmup_rows``
    transitional rows after an attach are dropped. The result is a
    :class:`PoolRows`; :meth:`process_batch` takes a caller-assembled
    ``[capacity, C]`` block, the data-plane form at serving size.

    A detached slot's undecided lookahead tail (the deltas' lag) is
    dropped: the end of a served utterance is endpointed trailing silence.
    All slots share one chunk clock: every tick advances every row by the
    same C samples, so per-slot chunk sizes cannot differ (that needs the
    per-row fills of the dynamic step)."""

    def __init__(self, pipeline, warmup: int | None = None):
        self.pipeline = pipeline
        frontend = getattr(pipeline, "frontend", pipeline)
        self.capacity = frontend.state.buf.shape[0]
        self.device = frontend.device
        self._warmup = warmup
        self._free = list(range(self.capacity - 1, -1, -1))
        self._skip: dict[int, int] = {}    # slot -> warmup rows to drop

    @property
    def warmup(self) -> int:
        """The rows an attach drops: the ``warmup`` given, else the
        wrapper's ``warmup_rows`` at this moment (0 for a front-end)."""
        if self._warmup is not None:
            return self._warmup
        return getattr(self.pipeline, "warmup_rows", 0)

    @property
    def active(self) -> list:
        return sorted(self._skip)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def attach(self) -> int:
        """Lease a slot for a new stream; raises when the pool is full
        (size the wrapper's batch for peak concurrency)."""
        if not self._free:
            raise RuntimeError(f"pool full ({self.capacity} slots); "
                               "detach a stream first")
        slot = self._free.pop()
        self.pipeline.reset_rows([slot])
        self._skip[slot] = self.warmup
        return slot

    def detach(self, slot: int) -> None:
        """End a stream and recycle its slot (no per-slot flush: the
        undecided lookahead tail is endpointed trailing silence)."""
        if slot not in self._skip:
            raise KeyError(f"slot {slot} is not attached")
        del self._skip[slot]
        self._free.append(slot)

    def process(self, chunks: dict) -> PoolRows:
        """One serving tick: ``{slot: [C] samples}`` (numpy or tensors)
        for any subset of attached slots -> :class:`PoolRows` of those
        slots (rows on the wrapper's device; their count differs between
        slots only by warmup trimming). Unfed rows, attached but silent
        this tick or unleased, advance on zeros."""
        if not chunks:
            raise ValueError("feed at least one attached slot")
        bad = set(chunks) - set(self._skip)
        if bad:
            raise KeyError(f"slots not attached: {sorted(bad)}")
        sizes = {int(np.shape(c)[-1]) for c in chunks.values()}
        if len(sizes) != 1:
            raise ValueError("all slots share one chunk clock; got chunk "
                             f"sizes {sorted(sizes)}")
        x = torch.zeros(self.capacity, sizes.pop(), device=self.device)
        for slot, c in chunks.items():
            x[slot] = torch.as_tensor(c, dtype=torch.float32)
        return self._trim(self._step(x), chunks)

    def process_batch(self, x) -> PoolRows:
        """Data-plane tick: the caller assembles the whole ``[capacity,
        C]`` block (numpy, or a tensor on the wrapper's device) and the
        pool does only the slot bookkeeping. Rows of unleased slots are
        computed but never returned (the next :meth:`attach` resets them).
        Returns a :class:`PoolRows` over every attached slot."""
        if int(np.shape(x)[0]) != self.capacity:
            raise ValueError(f"expected [capacity={self.capacity}, C] "
                             f"block, got {tuple(np.shape(x))}")
        return self._trim(self._step(x), self._skip)

    def _step(self, x) -> torch.Tensor:
        out = self.pipeline.process(x)
        return out[0] if isinstance(out, tuple) else out   # frontend

    def _trim(self, out: torch.Tensor, slots) -> PoolRows:
        n = out.shape[1]
        skips = {}
        for slot in slots:
            skip = min(self._skip[slot], n)
            self._skip[slot] -= skip
            skips[slot] = skip
        return PoolRows(out, skips)


# --- checkpoint/resume ---

def _leaves(tree) -> list:
    """A state's leaves in the reference's pytree order: dict values by
    sorted key, NamedTuple, tuple and list items in order, None none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _rebuild(like, leaves):
    """``like``'s structure over the arrays of the iterator ``leaves``: a
    tensor leaf becomes a tensor on ``like``'s device, a Python scalar the
    scalar of its type."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(item, leaves) for item in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(item, leaves) for item in like)
    a = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(a, device=like.device)
    return type(like)(a.item())


def save_state(path: str, state) -> None:
    """Write a streaming state (a :class:`StreamState`, a
    :class:`RunningCMVN`, or a wrapper's ``state()`` dict) to .npz in the
    reference's layout: one array per leaf, ``leaf0``, ``leaf1``, ... in
    pytree order, so a state saved by either package loads in the other."""
    np.savez(path, treedef=type(state).__name__,
             **{f"leaf{i}": (leaf.detach().cpu().numpy()
                             if isinstance(leaf, torch.Tensor)
                             else np.asarray(leaf))
                for i, leaf in enumerate(_leaves(state))})


def load_state(path: str, like):
    """Load a state saved by :func:`save_state` (or by the reference's);
    ``like`` gives the structure and the device (e.g. ``init_state(B, cfg,
    device="cuda")`` or a pipeline's ``state()``)."""
    with np.load(path) as data:
        n = len(_leaves(like))
        return _rebuild(like, iter([data[f"leaf{i}"] for i in range(n)]))


def state_from_numpy(state, device=None) -> StreamState:
    """The port's :class:`StreamState` on ``device`` (default the card) from
    any (buf, fill, prev_raw) arrays, e.g. a reference ``StreamState``: each
    leaf is copied through ``np.array``, so its dtype is kept."""
    device = features.default_device(device)
    buf, fill, prev_raw = (torch.from_numpy(np.array(a)).to(device)
                           for a in state)
    return StreamState(buf, fill, prev_raw)
