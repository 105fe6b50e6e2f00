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
Tensors live on the device the caller chooses (``device="cuda"``); nothing
moves between devices behind the caller's back. The streaming wrappers
(deltas, CMVN, the pipeline and the pool) are later slices of the port.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch import features, framing
from tpufeat_torch.config import MFCC13_HTK, FeatureConfig
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
    features._refuse_unported(cfg)       # PLP, spectrogram features


def init_state(batch_size: int = 1, cfg: FeatureConfig = MFCC13_HTK,
               dtype=torch.float32, device=None) -> StreamState:
    """A fresh state for ``batch_size`` streams on ``device`` (default
    CPU)."""
    cap = cfg.frame_length - 1
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

    ``signal``: [N] or [B, N], numpy (sent to ``device``, default CPU) or a
    tensor (computed where it lives). Returns features [(B,) F, D] with
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
        self.device = torch.device(device or "cpu")
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


# --- checkpoint/resume ---

def save_state(path: str, state: StreamState) -> None:
    """Write a :class:`StreamState` to .npz in the reference's layout (one
    array per field, ``leaf0``, ``leaf1``, ... in field order), so a state
    saved by either package loads in the other."""
    np.savez(path, treedef=f"{type(state).__name__}{tuple(state._fields)}",
             **{f"leaf{i}": leaf.detach().cpu().numpy()
                for i, leaf in enumerate(state)})


def load_state(path: str, like: StreamState) -> StreamState:
    """Load a state saved by :func:`save_state` (or by the reference's);
    ``like`` gives the structure and the device (e.g. ``init_state(B, cfg,
    device="cuda")``)."""
    with np.load(path) as data:
        return type(like)(*(torch.as_tensor(data[f"leaf{i}"],
                                            device=leaf.device)
                            for i, leaf in enumerate(like)))


def state_from_numpy(state, device=None) -> StreamState:
    """The port's :class:`StreamState` on ``device`` from any (buf, fill,
    prev_raw) arrays, e.g. a reference ``StreamState``: each leaf goes
    is copied through ``np.array``, so its dtype is kept."""
    buf, fill, prev_raw = (torch.from_numpy(np.array(a)).to(device)
                           for a in state)
    return StreamState(buf, fill, prev_raw)
