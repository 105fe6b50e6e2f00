"""Pitch tracking: NCCF + Viterbi smoothing — counterpart of
``tpufeat/pitch.py``.

Ghahremani et al. 2014 ("A pitch extraction algorithm tuned for ASR") is
the model: per frame, the normalized cross-correlation function (NCCF)
over candidate lags; a Viterbi pass that trades correlation strength
against log-lag-jump penalties, so octave errors and jitter are smoothed
out; and Kaldi-style 3-dim features (POV, mean-subtracted log-pitch,
delta-log-pitch) to append to MFCC/fbank/PLP rows.

As in Kaldi the lags live on a resampled grid (``lag_rate``, default 2 kHz,
Kaldi's ``resample_freq``): the signal is decimated by the polyphase
resampler (``tpufeat_torch/resampling.py``) and integer lags are scored at
that rate, 36 lags instead of 281 at 16 kHz; parabolic interpolation of
the NCCF around the decided lag restores sub-lag resolution.
``lag_rate=0`` scores integer lags at the native rate.

The NCCF numerators are three fp32 products (the DFT as a GEMM at the
extended window's length, ``matrices.nccf_gemm_matrices``) run through
``features.matmul``: full fp32 whatever the caller's TF32 setting, since
the scores feed argmax decisions that must match the float64 golden
(``tpufeat_torch.reference.cpu.pitch``). ``nccf_method="fft"`` is the
rFFT twin. The Viterbi forward pass and its backtrace are Python loops over
frames on [B, L] tensors (a [B, L, L] max per frame): about eight small
launches a frame and no host read inside the loops, so a call's time is
that of its launches. The loops are plain torch ops; a kernel for them is
ROADMAP.md queue 2 work, to be judged by this path's measured time.

Ties: the backtrace and the online step take the FIRST maximum
(``torch.argmax`` and ``torch.max(dim)`` return the lowest index of equal
values), as the golden's ``np.argmax`` does.

The online tracker (:class:`StreamingPitch`) decides frame t when frame
t + K has been scored (K = ``lookahead``), backtracing K slots of a ring of
pointers; its frame counter and ring slots are host ints. Its NCCF ballast
is a running RMS, the one documented divergence from offline tracking
(equal when ``ballast == 0``).

Deviations from Kaldi, as in the reference: integer lags with parabolic
refinement instead of Kaldi's log-spaced interpolated lag set, offline
whole-utterance Viterbi, and a per-utterance RMS ballast. Tensors live on
the caller's device: the card unless it names the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch import features, framing, matrices, resampling


@dataclasses.dataclass(frozen=True)
class PitchConfig:
    """Pitch-tracker knobs (frozen, hashable)."""
    sample_rate: int = 16000
    frame_length: int = 400          # 25 ms correlation window
    hop_length: int = 160            # 10 ms
    min_f0: float = 50.0             # Hz -> largest candidate lag
    max_f0: float = 400.0            # Hz -> smallest candidate lag
    penalty: float = 4.0             # Viterbi log-lag-jump cost weight
    ballast: float = 1.0             # NCCF denominator ballast weight
    #                                  (suppresses spurious correlation
    #                                  peaks in silence and noise)
    lag_bias: float = 0.05           # short-lag preference per ln(lag): a
    #                                  periodic signal scores about equally
    #                                  at every multiple of its lag, so the
    #                                  Viterbi sees nccf - lag_bias *
    #                                  ln(lag / lag_min); POV reports the
    #                                  raw nccf
    delta_window: int = 2            # delta-log-pitch regression window
    nccf_method: str = "gemm"        # "gemm" (DFT as fp32 products) or
    #                                  "fft" (rFFT twin)
    center: bool = False             # False: snip-edges (frame t's window
    #                                  starts at t*hop, Kaldi-style).
    #                                  True: zero-pad wext//2 each side (of
    #                                  the lag-grid signal) so that frame t
    #                                  is centered on t*hop, valid iff
    #                                  t*hop <= length
    lag_rate: int = 2000             # NCCF/Viterbi lag-grid rate (Kaldi's
    #                                  resample_freq); 0 = the native rate
    refine: bool = True              # parabolic sub-lag interpolation of
    #                                  the reported pitch around the
    #                                  decided lag

    @property
    def resampled(self) -> bool:
        """True when the lag grid lives at ``lag_rate`` != native."""
        return bool(self.lag_rate) and self.lag_rate != self.sample_rate

    def inner(self) -> "PitchConfig":
        """The config the NCCF/Viterbi machinery runs at: self when not
        resampled, else the same tracker moved to ``lag_rate`` (frame and
        hop scaled exactly; the rates must divide them)."""
        if not self.resampled:
            return self
        r, sr = self.lag_rate, self.sample_rate
        if (self.frame_length * r) % sr or (self.hop_length * r) % sr:
            raise ValueError(
                f"lag_rate {r} does not divide the frame grid "
                f"(frame_length={self.frame_length}, hop_length="
                f"{self.hop_length} at {sr} Hz); pick a lag_rate that "
                f"keeps both integral, or lag_rate=0 for the native grid")
        return dataclasses.replace(
            self, sample_rate=r, frame_length=self.frame_length * r // sr,
            hop_length=self.hop_length * r // sr, lag_rate=0)

    def lag_grid_length(self, n_samples: int) -> int:
        """Native sample count -> lag-grid sample count (scipy
        resample_poly's ceil(n*p/q); identity when not resampled)."""
        if not self.resampled:
            return n_samples
        p, q = resampling._rational(self.sample_rate, self.lag_rate)
        return resampling.output_length(n_samples, p, q)

    @property
    def lag_min(self) -> int:
        return max(1, int(self.sample_rate / self.max_f0))

    @property
    def lag_max(self) -> int:
        return int(self.sample_rate / self.min_f0)

    @property
    def n_lags(self) -> int:
        return self.lag_max - self.lag_min + 1

    @property
    def wext(self) -> int:
        """Extended correlation window: frame + the largest scored lag."""
        return self.frame_length + self.lag_max

    def num_frames(self, n_samples: int) -> int:
        """Frames over the extended window; centered configs see the
        zero-padded length. Resampled configs count on the lag grid."""
        if self.resampled:
            return self.inner().num_frames(self.lag_grid_length(n_samples))
        w = self.wext
        if self.center:
            n_samples = n_samples + 2 * (w // 2)
        if n_samples < w:
            return 0
        return 1 + (n_samples - w) // self.hop_length


def config_for(feature_cfg, **overrides) -> PitchConfig:
    """A :class:`PitchConfig` on the frame grid of a ``FeatureConfig``:
    its sample rate and hop, a 25 ms window at that rate, centered iff the
    spectral frames are, so pitch frame t and spectral frame t describe
    the same instant. Keyword overrides win. A default lag grid that does
    not divide the feature grid (22.05 kHz and the like) falls back to the
    native grid."""
    kw = dict(sample_rate=feature_cfg.sample_rate,
              hop_length=feature_cfg.hop_length,
              frame_length=int(round(0.025 * feature_cfg.sample_rate)),
              center=feature_cfg.center)
    kw.update(overrides)
    cfg = PitchConfig(**kw)
    if cfg.resampled and "lag_rate" not in overrides:
        r, sr = cfg.lag_rate, cfg.sample_rate
        if (cfg.frame_length * r) % sr or (cfg.hop_length * r) % sr:
            cfg = dataclasses.replace(cfg, lag_rate=0)
    return cfg


@functools.lru_cache(maxsize=None)
def _transition_matrix(cfg: PitchConfig) -> np.ndarray:
    """[L, L] Viterbi transition costs penalty * log(lag_j / lag_i)^2."""
    lags = np.arange(cfg.lag_min, cfg.lag_max + 1, dtype=np.float64)
    ll = np.log(lags)
    return (cfg.penalty * (ll[:, None] - ll[None, :]) ** 2).astype(
        np.float32)


def _lag_tilt(cfg: PitchConfig, device) -> torch.Tensor:
    """lag_bias * ln(lag / lag_min) over the lags, float32."""
    lags = torch.arange(cfg.lag_min, cfg.lag_max + 1, dtype=torch.float32,
                        device=device)
    return cfg.lag_bias * torch.log(lags / cfg.lag_min)


def _nccf_from_frames(frames: torch.Tensor, ballast: torch.Tensor,
                      cfg: PitchConfig) -> torch.Tensor:
    """Extended frames [..., F, W + lag_max] + ballast [...] -> nccf
    [..., F, L], the frame-level core of offline and online tracking:
    nccf(t, l) = sum_i a_i b_{i+l} / sqrt(E0 * E_l + ballast), a the
    frame's first ``frame_length`` samples, b the extended window."""
    W = cfg.frame_length
    L0, L1 = cfg.lag_min, cfg.lag_max
    a = frames[..., :W]
    if cfg.nccf_method == "gemm":
        c, s, ci, si = matrices.nccf_gemm_matrices(W, L0, L1)
        ra, ia = features.matmul(a, c[:W]), features.matmul(a, s[:W])
        rb, ib = features.matmul(frames, c), features.matmul(frames, s)
        p_re = ra * rb + ia * ib            # Re(conj(Fa) * Fb)
        p_im = ra * ib - ia * rb            # Im(conj(Fa) * Fb)
        num = features.matmul(p_re, ci) + features.matmul(p_im, si)
    elif cfg.nccf_method == "fft":
        nfft = int(2 ** np.ceil(np.log2(cfg.wext + W)))
        fa = torch.fft.rfft(a, n=nfft, dim=-1)
        fb = torch.fft.rfft(frames, n=nfft, dim=-1)
        corr = torch.fft.irfft(torch.conj(fa) * fb, n=nfft, dim=-1)
        num = corr[..., L0: L1 + 1]
    else:
        raise ValueError(f"unknown nccf_method {cfg.nccf_method!r}")
    cs = torch.cumsum(torch.cat([torch.zeros_like(frames[..., :1]),
                                 frames * frames], dim=-1), dim=-1)
    e = cs[..., W:] - cs[..., :-W]                  # E_l, l = 0..lag_max
    den = torch.sqrt(e[..., :1] * e[..., L0: L1 + 1]
                     + ballast[..., None, None] + 1e-20)
    return num / den


def to_lag_grid(x: torch.Tensor, lengths: torch.Tensor, cfg: PitchConfig):
    """(signal, lengths, cfg) -> the same triple on the lag grid: the
    padding zeroed (the filter straddles the length, and the resampler's
    own virtual padding is zeros, so a padded row resamples as it would
    alone), resampled to ``cfg.lag_rate`` with ``block=256``, and the
    inner config. Identity for native-grid configs."""
    if not cfg.resampled:
        return x, lengths, cfg
    p, q = resampling._rational(cfg.sample_rate, cfg.lag_rate)
    keep = torch.arange(x.shape[-1], device=x.device) < lengths[..., None]
    y = resampling.resample(x * keep.to(x.dtype), cfg.sample_rate,
                            cfg.lag_rate, block=256)
    # ceil(n*p/q) without forming n*p
    ly = lengths // q * p + (lengths % q * p + q - 1) // q
    return y, ly.to(torch.int32), cfg.inner()


def nccf(signal: torch.Tensor, lengths: torch.Tensor, cfg: PitchConfig
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched NCCF: [B, N] -> (nccf [B, F, L], frame validity [B, F]),
    ballast = cfg.ballast * (frame_length * rms^2)^2 from each row's masked
    RMS. Resampled configs move to their lag grid first, so the frame axis
    is the inner grid's (:meth:`PitchConfig.num_frames`)."""
    signal, lengths, cfg = to_lag_grid(signal, lengths, cfg)
    W, hop, wext = cfg.frame_length, cfg.hop_length, cfg.wext
    B, N = signal.shape
    F = cfg.num_frames(N)
    dev = signal.device
    if F <= 0:
        return (torch.zeros(B, 0, cfg.n_lags, device=dev),
                torch.zeros(B, 0, dtype=torch.bool, device=dev))
    # the RMS of the real signal, before any centering pad
    m = (torch.arange(N, device=dev) < lengths[:, None]).to(signal.dtype)
    rms2 = torch.sum(signal * signal * m, dim=-1) / torch.clamp(
        torch.sum(m, dim=-1), min=1.0)
    ballast = cfg.ballast * (W * rms2) ** 2
    t = torch.arange(F, device=dev)[None, :] * hop
    if cfg.center:
        pad = wext // 2
        signal = torch.nn.functional.pad(signal, (pad, pad))
        valid = t <= lengths[:, None]
    else:
        valid = t + wext <= lengths[:, None]
    frames = framing.frames_from_buffer(signal, F, wext, hop)
    return _nccf_from_frames(frames, ballast, cfg), valid


def _viterbi(scores: torch.Tensor, valid: torch.Tensor,
             trans: torch.Tensor) -> torch.Tensor:
    """[B, F, L] scores (+ [B, F] validity) -> best lag index [B, F].

    The forward pass keeps only the running scores (one [B, L] row a
    frame); the backtrace recomputes each step's pointer for the selected
    state alone, argmax over v_{t-1} - trans[:, j*], the same float values
    and the same first-maximum rule as a pointer table. Padded frames
    freeze the running scores and pass the pointer through, so a padded
    row's path is its unpadded path."""
    B, F, L = scores.shape
    v = torch.where(valid[:, :1], scores[:, 0], 0.0)
    history = []
    for t in range(1, F):
        history.append(v)
        best = torch.amax(v[:, :, None] - trans, dim=1)
        v = torch.where(valid[:, t: t + 1], scores[:, t] + best, v)
    lag = torch.argmax(v, dim=-1)
    trans_t = trans.T.contiguous()           # row j: trans[:, j]
    path = [lag]
    for t in range(F - 1, 0, -1):
        cur = torch.argmax(history[t - 1] - trans_t[lag], dim=-1)
        lag = torch.where(valid[:, t], cur, lag)
        path.append(lag)
    return torch.stack(path[::-1], dim=1)


def refine_lag(scores: torch.Tensor, idx: torch.Tensor,
               curvature_floor: float = 1e-2) -> torch.Tensor:
    """Parabolic sub-lag offset in [-0.5, 0.5] from the raw NCCF around
    the decided lag: [..., F, L] scores + [..., F] indices -> [..., F].
    Zero at the grid's edges and wherever the curvature is below
    ``curvature_floor`` (a flat peak's vertex is noise)."""
    L = scores.shape[-1]
    idx = idx.long()

    def take(j):
        return torch.gather(scores, -1, j[..., None])[..., 0]
    ym = take(torch.clamp(idx - 1, 0, L - 1))
    y0 = take(idx)
    yp = take(torch.clamp(idx + 1, 0, L - 1))
    denom = ym - 2.0 * y0 + yp                      # 2x the curvature
    delta = 0.5 * (ym - yp) / torch.where(denom == 0, 1.0, denom)
    ok = (idx > 0) & (idx < L - 1) & (denom < -curvature_floor)
    return torch.where(ok, torch.clamp(delta, -0.5, 0.5), 0.0)


def _prepare(signal, lengths, device):
    x = features.placed(signal, device).to(torch.float32)
    single = x.dim() == 1
    if single:
        x = x[None]
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                             device=x.device)
    else:
        lengths = features.on_device(lengths, x.device).to(torch.int32)
    return x, lengths, single


def _track_impl(x: torch.Tensor, lengths: torch.Tensor, cfg: PitchConfig):
    x, lengths, cfg = to_lag_grid(x, lengths, cfg)
    scores, valid = nccf(x, lengths, cfg)
    if scores.shape[1] == 0:          # shorter than frame + lag window
        z = torch.zeros(valid.shape, device=valid.device)
        return z, z, valid
    trans = torch.as_tensor(_transition_matrix(cfg), device=x.device)
    idx = _viterbi(scores - _lag_tilt(cfg, x.device), valid, trans)
    lags = (cfg.lag_min + idx).to(torch.float32)
    if cfg.refine:
        lags = lags + refine_lag(scores, idx)
    pov = torch.gather(scores, -1, idx[..., None])[..., 0]
    return cfg.sample_rate / lags, pov, valid


def track(signal, lengths=None, cfg: PitchConfig = PitchConfig(),
          device=None):
    """Audio [B, N] (or [N]) -> (pitch_hz [B, F], pov [B, F], valid
    [B, F]). ``pov`` is the raw NCCF on the chosen path, in [-1, 1]: high
    for periodic frames, about 0 for silence and noise. Numpy goes to
    ``device`` (the card unless the caller names the CPU)."""
    x, lengths, single = _prepare(signal, lengths, device)
    pitch, pov, valid = _track_impl(x, lengths, cfg)
    if single:
        return pitch[0], pov[0], valid[0]
    return pitch, pov, valid


def pitch_features(signal, lengths=None, cfg: PitchConfig = PitchConfig(),
                   device=None):
    """Kaldi-style 3-dim pitch features [B, F, 3] (+ validity [B, F]):
    POV, log-pitch less its mean over valid frames, delta-log-pitch. The
    extended correlation window gives fewer frames than the spectral
    front-end's on the same audio: pitch frames are a prefix of the same
    hop grid, so truncate the spectral rows to them."""
    x, lengths, single = _prepare(signal, lengths, device)
    pitch, pov, valid = _track_impl(x, lengths, cfg)
    lp = torch.log(pitch)
    m = valid.to(lp.dtype)
    mean = torch.sum(lp * m, dim=-1, keepdim=True) / torch.clamp(
        torch.sum(m, dim=-1, keepdim=True), min=1.0)
    lp_c = (lp - mean) * m
    nf = torch.sum(valid, dim=-1).to(torch.int32)
    dlp = features.deltas(lp_c[..., None], nf, cfg.delta_window)[..., 0]
    feats = torch.stack([pov * m, lp_c, dlp * m], dim=-1)
    if single:
        return feats[0], valid[0]
    return feats, valid


# ---------------------------------------------------------------------------
# Online pitch: lookahead-K Viterbi with delayed emission
# ---------------------------------------------------------------------------

class PitchStreamState(NamedTuple):
    """Carry of online pitch (:class:`StreamingPitch` keeps the fill and
    the frame counter as host ints):

    buf:  [B, frame_length + lag_max - 1] raw-sample carry
    v:    [B, L] Viterbi forward scores
    ptrs: [B, K+1, L] int64 backpointer ring (slot t % (K+1) holds the
          transition into frame t)
    raw:  [B, K+1, L] raw-NCCF ring (POV and refinement of emitted frames)
    sumsq, count: [B] running ballast statistics
    """
    buf: torch.Tensor
    v: torch.Tensor
    ptrs: torch.Tensor
    raw: torch.Tensor
    sumsq: torch.Tensor
    count: torch.Tensor


def init_pitch_state(batch_size: int, cfg: PitchConfig, lookahead: int,
                     device=None) -> PitchStreamState:
    device = features.default_device(device)
    L, K = cfg.n_lags, lookahead
    z = functools.partial(torch.zeros, device=device)
    return PitchStreamState(
        buf=z(batch_size, cfg.frame_length + cfg.lag_max - 1),
        v=z(batch_size, L),
        ptrs=z(batch_size, K + 1, L, dtype=torch.int64),
        raw=z(batch_size, K + 1, L),
        sumsq=z(batch_size), count=z(batch_size))


def _as_state(s, device) -> PitchStreamState:
    """A pitch state from any leaves (tensors or arrays, e.g. one loaded
    from a file the reference saved), on ``device``; pointers as int64."""
    st = PitchStreamState(*(features.on_device(a, device) for a in s))
    return st._replace(ptrs=st.ptrs.to(torch.int64))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for [B, L] x and [B] idx."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def pitch_chunk_static(state: PitchStreamState, chunk: torch.Tensor,
                       pos0: int, *, cfg: PitchConfig, lookahead: int,
                       fill: int):
    """One online step: ([B, C] lag-grid samples, the buffer's ``fill``
    and the frame counter ``pos0``, both host ints) -> (state', lag index
    [B, n_new], pov [B, n_new], sub-lag delta [B, n_new]); the caller owns
    any resampling.

    Frame t is decided when frame t+K has been scored: each emission
    backtraces K ring slots from the newest frame's best state, so the
    outputs lag the input by K frames (the wrapper drops the first K, and
    :func:`pitch_flush` drains the tail). With K >= the stream's frames
    the flush is the offline Viterbi. The rings are copied once a step, so
    a state taken earlier stays as it was."""
    W, hop, K = cfg.frame_length, cfg.hop_length, lookahead
    wext = W + cfg.lag_max
    cap = wext - 1
    B, C = chunk.shape
    if not 0 <= fill <= cap:
        raise ValueError(f"fill {fill} outside [0, {cap}]")
    data = torch.cat([state.buf[:, cap - fill:], chunk], dim=1)
    total = fill + C
    n_new = max(0, 1 + (total - wext) // hop)
    sumsq = state.sumsq + torch.sum(chunk * chunk, dim=-1)
    count = state.count + C
    rms2 = sumsq / torch.clamp(count, min=1.0)
    ballast = cfg.ballast * (W * rms2) ** 2
    fill_out = total - n_new * hop
    new_buf = torch.cat([data.new_zeros(B, cap - fill_out),
                         data[:, n_new * hop:]], dim=1)
    if n_new == 0:
        st = state._replace(buf=new_buf, sumsq=sumsq, count=count)
        z = data.new_zeros(B, 0)
        return st, z.to(torch.int64), z, z
    frames = framing.frames_from_buffer(data, n_new, wext, hop)
    sraw = _nccf_from_frames(frames, ballast, cfg)       # [B, n_new, L]
    tilt = _lag_tilt(cfg, data.device)
    trans = torch.as_tensor(_transition_matrix(cfg), device=data.device)
    ident = torch.arange(cfg.n_lags, device=data.device).expand(B, -1)
    v, ptrs, raw = state.v, state.ptrs.clone(), state.raw.clone()
    lags, povs, dlts = [], [], []
    for i in range(n_new):
        pos = pos0 + i
        s_raw = sraw[:, i]
        shaped = s_raw - tilt
        if pos == 0:
            v, ptr = shaped, ident
        else:
            best, ptr = torch.max(v[:, :, None] - trans, dim=1)
            v = shaped + best
        slot = pos % (K + 1)
        ptrs[:, slot] = ptr
        raw[:, slot] = s_raw
        lag = torch.argmax(v, dim=-1)
        for k in range(K):
            lag = _take(ptrs[:, (pos - k) % (K + 1)], lag)
        raw_e = raw[:, (pos - K) % (K + 1)]
        lags.append(lag)
        povs.append(_take(raw_e, lag))
        dlts.append(refine_lag(raw_e, lag) if cfg.refine
                    else torch.zeros_like(povs[-1]))
    st = PitchStreamState(buf=new_buf, v=v, ptrs=ptrs, raw=raw,
                          sumsq=sumsq, count=count)
    return (st, torch.stack(lags, dim=1), torch.stack(povs, dim=1),
            torch.stack(dlts, dim=1))


def pitch_flush(state: PitchStreamState, *, cfg: PitchConfig,
                lookahead: int, pos: int):
    """Drain the pending min(pos, lookahead) frames: the full backtrace
    from the final forward maximum through the ring -> (lag index, pov,
    delta), each [B, n]."""
    K = lookahead
    n = min(pos, K)
    B = state.v.shape[0]
    if n == 0:
        z = state.v.new_zeros(B, 0)
        return z.to(torch.int64), z, z
    lag = torch.argmax(state.v, dim=-1)
    lags, povs, dlts = [], [], []
    for k in range(n):                    # frame pos-1-k, newest first
        slot = (pos - 1 - k) % (K + 1)
        raw_k = state.raw[:, slot]
        lags.append(lag)
        povs.append(_take(raw_k, lag))
        dlts.append(refine_lag(raw_k, lag) if cfg.refine
                    else torch.zeros_like(povs[-1]))
        if k < n - 1:
            lag = _take(state.ptrs[:, slot], lag)
    return (torch.stack(lags[::-1], dim=1), torch.stack(povs[::-1], dim=1),
            torch.stack(dlts[::-1], dim=1))


class StreamingPitch:
    """Online pitch: host-tracked fill and frame counter around
    :func:`pitch_chunk_static` (the pitch sibling of
    ``streaming.StreamingFrontend``).

    >>> sp = StreamingPitch(PitchConfig(), batch_size=1, lookahead=15,
    ...                     device="cpu")
    >>> hz, pov = sp.process(chunk)            # [B, n_emitted] each
    >>> hz, pov = sp.flush()                   # the last frames
    """

    def __init__(self, cfg: PitchConfig = PitchConfig(),
                 batch_size: int = 1, lookahead: int = 15, device=None):
        self.device = features.default_device(device)
        self.outer_cfg = cfg
        # every sample-level step runs on the lag grid: a resampled config
        # puts a StreamingResampler in front (bit-exact against the offline
        # base path) and self.cfg is the inner config
        self.cfg = cfg.inner()
        self._resampler = None
        if cfg.resampled:
            self._resampler = resampling.StreamingResampler(
                cfg.sample_rate, cfg.lag_rate, batch_size, self.device)
        self.lookahead = lookahead
        self.state = init_pitch_state(batch_size, self.cfg, lookahead,
                                      self.device)
        # center=True: the offline tracker zero-pads wext//2 each side of
        # the lag-grid signal; the zeroed buffer is the left pad, and
        # flush() feeds the right one
        self._fill = self.cfg.wext // 2 if self.cfg.center else 0
        self._pos = 0
        self._tail_padded = False

    def _hz(self, lag_idx: torch.Tensor, dlt: torch.Tensor) -> torch.Tensor:
        return self.cfg.sample_rate / (self.cfg.lag_min + dlt
                                       + lag_idx.to(torch.float32))

    def _feed(self, chunk: torch.Tensor):
        """Advance the tracker by a lag-grid chunk."""
        self.state, lags, povs, dlts = pitch_chunk_static(
            self.state, chunk, self._pos, cfg=self.cfg,
            lookahead=self.lookahead, fill=self._fill)
        n_new = lags.shape[1]
        # the first `lookahead` frames' emissions are warm-up: dropped
        skip = max(0, min(self.lookahead - self._pos, n_new))
        self._pos += n_new
        self._fill = self._fill + chunk.shape[1] - n_new * self.cfg.hop_length
        return self._hz(lags[:, skip:], dlts[:, skip:]), povs[:, skip:]

    def process(self, chunk):
        """[B, C] (or [C]) samples at the config's rate -> (hz, pov), each
        [B, n_emitted]."""
        chunk = features.placed(chunk, self.device).to(torch.float32)
        if chunk.dim() == 1:
            chunk = chunk[None]
        if self._resampler is not None:
            chunk = self._resampler.process(chunk)
        return self._feed(chunk)

    def reset_rows(self, rows) -> None:
        """Slot recycle: zero the rows' sample and resampler carries, forward
        scores, rings and ballast statistics (the shared fill and frame
        clock keep running). The zero state is the tracker's initial
        condition, so the slot's next ``lookahead`` emissions are warm-up,
        then final. The other rows keep their bits."""
        from tpufeat_torch.streaming import zero_rows
        if self._resampler is not None:
            self._resampler.reset_rows(rows)
        self.state = PitchStreamState(
            *(zero_rows(leaf, rows) for leaf in self.state))

    def flush(self):
        """End of stream: the resampler's tail, the centered right pad, then
        the pending Viterbi frames -> (hz, pov)."""
        parts = []
        if self._resampler is not None and not self._tail_padded:
            tail = self._resampler.flush()
            if tail.shape[1]:
                parts.append(self._feed(tail))
        if self.cfg.center and not self._tail_padded:
            B = self.state.v.shape[0]
            parts.append(self._feed(torch.zeros(B, self.cfg.wext // 2,
                                                device=self.device)))
        self._tail_padded = True
        lags, povs, dlts = pitch_flush(self.state, cfg=self.cfg,
                                       lookahead=self.lookahead,
                                       pos=self._pos)
        parts.append((self._hz(lags, dlts), povs))
        return (torch.cat([p[0] for p in parts], dim=1),
                torch.cat([p[1] for p in parts], dim=1))


class StreamingPitchFeatures:
    """Online Kaldi-style pitch rows, the streaming sibling of
    :func:`pitch_features`: :class:`StreamingPitch` -> (POV, mean-subtracted
    log-pitch, delta-log-pitch) rows in stream order.

    Against the offline :func:`pitch_features`: POV is exact wherever the
    delayed decisions are final; delta-log-pitch is taken on the raw
    log-pitch by ``streaming.StreamingDeltas`` (regression deltas ignore a
    constant shift, so the utterance mean drops out) and is exact too; the
    mean-subtracted log-pitch subtracts the running mean of the frames
    decided so far, which converges to the offline column (exact when
    everything is decided at flush). Emission lags the input by
    ``lookahead + 2*delta_window`` frames; :meth:`flush` drains both."""

    def __init__(self, cfg: PitchConfig = PitchConfig(),
                 batch_size: int = 1, lookahead: int = 15, device=None):
        from tpufeat_torch.streaming import StreamingDeltas
        self.cfg = cfg
        self.device = features.default_device(device)
        self.tracker = StreamingPitch(cfg, batch_size, lookahead,
                                      self.device)
        self._deltas = StreamingDeltas(1, cfg.delta_window, batch_size,
                                       self.device)
        z = functools.partial(torch.zeros, device=self.device)
        self._pov_fifo = z(batch_size, 0)
        self._lp_fifo = z(batch_size, 0)
        self._lp_sum = z(batch_size)
        # decided frames per row, so that a recycled slot's running mean
        # restarts with its own frames
        self._n = z(batch_size)

    def _ingest(self, hz: torch.Tensor, pov: torch.Tensor) -> torch.Tensor:
        lp = torch.log(hz)
        self._lp_sum = self._lp_sum + torch.sum(lp, dim=1)
        self._n = self._n + lp.shape[1]
        self._pov_fifo = torch.cat([self._pov_fifo, pov], dim=1)
        self._lp_fifo = torch.cat([self._lp_fifo, lp], dim=1)
        return self._deltas.process(lp[..., None])

    def _emit(self, dlp: torch.Tensor) -> torch.Tensor:
        n = dlp.shape[1]
        pov, self._pov_fifo = self._pov_fifo[:, :n], self._pov_fifo[:, n:]
        lp, self._lp_fifo = self._lp_fifo[:, :n], self._lp_fifo[:, n:]
        mean = self._lp_sum[:, None] / torch.clamp(self._n, min=1.0)[:, None]
        return torch.stack([pov, lp - mean, dlp[..., 0]], dim=-1)

    def process(self, chunk) -> torch.Tensor:
        """[B, C] (or [C]) samples -> [B, n, 3] complete rows."""
        hz, pov = self.tracker.process(chunk)
        if hz.shape[1] == 0:
            return hz.new_zeros(hz.shape[0], 0, 3)
        return self._emit(self._ingest(hz, pov))

    def flush(self) -> torch.Tensor:
        hz, pov = self.tracker.flush()
        parts = []
        if hz.shape[1]:
            parts.append(self._ingest(hz, pov))
        parts.append(self._deltas.flush())
        out = self._emit(torch.cat(parts, dim=1))
        if self._pov_fifo.shape[1] or self._lp_fifo.shape[1]:
            raise RuntimeError("rows left in the pitch FIFOs after flush")
        return out

    def state(self) -> dict:
        """The whole state (host counters included), in the reference's
        layout, for ``streaming.save_state``."""
        t = self.tracker
        s = {"tracker": t.state, "fill": t._fill, "pos": t._pos,
             "tail_padded": t._tail_padded,
             "deltas": (self._deltas.carry, self._deltas.n_seen),
             "pov_fifo": self._pov_fifo, "lp_fifo": self._lp_fifo,
             "lp_sum": self._lp_sum, "n": self._n}
        if t._resampler is not None:
            s["resampler"] = t._resampler.state()
        return s

    def reset_rows(self, rows) -> None:
        """Slot recycle: the rows' tracker state, delta carry, FIFO content
        and running mean restart; the shared emission clock and the other
        rows are untouched. The slot's next ``lookahead + 2*delta_window``
        rows are warm-up."""
        from tpufeat_torch.streaming import zero_rows
        self.tracker.reset_rows(rows)
        self._deltas.reset_rows(rows)
        if self._pov_fifo.shape[1]:
            self._pov_fifo = zero_rows(self._pov_fifo, rows)
        if self._lp_fifo.shape[1]:
            self._lp_fifo = zero_rows(self._lp_fifo, rows)
        self._lp_sum = zero_rows(self._lp_sum, rows)
        self._n = zero_rows(self._n, rows)

    def set_state(self, s: dict) -> None:
        t = self.tracker
        dev = self.device

        def put(a):
            return features.on_device(a, dev).to(torch.float32)
        t.state = _as_state(s["tracker"], dev)
        t._fill, t._pos = int(s["fill"]), int(s["pos"])
        t._tail_padded = bool(s["tail_padded"])
        if t._resampler is not None:
            t._resampler.set_state(s["resampler"])
        self._deltas.carry = put(s["deltas"][0])
        self._deltas.n_seen = int(s["deltas"][1])
        self._pov_fifo = put(s["pov_fifo"])
        self._lp_fifo = put(s["lp_fifo"])
        self._lp_sum = put(s["lp_sum"])
        n = put(s["n"])
        # a checkpoint of one shared count holds a scalar
        self._n = n.expand_as(self._lp_sum).clone() if n.dim() == 0 else n
