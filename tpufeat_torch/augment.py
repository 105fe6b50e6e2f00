"""Training-time augmentation, voice activity detection and endpointing —
counterpart of ``tpufeat/augment.py``.

SpecAugment (Park et al., 2019) masks bands of the feature axis and spans
of the time axis, per utterance, with masks built by index comparisons
(no gathers); its positions and widths come from the caller's
``torch.Generator`` (the reference draws from a JAX PRNG key: the two give
different masks from the same seed, with the same distribution). Time
masks stay inside each utterance's valid frames, and padding frames are
left as they are.

Beside it: Kaldi's ``compute-vad`` (:func:`kaldi_vad`), a frame-energy VAD
offline and online (:func:`energy_vad`, :class:`StreamingEnergyVAD`), the
segments that a VAD's flags give (:func:`speech_segments`), Kaldi
``OnlineEndpoint`` rules (:class:`StreamingEndpointer`), and the signal
augmentations: noise at a target SNR, reverberation by FFT convolution
(``torch.fft``) and speed perturbation on the polyphase resampler. All
plain torch ops on the caller's device, the card unless the caller names
the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufeat_torch import features, framing, resampling
from tpufeat_torch.config import FeatureConfig

__all__ = ["spec_augment", "kaldi_vad", "energy_vad", "add_noise",
           "add_reverb", "speed_perturb", "StreamingEnergyVAD",
           "EndpointRule", "DEFAULT_ENDPOINT_RULES", "StreamingEndpointer",
           "speech_segments", "segments_to_samples"]


def _bands(idx: torch.Tensor, start: torch.Tensor, width: torch.Tensor
           ) -> torch.Tensor:
    """Any of the [B, M] bands [start, start + width) covers idx: ->
    broadcast of idx [..., 1] against [B, 1, M]."""
    return ((idx[..., None] >= start) & (idx[..., None] < start + width)
            ).any(dim=-1)


def spec_augment(feats: torch.Tensor, num_frames, generator:
                 torch.Generator, *, n_freq_masks: int = 2,
                 freq_width: int = 27, n_time_masks: int = 2,
                 time_width: int = 100,
                 time_width_ratio: float | None = None,
                 fill: str = "mean") -> torch.Tensor:
    """SpecAugment masking: feats [B, T, D] -> masked copy.

    Per utterance: ``n_freq_masks`` bands of width U{0..min(freq_width,
    D)} on the feature axis and ``n_time_masks`` spans of width
    U{0..min(time_width, num_frames)} on the time axis, each start uniform
    over the positions that keep it inside (the time ones inside the
    utterance's ``num_frames``). ``time_width_ratio``: the adaptive policy
    (Park et al., 2020), a width budget of ratio * num_frames instead of
    ``time_width``. ``fill``: "mean" (each utterance's mean over its valid
    frames) or "zero". ``generator`` (on ``feats``' device) draws the
    masks."""
    B, T, D = feats.shape
    dev = feats.device
    nf_true = torch.as_tensor(num_frames, device=dev).to(torch.int64)
    nf = torch.clamp(nf_true, min=1)

    def uniform(m):
        return torch.rand(B, m, generator=generator, device=dev)

    fw = torch.randint(0, min(freq_width, D) + 1, (B, n_freq_masks),
                       generator=generator, device=dev)
    f0 = (uniform(n_freq_masks) * (D - fw)).to(torch.int64)
    d_idx = torch.arange(D, device=dev)[None, None, :]
    masked = _bands(d_idx, f0[:, None, None, :], fw[:, None, None, :])
    if time_width_ratio is not None:
        max_tw = torch.minimum((time_width_ratio * nf).to(torch.int64), nf)
    else:
        max_tw = torch.clamp(nf, max=time_width)
    tw = (uniform(n_time_masks) * (max_tw[:, None] + 1)).to(torch.int64)
    t0 = (uniform(n_time_masks) * (nf[:, None] - tw)).to(torch.int64)
    t_idx = torch.arange(T, device=dev)[None, :, None]
    masked = masked | _bands(t_idx, t0[:, None, None, :],
                             tw[:, None, None, :])
    # padding frames stay untouched: the gate is the TRUE frame count
    valid = torch.arange(T, device=dev)[None, :] < nf_true[:, None]
    masked = masked & valid[..., None]
    if fill == "mean":
        m = valid[..., None].to(feats.dtype)
        cnt = torch.clamp(m.sum(dim=(1, 2)) * D, min=1.0)
        fill_val = ((feats * m).sum(dim=(1, 2)) / cnt)[:, None, None]
    elif fill == "zero":
        fill_val = torch.zeros((), dtype=feats.dtype, device=dev)
    else:
        raise ValueError(f"unknown fill {fill!r}")
    return torch.where(masked, fill_val, feats)


def kaldi_vad(log_energy, num_frames=None, *,
              energy_threshold: float = 5.0,
              energy_mean_scale: float = 0.5,
              frames_context: int = 0,
              proportion_threshold: float = 0.6,
              device=None) -> torch.Tensor:
    """Kaldi ``compute-vad`` (``VadEnergyOptions``): per-frame speech
    decisions from a log-energy track (MFCC c0 of a ``kaldi_mode``
    config, or a frame log-energy column).

    threshold = ``energy_threshold`` + ``energy_mean_scale`` * (the mean
    log energy over the valid frames); frame t is speech iff at least
    ``proportion_threshold`` of the frames of [t - frames_context,
    t + frames_context] (clipped to the utterance) exceed it. [B, T] (+
    optional [B] frame counts) -> [B, T] bool, False on padding; a 1-D
    track gives a 1-D result."""
    e = features.placed(log_energy, device).to(torch.float32)
    squeeze = e.dim() == 1
    if squeeze:
        e = e[None]
    B, T = e.shape
    if num_frames is None:
        valid = torch.ones(B, T, device=e.device)
    else:
        nf = features.on_device(num_frames, e.device)
        nf = nf.reshape(-1)
        valid = (torch.arange(T, device=e.device)[None, :]
                 < nf[:, None]).to(torch.float32)
    n = torch.clamp(valid.sum(dim=1, keepdim=True), min=1.0)
    thresh = energy_threshold + energy_mean_scale * (
        (e * valid).sum(dim=1, keepdim=True) / n)
    above = ((e > thresh) & (valid > 0)).to(torch.float32)
    c = int(frames_context)
    if c == 0:
        out = above > 0
    else:
        def winsum(v):
            # sums over [t-c, t+c] clipped to the track: differences of
            # an inclusive cumulative sum
            cs = torch.cumsum(torch.nn.functional.pad(v, (1, 0)), dim=1)
            hi = torch.cat([cs[:, 1:], cs[:, -1:].expand(B, c)],
                           dim=1)[:, c:]
            lo = torch.nn.functional.pad(cs[:, :-1], (c, 0))[:, :T]
            return hi - lo
        num = winsum(above)
        den = torch.clamp(winsum(valid), min=1.0)
        out = (num >= proportion_threshold * den) & (valid > 0)
    return out[0] if squeeze else out


def _frame_db(frames: torch.Tensor) -> torch.Tensor:
    e = torch.sum(frames * frames, dim=-1)
    return 10.0 * torch.log10(torch.clamp(e, min=1e-12))


def energy_vad(signal, lengths, frame_length: int = 400,
               hop_length: int = 160, threshold_db: float = -40.0,
               device=None) -> torch.Tensor:
    """Energy VAD: [B, N] samples -> [B, F] bool, True where the frame's
    energy is within ``threshold_db`` of the utterance's loudest frame;
    frames past an utterance's length are False."""
    x = features.placed(signal, device).to(torch.float32)
    lengths = features.on_device(lengths, x.device).to(torch.int32)
    cfg = FeatureConfig(frame_length=frame_length, hop_length=hop_length,
                        preemphasis=0.0)
    frames, mask = framing.frame_signal(x, lengths, cfg)
    e_db = _frame_db(frames)
    peak = torch.amax(torch.where(mask, e_db, -torch.inf), dim=-1,
                      keepdim=True)
    peak = torch.where(torch.isfinite(peak), peak, 0.0)
    return (e_db >= peak + threshold_db) & mask


def add_noise(signal, noise, lengths, snr_db, device=None) -> torch.Tensor:
    """Mix noise into the signal at a target SNR: [B, N] + [B, N] ->
    [B, N]. The noise is scaled per utterance so that over the valid
    samples 10*log10(P_signal / P_noise) == ``snr_db`` (a scalar or [B]);
    padding is untouched, and a silent utterance gets no noise."""
    x = features.placed(signal, device).to(torch.float32)
    v = features.on_device(noise, x.device).to(torch.float32)
    ln = features.on_device(lengths, x.device)
    m = (torch.arange(x.shape[-1], device=x.device) < ln[:, None]).to(
        x.dtype)
    n_valid = torch.clamp(m.sum(dim=-1), min=1.0)
    p_sig = torch.sum(x * x * m, dim=-1) / n_valid
    p_noi = torch.sum(v * v * m, dim=-1) / n_valid
    snr = torch.as_tensor(snr_db, dtype=x.dtype, device=x.device)
    want = p_sig / 10.0 ** (snr / 10.0)
    scale = torch.sqrt(want / torch.clamp(p_noi, min=1e-20))
    scale = torch.where(p_noi > 0, scale, 0.0)
    return x + scale[:, None] * v * m


def add_reverb(signal, rir, lengths, *, shift_to_peak: bool = True,
               normalize: bool = True, device=None) -> torch.Tensor:
    """Convolve each utterance with a room impulse response (Kaldi
    ``wav-reverberate``): [B, N] x [B, R] (or a shared [R]) -> [B, N], as
    one batched rFFT product at the next power of two >= N + R - 1.

    ``shift_to_peak``: the output is advanced by the RIR's peak index
    (the direct path), so it stays aligned with the dry signal.
    ``normalize``: each utterance is rescaled to the dry signal's power
    over its valid samples. Samples at and past ``lengths`` come back
    zero (the reverb tail past the end is dropped); silence stays zero."""
    x = features.placed(signal, device).to(torch.float32)
    h = features.on_device(rir, x.device).to(torch.float32)
    if h.dim() == 1:
        h = h[None].expand(x.shape[0], -1)
    B, N = x.shape
    R = h.shape[-1]
    ln = features.on_device(lengths, x.device)
    m = (torch.arange(N, device=x.device) < ln[:, None]).to(x.dtype)
    x = x * m
    nfft = 1 << max(1, N + R - 2).bit_length()         # >= N + R - 1
    y = torch.fft.irfft(torch.fft.rfft(x, n=nfft) * torch.fft.rfft(
        h, n=nfft), n=nfft)[..., :N + R - 1]
    if shift_to_peak:
        d = torch.argmax(torch.abs(h), dim=-1)          # [B]
        idx = d[:, None] + torch.arange(N, device=x.device)[None, :]
        y = torch.gather(y, 1, idx)
    else:
        y = y[..., :N]
    y = y * m
    if normalize:
        p_in = torch.sum(x * x, dim=-1)
        p_out = torch.sum(y * y, dim=-1)
        scale = torch.sqrt(p_in / torch.clamp(p_out, min=1e-20))
        y = y * torch.where(p_out > 0, scale, 0.0)[:, None]
    return y


class StreamingEnergyVAD:
    """The causal sibling of :func:`energy_vad`: each frame is judged
    against the RUNNING peak frame energy (the utterance's peak is not
    known online).

    Any chunking of the same audio gives the same decisions; they equal
    the offline ones from the loudest frame on (for the whole utterance
    when it comes first), and before it they can only be more permissive.
    State: a (frame_length - 1)-sample carry and the running peak on the
    device, the fill a host int."""

    def __init__(self, batch_size: int = 1, frame_length: int = 400,
                 hop_length: int = 160, threshold_db: float = -40.0,
                 device=None):
        if hop_length > frame_length:
            raise ValueError("hop > frame_length leaves gaps")
        self.device = features.default_device(device)
        self.frame_length, self.hop_length = frame_length, hop_length
        self.threshold_db = float(threshold_db)
        self._cap = frame_length - 1
        self.buf = torch.zeros(batch_size, self._cap, device=self.device)
        self.peak_db = torch.full((batch_size,), -torch.inf,
                                  device=self.device)
        self._fill = 0

    def process(self, chunk) -> torch.Tensor:
        """[B, C] (or [C]) samples -> [B, n_new] bool speech flags."""
        chunk = features.placed(chunk, self.device).to(torch.float32)
        if chunk.dim() == 1:
            chunk = chunk[None]
        W, hop, cap = self.frame_length, self.hop_length, self._cap
        B = chunk.shape[0]
        data = torch.cat([self.buf[:, cap - self._fill:], chunk], dim=1)
        total = self._fill + chunk.shape[1]
        n_new = max(0, 1 + (total - W) // hop)
        fill = total - n_new * hop
        self.buf = torch.cat([data.new_zeros(B, cap - fill),
                              data[:, n_new * hop:]], dim=1)
        self._fill = fill
        if n_new == 0:
            return torch.zeros(B, 0, dtype=torch.bool, device=self.device)
        e_db = _frame_db(framing.frames_from_buffer(data, n_new, W, hop))
        run_peak = torch.cummax(torch.maximum(e_db, self.peak_db[:, None]),
                                dim=1).values
        self.peak_db = run_peak[:, -1]
        return e_db >= run_peak + self.threshold_db

    def reset_rows(self, rows) -> None:
        """Slot recycle: zero the rows' carry and reset their running peak
        to -inf, so that a new caller is not judged against the previous
        caller's peak. The other rows keep their bits; the decisions of
        a reset row are those of a stream that carried zeros up to the
        reset."""
        from tpufeat_torch.streaming import zero_rows
        self.buf = zero_rows(self.buf, rows)
        self.peak_db = zero_rows(self.peak_db, rows, value=-np.inf)

    def state(self) -> dict:
        return {"buf": self.buf, "peak_db": self.peak_db,
                "fill": self._fill}

    def set_state(self, s: dict) -> None:
        def put(a):
            return features.on_device(a, self.device).to(torch.float32)
        self.buf = put(s["buf"])
        self.peak_db = put(s["peak_db"])
        self._fill = int(s["fill"])


def speech_segments(speech_flags, *, min_silence: int = 30,
                    min_speech: int = 10, pad: int = 5):
    """A per-frame speech mask -> (start, end) half-open frame segments:
    [F] bool gives a list, [B, F] a list of lists. Silence gaps shorter
    than ``min_silence`` frames are bridged, segments shorter than
    ``min_speech`` dropped, and each survivor padded by ``pad`` frames a
    side (clamped to [0, F]; segments that the padding joins merge).
    Host logic over decisions that are on the host already."""
    flags = features.on_device(speech_flags, "cpu").numpy().astype(bool)
    if flags.ndim == 2:
        return [speech_segments(row, min_silence=min_silence,
                                min_speech=min_speech, pad=pad)
                for row in flags]
    F = flags.shape[0]
    edges = np.flatnonzero(np.diff(np.concatenate(
        [[False], flags, [False]]).astype(np.int8)))
    merged = []
    for s, e in zip(edges[::2], edges[1::2]):          # raw speech runs
        if merged and s - merged[-1][1] < min_silence:
            merged[-1][1] = e
        else:
            merged.append([s, e])
    out = []
    for s, e in merged:
        if e - s < min_speech:
            continue
        s, e = max(0, s - pad), min(F, e + pad)
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def segments_to_samples(segments, cfg) -> list:
    """Frame segments -> half-open sample ranges on ``cfg``'s frame grid:
    frame t covers [t*hop, t*hop + frame_length), shifted left by
    frame_length//2 (clamped at 0) for centered configs."""
    hop, flen = cfg.hop_length, cfg.frame_length
    off = flen // 2 if cfg.center else 0
    return [(max(0, s * hop - off), (e - 1) * hop + flen - off)
            for s, e in segments]


@dataclasses.dataclass(frozen=True)
class EndpointRule:
    """One endpointing rule (Kaldi ``OnlineEndpoint``): it fires when all
    of its conditions hold: speech seen since the last reset (if
    ``must_contain_speech``), trailing silence of at least
    ``min_trailing_silence_s``, and an utterance of at least
    ``min_utterance_length_s``."""
    must_contain_speech: bool = True
    min_trailing_silence_s: float = 1.0
    min_utterance_length_s: float = 0.0


#: Kaldi's classic rules for a VAD-flag front-end: give up after 5 s of
#: silence alone; close an utterance after 1 s of trailing silence once
#: speech was heard; never run past 20 s.
DEFAULT_ENDPOINT_RULES = (
    EndpointRule(must_contain_speech=False, min_trailing_silence_s=5.0),
    EndpointRule(must_contain_speech=True, min_trailing_silence_s=1.0),
    EndpointRule(must_contain_speech=True, min_trailing_silence_s=0.0,
                 min_utterance_length_s=20.0),
)


class StreamingEndpointer:
    """Per-frame speech flags (e.g. from :class:`StreamingEnergyVAD`) ->
    end-of-utterance decisions, Kaldi ``OnlineEndpoint``-style. Control
    logic: three counters per stream on the host, which depend only on the
    flag sequence, so any chunking gives the same decisions."""

    def __init__(self, rules=DEFAULT_ENDPOINT_RULES,
                 frame_shift_s: float = 0.010, batch_size: int = 1):
        if not rules:
            raise ValueError("need at least one EndpointRule")
        self.rules = tuple(rules)
        self.frame_shift_s = float(frame_shift_s)
        self.frames_seen = np.zeros(batch_size, np.int64)
        self.trailing_silence = np.zeros(batch_size, np.int64)
        self.seen_speech = np.zeros(batch_size, bool)

    def update(self, speech_flags) -> np.ndarray:
        """[B, F] (or [F]) bool speech flags -> [B] bool endpoint-now."""
        flags = features.on_device(speech_flags, "cpu").numpy().astype(bool)
        if flags.ndim == 1:
            flags = flags[None]
        B, F = flags.shape
        if B != self.frames_seen.shape[0]:
            raise ValueError(f"batch {B} != endpointer batch "
                             f"{self.frames_seen.shape[0]}")
        if F:
            self.frames_seen += F
            any_speech = flags.any(axis=1)
            self.seen_speech |= any_speech
            # the trailing silence: the leading run of False, reversed
            trailing = np.argmax(flags[:, ::-1], axis=1)
            self.trailing_silence = np.where(
                any_speech, trailing, self.trailing_silence + F)
        return self.decision()

    def decision(self) -> np.ndarray:
        """[B] bool: does any rule fire now?"""
        shift = self.frame_shift_s
        length_s = self.frames_seen * shift
        trail_s = self.trailing_silence * shift
        out = np.zeros_like(self.seen_speech)
        for r in self.rules:
            hit = (trail_s >= r.min_trailing_silence_s) \
                & (length_s >= max(r.min_utterance_length_s, shift))
            if r.must_contain_speech:
                hit &= self.seen_speech
            out |= hit
        return out

    def reset(self, row=None) -> None:
        """Start a new utterance on ``row`` (or every row)."""
        idx = slice(None) if row is None else row
        self.frames_seen[idx] = 0
        self.trailing_silence[idx] = 0
        self.seen_speech[idx] = False

    def reset_rows(self, rows) -> None:
        """:meth:`reset` under the slot-recycle name every streaming
        wrapper has."""
        self.reset(np.asarray(list(rows), int))

    def state(self) -> dict:
        return {"frames_seen": self.frames_seen.copy(),
                "trailing_silence": self.trailing_silence.copy(),
                "seen_speech": self.seen_speech.copy()}

    def set_state(self, s: dict) -> None:
        self.frames_seen = np.asarray(s["frames_seen"], np.int64).copy()
        self.trailing_silence = np.asarray(
            s["trailing_silence"], np.int64).copy()
        self.seen_speech = np.asarray(s["seen_speech"], bool).copy()


def speed_perturb(signal, sr: int, factor: float, lengths=None,
                  device=None):
    """Kaldi-style speed perturbation (0.9 / 1.0 / 1.1): resample so that
    the audio plays ``factor`` times faster (length about N / factor;
    pitch and formants move together, sox ``speed``) through the
    polyphase resampler, rate ``sr*factor -> sr``.

    With ``lengths`` (a padded batch) returns ``(y, new_lengths)``: each
    padded row's valid prefix resamples as the lone utterance does, and
    its new length is ``ceil(len * p / q)``."""
    sr_in = int(round(sr * factor))
    if sr_in <= 0:
        raise ValueError(f"factor {factor} gives non-positive rate")
    if abs(sr_in - sr * factor) > 1e-6:
        raise ValueError(f"sr*factor must be integral (got {sr * factor})")
    x = features.placed(signal, device)
    if factor == 1.0:
        y = x.to(torch.float32)
    else:
        y = resampling.resample(x, sr_in, sr)
    if lengths is None:
        return y
    n = features.on_device(lengths, "cpu").numpy().astype(np.int64)
    if factor != 1.0:
        p, q = resampling._rational(sr_in, sr)
        n = -(-n * p // q)
    return y, torch.as_tensor(n.astype(np.int32), device=y.device)
