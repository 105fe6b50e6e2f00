"""Batched one-shot feature extraction — counterpart of ``tpufeat/features.py``.

``extract`` takes a padded batch [B, N] (or one utterance [N]) with its true
lengths and returns features, a validity mask and frame counts. Every
length-dependent reduction (Whisper's per-utterance max, CMVN, the deltas'
edge replication, PNCC's recursions) sees valid frames only, so padding
contents never leak into valid outputs.

With ``use_pallas + gemm_dft + fused_framing`` set, framing, DFT, mel, log
and DCT run in ONE kernel (``kernels/signal.py``). With ``use_pallas``
alone the frames are built first and the staged kernels run
(``kernels/staged.py``): the GEMM kernel with ``gemm_dft``, else
``torch.fft.rfft`` and the tail kernel. Each is the Hopper kernel for a
CUDA tensor and its plain twin for a CPU tensor. Otherwise the plain torch
composition runs (``torch.fft.rfft`` or the GEMM DFT, then mel, log, DCT),
every product in fp32 (:func:`matmul`); spectrogram features (``n_mels=0``)
stop at the (log-)power spectrum and always take this route. PLP
(``plp.py``) and PNCC (``pncc.py``) take the filterbank energies of any
route (log "none"). Deltas and CMVN then run as plain torch ops
(:func:`finish_impl`), as they do in the reference.

Dither adds ``cfg.dither`` times standard normal noise to the raw samples,
before pre-emphasis, drawn from the caller's ``torch.Generator`` on the
signal's device: the same generator state gives the same noise, and a
dithered call without a generator raises. The reference's JAX PRNG bits
are not reproduced.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch import framing, matrices, plp, pncc, spectrum
from tpufeat_torch.config import MFCC13_HTK, FeatureConfig
from tpufeat_torch.kernels import signal as signal_kernel
from tpufeat_torch.kernels import staged


class FeatureResult(NamedTuple):
    """features: [B, F, D] (or [F, D] for unbatched input); mask: [B, F]
    bool validity; num_frames: [B] int32 valid frame counts."""
    features: torch.Tensor
    mask: torch.Tensor
    num_frames: torch.Tensor


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def whisper_normalize(ls: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Whisper's log-mel normalization tail: clamp at the per-utterance max
    (over VALID frames only) minus 8 decades, then map to (x+4)/4."""
    if ls.numel():
        valid = torch.where(mask[..., None], ls, float("-inf"))
        m = valid.amax(dim=(-2, -1), keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)  # all-masked utterance
        ls = torch.maximum(ls, m - 8.0)
    return (ls + 4.0) / 4.0


def apply_log(mel: torch.Tensor, mask: torch.Tensor,
              cfg: FeatureConfig) -> torch.Tensor:
    """Log compression, mask-aware for the Whisper variant whose clamp
    threshold is a per-utterance max over valid frames."""
    if cfg.log == "none":
        return mel
    floored = torch.clamp(mel, min=cfg.log_floor)
    if cfg.log == "natural":
        return torch.log(floored)
    ls = torch.log10(floored)
    if cfg.log == "log10":
        return ls
    return whisper_normalize(ls, mask)


def deltas(feat: torch.Tensor, num_frames: torch.Tensor,
           window: int = 2) -> torch.Tensor:
    """Regression deltas of [B, F, D] with per-utterance edge replication:
    d_t = sum_i i * (c_{t+i} - c_{t-i}) / (2 * sum_i i^2), where t+i is
    clipped at each utterance's TRUE last frame (num_frames - 1), not at
    the padded end, and t-i at frame 0. The +-i shifts are static slices;
    each row's last valid frame is gathered once and substituted where
    t + i would cross it."""
    B, F, D = feat.shape
    if F == 0:
        return torch.zeros_like(feat)
    t = torch.arange(F, device=feat.device)[None, :, None]
    hi = torch.clamp(num_frames.to(device=feat.device, dtype=torch.int64)
                     - 1, 0, F - 1)[:, None, None]             # [B, 1, 1]
    last_valid = torch.gather(feat, 1, hi.expand(B, 1, D))
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    out = torch.zeros_like(feat)
    for i in range(1, window + 1):
        # min(i, F) keeps F rows when F < i (last_valid overwrites them)
        plus = torch.cat([feat[:, i:],
                          feat[:, -1:].expand(B, min(i, F), D)], dim=1)
        plus = torch.where(t + i > hi, last_valid, plus)
        minus = torch.cat([feat[:, :1].expand(B, min(i, F), D),
                           feat[:, :F - min(i, F)]], dim=1)
        out = out + i * (plus - minus)
    return out / denom


def frame_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., T, D] summed over its frames -> [..., 1, D], pairwise
    over T padded with zeros to a power of two: halves added, then their
    halves. The order is fixed per frame index, and frames of zeros past
    the end add exactly 0, so a row's sum depends on its own valid frames
    alone: neither on the rows beside it (a library reduction picks its
    order from the whole tensor's shape) nor on the batch's padded width.
    An utterance's CMVN is then the same bits alone, in a batch of 16 rows
    or of 64, as data-parallel corpus passes need."""
    t = x.shape[-2]
    if t <= 1:
        return x.sum(dim=-2, keepdim=True)
    h = 1 << (t - 1).bit_length() - 1           # h < t <= 2h
    x = torch.cat([x.narrow(-2, 0, t - h) + x.narrow(-2, h, t - h),
                   x.narrow(-2, t - h, 2 * h - t)], dim=-2)
    while h > 1:
        h //= 2
        x = x.narrow(-2, 0, h) + x.narrow(-2, h, h)
    return x


def cmvn(feat: torch.Tensor, mask: torch.Tensor, mode: str) -> torch.Tensor:
    """Per-utterance cepstral mean (and variance) normalization over valid
    frames only, the count clamped at 1; the sums by :func:`frame_sum`."""
    if mode == "none":
        return feat
    m = mask[..., None].to(feat.dtype)
    cnt = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
    mean = frame_sum(feat * m) / cnt
    out = feat - mean
    if mode == "meanvar":
        var = frame_sum((feat - mean) ** 2 * m) / cnt
        out = out / torch.sqrt(var + 1e-10)
    return out


def _centred(feat: torch.Tensor, nf: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, g): g the per-utterance mean [B, 1, D] over the first ``nf``
    [B, 1] frames, x = feat - g, zero past them. The sliding statistics of
    x are those of feat less g, so this changes no result, and it keeps the
    f32 cumulative sums small (within about 1e-6 of the golden over
    minutes of audio)."""
    t = torch.arange(feat.shape[1], device=feat.device)[None, :]
    mask = (t < nf).to(feat.dtype)[..., None]                  # [B, T, 1]
    g = frame_sum(feat * mask) \
        / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    return (feat - g) * mask, g


def _cumsum0(v: torch.Tensor) -> torch.Tensor:
    """cs[:, k] = sum of v[:, :k]: [B, T, D] -> [B, T + 1, D]."""
    return torch.cumsum(torch.cat([torch.zeros_like(v[:, :1]), v], dim=1),
                        dim=1)


def sliding_cmvn(feat: torch.Tensor, num_frames: torch.Tensor | None = None,
                 *, window: int = 600, min_window: int = 100,
                 center: bool = False,
                 norm_vars: bool = False) -> torch.Tensor:
    """Sliding-window CMVN over [B, T, D] padded batches (Kaldi
    ``apply-cmvn-sliding``; golden ``reference.cpu.sliding_cmvn``).

    Window per frame t, then shifted inside each utterance's
    ``num_frames``: centred ``[t - window//2, +window)``, or causal
    ``[t - window, t + 1)`` with the first frames borrowing future context
    up to ``min_window`` frames. The clamps are Kaldi's, in Kaldi's order:
    the start shift, then the ``min_window`` borrow (causal, only for
    frames whose raw window starts before 0), then the end-of-utterance
    shift. One cumulative sum per statistic over features pre-centred by
    the masked per-utterance mean (:func:`_centred`); the causal window
    sums are shifts of it, the centred ones two gathers. Padded rows get
    the last valid window's statistics and feed no window."""
    B, T, _ = feat.shape
    dev = feat.device
    if num_frames is None:
        num_frames = torch.full((B,), T, dtype=torch.int64, device=dev)
    t = torch.arange(T, device=dev)[None, :]                   # [1, T]
    nf = torch.clamp(num_frames.to(device=dev, dtype=torch.int64),
                     min=1)[:, None]                           # [B, 1]
    if center:
        ws = t - window // 2
        we = ws + window
    else:
        ws = t - window
        we = t + 1
    shift = torch.clamp(ws, max=0)
    we, ws = we - shift, torch.clamp(ws, min=0)
    if not center:
        we = torch.where(we > t + 1, torch.clamp(t + 1, min=min_window), we)
    over = torch.clamp(we - nf, min=0)
    we, ws = we - over, torch.clamp(ws - over, min=0)
    cnt = torch.clamp(we - ws, min=1).to(feat.dtype)[..., None]  # [B, T, 1]
    x, _ = _centred(feat, nf)

    if center:
        def windowed_mean(v):
            cs = _cumsum0(v)
            D = v.shape[-1]
            return (torch.gather(cs, 1, we[..., None].expand(B, T, D))
                    - torch.gather(cs, 1, ws[..., None].expand(B, T, D))
                    ) / cnt
    else:
        # cs[we] is cs[t + 1], or cs[min_window] for the frames that borrow
        # (raw window starting before 0 and t + 1 < min_window); cs[ws] is
        # cs[t - window], 0 below; the end clamps change no sum, since x is
        # zero past num_frames
        first = ((t < window) & (t + 1 < min_window))[..., None]  # [1, T, 1]
        mw = min(min_window, T)

        def windowed_mean(v):
            cs = _cumsum0(v)
            upper = cs[:, 1:]
            if mw > 1:
                upper = torch.where(first, cs[:, mw:mw + 1], upper)
            if T > window:
                lower = torch.cat([torch.zeros_like(cs[:, :window]),
                                   cs[:, :T - window]], dim=1)
                return (upper - lower) / cnt
            return upper / cnt

    mean = windowed_mean(x)
    out = x - mean
    if norm_vars:
        var = torch.clamp(windowed_mean(x * x) - mean * mean, min=1e-10)
        out = out / torch.sqrt(var)
    return out


def _prior_counts(cnt, window: int, speaker_count: float,
                  speaker_frames: int, global_count: float,
                  global_frames: int):
    """Kaldi online2 ``OnlineCmvn`` smoothing weights: while a frame's
    trailing window holds fewer than ``window`` frames, borrow up to
    ``speaker_frames`` worth of the speaker prior, then up to
    ``global_frames`` of the global prior, never more than ``window`` in
    all (Kaldi's SmoothOnlineCmvnStats)."""
    ks = torch.clamp(window - cnt, 0.0, min(float(speaker_frames),
                                            speaker_count))
    kg = torch.clamp(window - cnt - ks, 0.0, min(float(global_frames),
                                                 global_count))
    return ks, kg


def online_cmvn(feat: torch.Tensor, num_frames: torch.Tensor | None = None,
                *, window: int = 600, speaker_stats=None, global_stats=None,
                speaker_frames: int = 600, global_frames: int = 200,
                norm_vars: bool = False) -> torch.Tensor:
    """Kaldi online2 ``OnlineCmvn`` over [B, T, D] (or [T, D]): each frame
    is normalized by the trailing ``window`` frames of its own utterance,
    smoothed while fewer exist with a speaker prior (up to
    ``speaker_frames`` frames' worth), then a global prior (up to
    ``global_frames``). No future frame and no emission delay.

    ``speaker_stats`` / ``global_stats``: :class:`tpufeat_torch.data.CmvnStats`
    (``from_kaldi`` reads compute-cmvn-stats' layout) or None. The offline
    twin of ``streaming.OnlineCmvn``; golden ``reference.cpu.online_cmvn``.
    The features are pre-centred as in :func:`sliding_cmvn`, the priors
    re-centred by the same constant."""
    squeeze = feat.dim() == 2
    if squeeze:
        feat = feat[None]
    B, T, _ = feat.shape
    dev = feat.device
    if num_frames is None:
        num_frames = torch.full((B,), T, dtype=torch.int64, device=dev)
    nf = torch.clamp(num_frames.to(device=dev, dtype=torch.int64),
                     min=1)[:, None]
    t = torch.arange(T, device=dev)[None, :]
    cnt = torch.clamp(t + 1, max=window).to(feat.dtype)[..., None]
    cs = float(speaker_stats.count) if speaker_stats is not None else 0.0
    cg = float(global_stats.count) if global_stats is not None else 0.0
    ks, kg = _prior_counts(cnt, window, cs, speaker_frames, cg, global_frames)
    x, g = _centred(feat, nf)

    def winsum(v):
        c = _cumsum0(v)
        upper = c[:, 1:]                                       # cs[t+1]
        if T > window:
            lower = torch.cat([torch.zeros_like(c[:, :window]),
                               c[:, 1:T - window + 1]], dim=1)  # cs[t+1-w]
            return upper - lower
        return upper

    def prior_moments(st):
        """E[x - g] and E[(x - g)^2] under the prior."""
        if st is None:
            return 0.0, 0.0
        m = torch.as_tensor(np.asarray(st.mean), dtype=feat.dtype,
                            device=dev)
        msq = torch.as_tensor(np.asarray(st.sumsq) / max(st.count, 1.0),
                              dtype=feat.dtype, device=dev)
        return m - g, msq - 2.0 * g * m + g * g

    sm, ssq = prior_moments(speaker_stats)
    gm, gsq = prior_moments(global_stats)
    tot = cnt + ks + kg
    mean = (winsum(x) + ks * sm + kg * gm) / tot
    out = x - mean
    if norm_vars:
        e2 = (winsum(x * x) + ks * ssq + kg * gsq) / tot
        var = torch.clamp(e2 - mean * mean, min=1e-10)
        out = out / torch.sqrt(var)
    return out[0] if squeeze else out


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w in full fp32 (or x's float64), whatever the caller's TF32
    setting: every product of the plain path, as the reference pins its
    products to HIGHEST. ``w`` may be a numpy constant."""
    with signal_kernel.no_tf32():
        return x @ (w if isinstance(w, torch.Tensor) else _const(w, x))


def dct_lifter(logm: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """DCT-II + optional lifter: [..., n_mels] -> [..., n_mfcc].

    Also the post-normalization step for ``log == "whisper"`` configs with
    ``n_mfcc > 0``: the kernel emits log10-mel, the clamp needs the
    utterance max, and the DCT runs afterwards (log -> normalize -> DCT)."""
    out = matmul(logm, matrices.dct_matrix(cfg.n_mels, cfg.n_mfcc))
    if cfg.lifter > 0:
        out = out * _const(matrices.lifter_vector(cfg.n_mfcc, cfg.lifter),
                           out)
    return out


def _mel_filterbank(cfg: FeatureConfig) -> np.ndarray:
    return matrices.mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax_hz,
        cfg.mel_scale, cfg.mel_norm, cfg.mel_bin_style,
        cfg.vtln_warp, cfg.vtln_low, cfg.vtln_high)


def mel_log_dct_xla(spec: torch.Tensor, mask: torch.Tensor,
                    cfg: FeatureConfig) -> torch.Tensor:
    """Unfused tail: mel filterbank matmul -> log -> DCT (+lifter). The
    name keeps its counterpart's; here it is plain torch. ``n_mels == 0``
    (spectrogram features, Kaldi compute-spectrogram-feats): no
    filterbank, the (log-)power spectrum is the feature."""
    if cfg.n_mels == 0:
        return apply_log(spec, mask, cfg)
    logm = apply_log(matmul(spec, _mel_filterbank(cfg)), mask, cfg)
    if cfg.n_mfcc <= 0:
        return logm
    return dct_lifter(logm, cfg)


def _log_energy(frames: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """log(max(sum x^2, floor)) over each conditioned (unwindowed) frame."""
    return torch.log(torch.clamp((frames * frames).sum(dim=-1),
                                 min=cfg.log_floor))


def _replace_c0_with_energy(feat: torch.Tensor, frames: torch.Tensor,
                            cfg: FeatureConfig) -> torch.Tensor:
    """Kaldi use_energy: c0 := the frame's log energy."""
    e = _log_energy(frames, cfg).to(feat.dtype)
    return torch.cat([e[..., None], feat[..., 1:]], dim=-1)


def _apply_energy(feat: torch.Tensor, frames: torch.Tensor,
                  cfg: FeatureConfig) -> torch.Tensor:
    """Route cfg.use_energy per family: MFCC substitutes element 0; fbank
    (n_mfcc=0) PREPENDS the energy column (Kaldi compute-fbank-feats
    --use-energy, dim n_mels+1)."""
    if cfg.n_mfcc > 0 or cfg.n_mels == 0:
        return _replace_c0_with_energy(feat, frames, cfg)
    e = _log_energy(frames, cfg).to(feat.dtype)
    return torch.cat([e[..., None], feat], dim=-1)


def spectro_pipeline(frames: torch.Tensor, mask: torch.Tensor,
                     cfg: FeatureConfig, use_pallas: bool | None = None
                     ) -> torch.Tensor:
    """Conditioned (unwindowed) frames -> features: the staged path shared
    by one-shot extraction and streaming. ``use_pallas`` (default: the
    flag, for a call with frames) routes to the staged kernels; else the
    plain path (GEMM DFT when ``gemm_dft``, else rfft), then mel -> log ->
    DCT. PLP, then PNCC, take the filterbank energies, and ``use_energy``
    then puts the log frame energy in: the reference's order."""
    if use_pallas is None:
        use_pallas = cfg.use_pallas and frames.shape[-2] > 0
    if use_pallas:
        feat = staged.spectro_features(frames, mask, cfg)
    else:
        if cfg.gemm_dft:
            spec = spectrum.power_spectrum_gemm(frames, cfg)
        else:
            w = _const(matrices.window(cfg.window, cfg.frame_length), frames)
            spec = spectrum.power_spectrum_rfft(frames * w, cfg)
        feat = mel_log_dct_xla(spec, mask, cfg)
    feat = _cepstra(feat, mask, cfg)
    if cfg.use_energy:
        feat = _apply_energy(feat, frames, cfg)
    return feat


def _cepstra(energies: torch.Tensor, mask: torch.Tensor,
             cfg: FeatureConfig) -> torch.Tensor:
    """The PLP or PNCC chain over the filterbank energies (log "none"),
    frame-local or per utterance; any other config passes through."""
    if cfg.plp_order > 0:
        return plp.plp_from_energies(energies, cfg)
    if cfg.pncc:
        return pncc.pncc_from_power(energies, mask, cfg)
    return energies


def add_dither(x: torch.Tensor, cfg: FeatureConfig,
               generator: torch.Generator | None) -> torch.Tensor:
    """``x + cfg.dither * n``, n standard normal of x's shape drawn from
    ``generator`` on x's device (the reference dithers the raw samples
    with a PRNG key it requires); no change when dither is off."""
    if cfg.dither <= 0:
        return x
    if generator is None:
        raise ValueError("cfg.dither > 0 requires a generator: extract(..., "
                         "generator=torch.Generator(device).manual_seed(s))")
    noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=x.device)
    return x + cfg.dither * noise


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def features_impl(x: torch.Tensor, lengths: torch.Tensor,
                  cfg: FeatureConfig,
                  generator: torch.Generator | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw batch [B, N] -> (per-frame features [B, F, D], mask [B, F]).
    ``generator``: the dither's noise source, required iff cfg.dither > 0
    (:func:`add_dither`)."""
    if x.dtype == torch.int16:
        x = x.to(torch.float32) / 32768.0
    x = add_dither(x, cfg, generator)
    if cfg.preemphasis and not cfg.kaldi_mode:
        x = framing.preemphasize(x, cfg.preemphasis)
    F = cfg.num_frames(x.shape[-1])
    use_pallas = cfg.use_pallas and F > 0
    if use_pallas and cfg.gemm_dft and cfg.fused_framing:
        # fused path: framing happens inside the kernel, so the
        # [B, F, frame_length] tensor never exists in device memory;
        # kaldi_mode's per-frame conditioning is folded into its DFT matrix
        buf, mask = framing.framing_buffer(x, lengths, cfg)
        buf = buf.to(torch.float32).contiguous()
        feat = signal_kernel.signal_features(buf, F, cfg)
        if cfg.log == "whisper":
            feat = whisper_normalize(feat, mask)
            if cfg.n_mfcc > 0:
                feat = dct_lifter(feat, cfg)
        feat = _cepstra(feat, mask, cfg)
        if cfg.use_energy:
            frames = framing.frames_from_buffer(
                buf, F, cfg.frame_length, cfg.hop_length)
            frames = framing.condition_frames(frames, cfg)
            feat = _apply_energy(feat, frames, cfg)
    else:
        frames, mask = framing.frame_signal(x, lengths, cfg)
        frames = framing.condition_frames(frames, cfg)
        feat = spectro_pipeline(frames, mask, cfg, use_pallas=use_pallas)
    return feat, mask


def finish_impl(feat: torch.Tensor, mask: torch.Tensor,
                lengths: torch.Tensor, cfg: FeatureConfig) -> FeatureResult:
    """Second half: deltas (``cfg.delta_order`` chained stages), CMVN
    (per utterance, or sliding) and the output dtype."""
    nf = framing.num_frames_dynamic(lengths, cfg).to(torch.int32)
    if cfg.deltas:
        outs, d = [feat], feat
        for _ in range(cfg.delta_order):
            d = deltas(d, nf, cfg.delta_window)
            outs.append(d)
        feat = torch.cat(outs, dim=-1)
    if cfg.cmvn.startswith("sliding"):
        feat = sliding_cmvn(feat, nf, window=cfg.cmvn_window,
                            min_window=cfg.cmvn_min_window,
                            center=cfg.cmvn_center,
                            norm_vars=cfg.cmvn.endswith("meanvar"))
    else:
        feat = cmvn(feat, mask, cfg.cmvn)
    if cfg.out_dtype != "float32":
        feat = feat.to(getattr(torch, cfg.out_dtype))
    return FeatureResult(feat, mask, nf)


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card, ``"cuda"``.
    Without a card a default call raises: the CPU is taken only when the
    caller names it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("tpufeat_torch computes on the card by default, "
                           "and torch sees no CUDA device: pass "
                           "device=\"cpu\" to compute on the CPU")
    return torch.device("cuda")


def placed(signal, device) -> torch.Tensor:
    """``signal`` as a tensor: numpy goes to ``device`` (default the card,
    :func:`default_device`), a tensor stays where it lives and ``device``,
    if given, must name it."""
    if not isinstance(signal, torch.Tensor):
        return torch.as_tensor(np.asarray(signal),
                               device=default_device(device))
    want = torch.device(device) if device is not None else signal.device
    if signal.device.type != want.type or \
            want.index not in (None, signal.device.index):
        raise ValueError(f"signal lives on {signal.device}, not on "
                         f"{device}: move it first")
    return signal


def on_device(a, device) -> torch.Tensor:
    """``a`` (numpy, a list, a scalar or a tensor) as a tensor on
    ``device``, its dtype kept: the per-row arguments (lengths, delays,
    weights) that go beside a batch already placed."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def _prep(signal, lengths, device):
    """Input promotion: numpy goes to ``device`` (default the card), a
    tensor stays where it lives. int16 is scaled by 1/32768, float64 stays float64,
    anything else becomes float32."""
    x = placed(signal, device)
    if x.dtype == torch.int16:
        x = x.to(torch.float32) / 32768.0
    elif x.dtype != torch.float64:
        x = x.to(torch.float32)
    single = x.dim() == 1
    if single:
        x = x[None]
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                             device=x.device)
    else:
        lengths = torch.as_tensor(lengths).to(x.device, torch.int64)
    return x, lengths, single


def extract(signal, lengths=None, cfg: FeatureConfig = MFCC13_HTK,
            device=None, generator: torch.Generator | None = None
            ) -> FeatureResult:
    """WAV samples -> features. The public one-shot API.

    Args:
      signal: [N] or [B, N] float audio (int16 is scaled by 1/32768), a
        numpy array (sent to ``device``) or a tensor (computed where it
        lives).
      lengths: [B] true lengths for padded batches; default = full width.
      cfg: a :class:`FeatureConfig`.
      device: where numpy input goes; default ``"cuda"``, and a call
        without a card raises unless it passes ``device="cpu"``.
      generator: a ``torch.Generator`` on the signal's device, required
        iff ``cfg.dither > 0``: the dither noise is drawn from it.

    Returns a :class:`FeatureResult`; for 1-D input the batch axis is
    squeezed away from ``features``/``mask``/``num_frames``.
    """
    x, lengths, single = _prep(signal, lengths, device)
    feat, mask = features_impl(x, lengths, cfg, generator)
    res = finish_impl(feat, mask, lengths, cfg)
    if single:
        res = FeatureResult(res.features[0], res.mask[0], res.num_frames[0])
    return res


# ---------------------------------------------------------------------------
# Stage-level public API: wav in -> frames / spectra / mel / MFCC out. Each
# returns (values, mask). These always run the plain rfft path, whatever the
# execution flags: the fused kernel never materializes the intermediates
# these functions exist to expose. mfcc() honors the flags.
# ---------------------------------------------------------------------------

def _stage(signal, lengths, cfg, stage, device):
    x, lengths, single = _prep(signal, lengths, device)
    if cfg.preemphasis and not cfg.kaldi_mode:
        x = framing.preemphasize(x, cfg.preemphasis)
    frames_, mask = framing.frame_signal(x, lengths, cfg)
    frames_ = framing.condition_frames(frames_, cfg)
    out = frames_ * _const(matrices.window(cfg.window, cfg.frame_length),
                           frames_)
    if stage != "frames":
        out = spectrum.power_spectrum_rfft(out, cfg)
    if stage in ("mel", "logmel"):
        out = matmul(out, _mel_filterbank(cfg))
    if stage == "logmel":
        out = apply_log(out, mask, cfg)
    return (out[0], mask[0]) if single else (out, mask)


def frames(signal, lengths=None, cfg: FeatureConfig = MFCC13_HTK,
           device=None):
    """Windowed analysis frames [(B,) F, frame_length] + mask."""
    return _stage(signal, lengths, cfg, "frames", device)


def spectrogram(signal, lengths=None, cfg: FeatureConfig = MFCC13_HTK,
                device=None):
    """Power (or magnitude) spectrogram [(B,) F, n_fft//2+1] + mask."""
    return _stage(signal, lengths, cfg, "spectrogram", device)


def mel_spectrogram(signal, lengths=None, cfg: FeatureConfig = MFCC13_HTK,
                    device=None):
    """Linear mel-filterbank energies [(B,) F, n_mels] + mask."""
    return _stage(signal, lengths, cfg, "mel", device)


def logmel(signal, lengths=None, cfg: FeatureConfig = MFCC13_HTK,
           device=None):
    """Log-compressed mel features [(B,) F, n_mels] + mask."""
    return _stage(signal, lengths, cfg, "logmel", device)


def mfcc(signal, lengths=None, cfg: FeatureConfig = MFCC13_HTK,
         device=None):
    """MFCCs [(B,) F, n_mfcc] + mask (no deltas/CMVN: :func:`extract` runs
    the whole configured pipeline)."""
    base = dataclasses.replace(cfg, deltas=False, cmvn="none")
    res = extract(signal, lengths, base, device)
    return res.features, res.mask


def extract_chunked(signal, lengths=None, cfg: FeatureConfig = MFCC13_HTK,
                    rows_per_dispatch: int = 128, device=None,
                    generator: torch.Generator | None = None
                    ) -> FeatureResult:
    """:func:`extract` over slices of at most ``rows_per_dispatch`` rows of
    the batch, concatenated: exact, since no stage couples utterances. It
    bounds the device memory of one call on a very large batch. With
    dither, each slice draws its noise from ``generator`` in turn."""
    x, lengths, single = _prep(signal, lengths, device)
    parts = []
    for r in range(0, x.shape[0], rows_per_dispatch):
        rows = slice(r, r + rows_per_dispatch)
        feat, mask = features_impl(x[rows], lengths[rows], cfg, generator)
        parts.append(finish_impl(feat, mask, lengths[rows], cfg))
    res = FeatureResult(*(torch.cat(p, dim=0) for p in zip(*parts)))
    if single:
        res = FeatureResult(res.features[0], res.mask[0], res.num_frames[0])
    return res


def make_extractor(cfg: FeatureConfig, device=None,
                   generator: torch.Generator | None = None):
    """A ``(signal, lengths=None, generator=None) -> FeatureResult``
    closure over ``cfg`` and ``device`` (default the card): :func:`extract`
    with both bound, for a server that calls one configuration many times.
    ``generator`` is the dither's default noise source; a call may pass its
    own."""
    def run(signal, lengths=None, generator=generator) -> FeatureResult:
        return extract(signal, lengths, cfg, device, generator)
    return run
