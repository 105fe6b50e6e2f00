"""Batched one-shot feature extraction — counterpart of ``tpufeat/features.py``.

``extract`` takes a padded batch [B, N] (or one utterance [N]) with its true
lengths and returns features, a validity mask and frame counts. Every
length-dependent reduction (Whisper's per-utterance max) sees valid frames
only, so padding contents never leak into valid outputs.

With ``use_pallas + gemm_dft + fused_framing`` set, framing, DFT, mel, log
and DCT run in ONE kernel (``kernels/signal.py``). With ``use_pallas``
alone the frames are built first and the staged kernels run
(``kernels/staged.py``): the GEMM kernel with ``gemm_dft``, else
``torch.fft.rfft`` and the tail kernel. Each is the Hopper kernel for a
CUDA tensor and its plain twin for a CPU tensor. Otherwise the plain torch
composition runs (``torch.fft.rfft`` or the GEMM DFT, then mel, log, DCT).
Configs the port does not cover yet raise ``NotImplementedError`` naming
the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch import framing, matrices, spectrum
from tpufeat_torch.config import MFCC13_HTK, FeatureConfig
from tpufeat_torch.kernels import signal as signal_kernel
from tpufeat_torch.kernels import staged


class FeatureResult(NamedTuple):
    """features: [B, F, D] (or [F, D] for unbatched input); mask: [B, F]
    bool validity; num_frames: [B] int32 valid frame counts."""
    features: torch.Tensor
    mask: torch.Tensor
    num_frames: torch.Tensor


def _refuse_unported(cfg: FeatureConfig) -> None:
    """Raise for a config the port does not cover yet: it is refused, not
    run some other way."""
    unported = [
        (cfg.deltas, "deltas", "queue 1, item 5 (Kaldi-39)"),
        (cfg.cmvn != "none", f"cmvn={cfg.cmvn!r}",
         "queue 1, item 5 (Kaldi-39)"),
        (cfg.plp_order > 0, "plp_order", "queue 1, item 7"),
        (cfg.pncc, "pncc", "queue 1, item 7"),
        (cfg.dither > 0, "dither", "queue 1, item 7"),
        (cfg.n_mels == 0, "n_mels=0 (spectrogram features)",
         "queue 1, item 7"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to tpufeat_torch yet: ROADMAP.md {item}")


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


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def dct_lifter(logm: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """DCT-II + optional lifter: [..., n_mels] -> [..., n_mfcc].

    Also the post-normalization step for ``log == "whisper"`` configs with
    ``n_mfcc > 0``: the kernel emits log10-mel, the clamp needs the
    utterance max, and the DCT runs afterwards (log -> normalize -> DCT)."""
    out = logm @ _const(matrices.dct_matrix(cfg.n_mels, cfg.n_mfcc), logm)
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
    name keeps its counterpart's; here it is plain torch."""
    logm = apply_log(spec @ _const(_mel_filterbank(cfg), spec), mask, cfg)
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
    DCT. ``use_energy`` then puts the log frame energy in."""
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
    if cfg.use_energy:
        feat = _apply_energy(feat, frames, cfg)
    return feat


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def features_impl(x: torch.Tensor, lengths: torch.Tensor,
                  cfg: FeatureConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw batch [B, N] -> (per-frame features [B, F, D], mask [B, F])."""
    _refuse_unported(cfg)
    if x.dtype == torch.int16:
        x = x.to(torch.float32) / 32768.0
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
    """Frame counts and the output dtype (deltas and CMVN are refused by
    :func:`features_impl` until the Kaldi-39 slice)."""
    nf = framing.num_frames_dynamic(lengths, cfg).to(torch.int32)
    if cfg.out_dtype != "float32":
        feat = feat.to(getattr(torch, cfg.out_dtype))
    return FeatureResult(feat, mask, nf)


def placed(signal, device) -> torch.Tensor:
    """``signal`` as a tensor: numpy goes to ``device`` (default CPU), a
    tensor stays where it lives and ``device``, if given, must name it."""
    if not isinstance(signal, torch.Tensor):
        return torch.as_tensor(np.asarray(signal), device=device or "cpu")
    want = torch.device(device) if device is not None else signal.device
    if signal.device.type != want.type or \
            want.index not in (None, signal.device.index):
        raise ValueError(f"signal lives on {signal.device}, not on "
                         f"{device}: move it first")
    return signal


def _prep(signal, lengths, device):
    """Input promotion: numpy goes to ``device`` (default CPU), a tensor
    stays where it lives. int16 is scaled by 1/32768, float64 stays float64,
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
            device=None) -> FeatureResult:
    """WAV samples -> features. The public one-shot API.

    Args:
      signal: [N] or [B, N] float audio (int16 is scaled by 1/32768), a
        numpy array (sent to ``device``) or a tensor (computed where it
        lives).
      lengths: [B] true lengths for padded batches; default = full width.
      cfg: a :class:`FeatureConfig`.
      device: where numpy input goes, e.g. ``"cuda"``; default CPU.

    Returns a :class:`FeatureResult`; for 1-D input the batch axis is
    squeezed away from ``features``/``mask``/``num_frames``.
    """
    x, lengths, single = _prep(signal, lengths, device)
    feat, mask = features_impl(x, lengths, cfg)
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
        out = out @ _const(_mel_filterbank(cfg), out)
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
    """MFCCs [(B,) F, n_mfcc] + mask (no deltas/CMVN)."""
    base = dataclasses.replace(cfg, deltas=False, cmvn="none")
    res = extract(signal, lengths, base, device)
    return res.features, res.mask
