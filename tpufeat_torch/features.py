"""Batched one-shot feature extraction — counterpart of ``tpufeat/features.py``.

``extract`` takes a padded batch [B, N] (or one utterance [N]) with its true
lengths and returns features, a validity mask and frame counts. Every
length-dependent reduction (Whisper's per-utterance max) sees valid frames
only, so padding contents never leak into valid outputs.

With ``use_pallas + gemm_dft + fused_framing`` set, framing, DFT, mel, log
and DCT run in ONE kernel (``kernels/signal.py``): the Hopper kernel for a
CUDA tensor, its plain twin for a CPU tensor. Otherwise the plain torch
composition runs (``torch.fft.rfft`` or the GEMM DFT, then mel, log, DCT).
Configs this slice does not cover raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch import framing, matrices, spectrum
from tpufeat_torch.config import MFCC13_HTK, FeatureConfig
from tpufeat_torch.kernels import signal as signal_kernel


class FeatureResult(NamedTuple):
    """features: [B, F, D] (or [F, D] for unbatched input); mask: [B, F]
    bool validity; num_frames: [B] int32 valid frame counts."""
    features: torch.Tensor
    mask: torch.Tensor
    num_frames: torch.Tensor


def _refuse_unported(cfg: FeatureConfig) -> None:
    """Raise for a config this slice does not cover: it is refused, not
    run some other way."""
    unported = [
        (cfg.deltas, "deltas", "queue 1, item 5 (Kaldi-39)"),
        (cfg.cmvn != "none", f"cmvn={cfg.cmvn!r}",
         "queue 1, item 5 (Kaldi-39)"),
        (cfg.plp_order > 0, "plp_order", "queue 1, item 7"),
        (cfg.pncc, "pncc", "queue 1, item 7"),
        (cfg.use_energy, "use_energy", "queue 1, item 7"),
        (cfg.dither > 0, "dither", "queue 1, item 7"),
        (cfg.n_mels == 0, "n_mels=0 (spectrogram features)",
         "queue 1, item 7"),
        (cfg.use_pallas and not (cfg.gemm_dft and cfg.fused_framing),
         "use_pallas without gemm_dft + fused_framing (the staged kernels)",
         "queue 2, items 2-3"),
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


def spectro_pipeline(frames: torch.Tensor, mask: torch.Tensor,
                     cfg: FeatureConfig) -> torch.Tensor:
    """Conditioned (unwindowed) frames -> features: the plain path (GEMM DFT
    when ``gemm_dft``, else rfft), then mel -> log -> DCT."""
    if cfg.gemm_dft:
        spec = spectrum.power_spectrum_gemm(frames, cfg)
    else:
        w = _const(matrices.window(cfg.window, cfg.frame_length), frames)
        spec = spectrum.power_spectrum_rfft(frames * w, cfg)
    return mel_log_dct_xla(spec, mask, cfg)


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
    if cfg.use_pallas and F > 0:
        # fused path: framing happens inside the kernel, so the
        # [B, F, frame_length] tensor never exists in device memory;
        # kaldi_mode's per-frame conditioning is folded into its DFT matrix
        buf, mask = framing.framing_buffer(x, lengths, cfg)
        feat = signal_kernel.signal_features(
            buf.to(torch.float32).contiguous(), F, cfg)
        if cfg.log == "whisper":
            feat = whisper_normalize(feat, mask)
            if cfg.n_mfcc > 0:
                feat = dct_lifter(feat, cfg)
    else:
        frames, mask = framing.frame_signal(x, lengths, cfg)
        frames = framing.condition_frames(frames, cfg)
        feat = spectro_pipeline(frames, mask, cfg)
    return feat, mask


def finish_impl(feat: torch.Tensor, mask: torch.Tensor,
                lengths: torch.Tensor, cfg: FeatureConfig) -> FeatureResult:
    """Frame counts and the output dtype (deltas and CMVN are refused by
    :func:`features_impl` until the Kaldi-39 slice)."""
    nf = framing.num_frames_dynamic(lengths, cfg).to(torch.int32)
    if cfg.out_dtype != "float32":
        feat = feat.to(getattr(torch, cfg.out_dtype))
    return FeatureResult(feat, mask, nf)


def _prep(signal, lengths, device):
    """Input promotion: numpy goes to ``device`` (default CPU), a tensor
    stays where it lives. int16 is scaled by 1/32768, float64 stays float64,
    anything else becomes float32."""
    if isinstance(signal, torch.Tensor):
        x = signal
        want = torch.device(device) if device is not None else x.device
        if x.device.type != want.type or \
                want.index not in (None, x.device.index):
            raise ValueError(f"signal lives on {x.device}, not on {device}: "
                             "move it first")
    else:
        x = torch.as_tensor(np.asarray(signal), device=device or "cpu")
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
