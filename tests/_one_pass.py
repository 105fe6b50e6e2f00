"""A numpy oracle of the port's twins at matmul_precision="default": every
product x @ W as bf16_rn(x) @ bf16_rn(W), summed in float64, with the TPU
kernels' order (DFT, square or |X|, mel, floored log, DCT) for the signal
twin and K3 (:func:`features`), and from the mel product on for K4
(:func:`tail_features`). The bf16 rounding is done on the float32 bits
here, independently of torch.
"""

import numpy as np

from tpufeat_torch.kernels import signal, staged


def bf16(a) -> np.ndarray:
    """float32 values rounded to bf16 (nearest, ties to even), as float64."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def features(frames: np.ndarray, cfg, fold_kaldi: bool = True,
             log_mel: bool = False) -> np.ndarray:
    """frames [..., frame_length] -> [..., D] at one bf16 pass per product;
    ``log_mel`` stops before the DCT. Each f32 stage of the kernel is
    rounded to f32 before its split, as there."""
    cs = signal.cs_constant(cfg, fold_kaldi)
    z = (bf16(frames) @ bf16(cs)).astype(np.float32)
    sq = (z * z).astype(np.float32)
    if cfg.spectrum == "magnitude":
        nb = cfg.n_bins
        im2 = np.zeros_like(sq[..., :nb])
        im2[..., 1: nb - 1] = sq[..., nb:]
        sq = np.sqrt(sq[..., :nb] + im2).astype(np.float32)
    mel = (bf16(sq) @ bf16(signal.fb_constant(cfg))).astype(np.float32)
    return _log_dct(mel, cfg, log_mel)


def tail_features(spec: np.ndarray, cfg) -> np.ndarray:
    """Spectrum rows [..., n_bins] -> [..., D] at one bf16 pass per
    product: K4's function."""
    mel = (bf16(spec) @ bf16(staged.tail_fb_constant(cfg))).astype(np.float32)
    return _log_dct(mel, cfg, False)


def _log_dct(mel: np.ndarray, cfg, log_mel: bool) -> np.ndarray:
    if cfg.log in ("natural",):
        mel = np.log(np.maximum(mel, np.float32(cfg.log_floor)))
    elif cfg.log in ("log10", "whisper"):
        mel = np.log10(np.maximum(mel, np.float32(cfg.log_floor)))
    mel = mel.astype(np.float32)
    dct = signal.dct_constant(cfg)
    if dct is None or log_mel:
        return mel
    return (bf16(mel) @ bf16(dct)).astype(np.float32)


def frames_of(buf: np.ndarray, n_frames: int, cfg) -> np.ndarray:
    """The frames [B, n_frames, frame_length] of a framing buffer, zeros
    past its end."""
    fl, hop = cfg.frame_length, cfg.hop_length
    need = (n_frames - 1) * hop + fl
    pad = np.zeros((buf.shape[0], max(need, buf.shape[1])), np.float32)
    pad[:, :buf.shape[1]] = buf
    idx = np.arange(n_frames)[:, None] * hop + np.arange(fl)[None, :]
    return pad[:, idx]
