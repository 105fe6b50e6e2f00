"""ASR encoders fed by the front-end — counterpart of
``tpufeat/models/encoder.py`` (config 5 / ``BASELINE.json:configs[4]``).

Two encoder families, both ``torch.nn`` and mask-aware, so batched
variable-length utterances run at one shape:

- :class:`WhisperEncoder` — Whisper-style: two GELU convs (the second
  stride-2), fixed sinusoidal positions, pre-LN transformer blocks.
  :func:`whisper_tiny` is the tiny architecture (d=384, 4 layers, 6 heads).
- :class:`ConformerEncoder` — Conformer blocks (macaron FFN halves, MHSA,
  depthwise-conv module), subsampled input projection.

The layers are flax's, with its defaults: LayerNorm's epsilon is 1e-6,
GELU is the tanh approximation, kernels start lecun-normal (a normal
truncated at two standard deviations) and biases at zero, and a
``padding="SAME"`` convolution pads ``(k - 1) * dilation`` with the smaller
half first. Submodules carry flax's automatic names (``Conv_0``,
``TransformerBlock_0``, ``MHSA_0``, ...), so a flax params tree maps onto
the state dict name for name (:mod:`tpufeat_torch.models.convert`).

Input sizes are constructor arguments (flax infers them at ``init``):
``in_dim`` is the feature width. A model is built on the CPU from torch's
global generator, so a seed gives the same weights on every device, then
moved to ``device`` (default the card, :func:`features.default_device`).
Every forward runs with TF32 off for matrix products and cuDNN
convolutions (``kernels.signal.no_tf32``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpufeat_torch import features
from tpufeat_torch.kernels.signal import no_tf32

__all__ = ["sinusoids", "MHSA", "TransformerBlock", "WhisperEncoder",
           "ConvModule", "FFModule", "ConformerBlock", "ConformerEncoder",
           "whisper_tiny", "conformer_small", "LN_EPS"]

#: flax ``nn.LayerNorm``'s epsilon (torch's default is 1e-5)
LN_EPS = 1e-6
#: the additive attention bias on padded keys
MASKED = -1e9


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Fixed sinusoidal position embedding (Whisper-style), float32."""
    assert channels % 2 == 0
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)],
                          axis=1).astype(np.float32)


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: variance 1/fan_in, a normal truncated at
    two standard deviations (the scale corrects for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


def dense(n_in: int, n_out: int, bias: bool = True) -> nn.Linear:
    """flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    lin = nn.Linear(n_in, n_out, bias=bias)
    with torch.no_grad():
        lecun_normal_(lin.weight, n_in)
        if bias:
            lin.bias.zero_()
    return lin


def conv(n_in: int, n_out: int, width: int, stride: int = 1,
         padding: int | str = "same", dilation: int = 1,
         groups: int = 1) -> nn.Conv1d:
    """flax ``nn.Conv`` over [B, C, T]: lecun-normal kernel over its
    receptive field, zero bias. ``padding="same"`` is XLA's SAME (the
    smaller half first, torch's rule too); an int pads both sides."""
    c = nn.Conv1d(n_in, n_out, width, stride=stride, padding=padding,
                  dilation=dilation, groups=groups)
    with torch.no_grad():
        lecun_normal_(c.weight, n_in // groups * width)
        c.bias.zero_()
    return c


def layer_norm(dim: int) -> nn.LayerNorm:
    """flax ``nn.LayerNorm``: epsilon 1e-6, scale 1, bias 0."""
    return nn.LayerNorm(dim, eps=LN_EPS)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def attn_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool -> additive [B, 1, 1, T] bias (-1e9 on padding)."""
    return torch.where(mask, 0.0, MASKED).to(torch.float32)[:, None, None, :]


def built(module: nn.Module, device) -> nn.Module:
    """``module`` (built on the CPU) on ``device``, default the card."""
    return module.to(features.default_device(device))


class MHSA(nn.Module):
    """Multi-head self-attention: separate q, k, v and out projections,
    ``k`` without a bias; ``bias`` masks padded keys additively."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q = dense(dim, dim)
        self.k = dense(dim, dim, bias=False)
        self.v = dense(dim, dim)
        self.out = dense(dim, dim)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        hd = self.dim // self.heads
        q, k, v = (p(x).reshape(B, T, self.heads, hd).transpose(1, 2)
                   for p in (self.q, self.k, self.v))
        logits = q @ k.transpose(-1, -2) / math.sqrt(hd) + bias
        out = torch.softmax(logits, dim=-1) @ v
        return self.out(out.transpose(1, 2).reshape(B, T, self.dim))


class TransformerBlock(nn.Module):
    """Pre-LN transformer block: attention, then a GELU MLP."""

    def __init__(self, dim: int, heads: int, mlp_mult: int = 4):
        super().__init__()
        self.LayerNorm_0 = layer_norm(dim)
        self.MHSA_0 = MHSA(dim, heads)
        self.LayerNorm_1 = layer_norm(dim)
        self.Dense_0 = dense(dim, dim * mlp_mult)
        self.Dense_1 = dense(dim * mlp_mult, dim)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.MHSA_0(self.LayerNorm_0(x), bias)
        h = gelu(self.Dense_0(self.LayerNorm_1(x)))
        return x + self.Dense_1(h)


class WhisperEncoder(nn.Module):
    """Whisper-style audio encoder: log-mel [B, T, in_dim] (+ [B, T] bool
    mask) -> ([B, ceil(T/2), dim], [B, ceil(T/2)] mask)."""

    def __init__(self, dim: int = 384, layers: int = 4, heads: int = 6,
                 max_frames: int = 3000, in_dim: int = 80, device=None):
        super().__init__()
        self.dim, self.layers, self.heads = dim, layers, heads
        self.Conv_0 = conv(in_dim, dim, 3, padding=1)
        self.Conv_1 = conv(dim, dim, 3, stride=2, padding=1)
        for i in range(layers):
            self.add_module(f"TransformerBlock_{i}",
                            TransformerBlock(dim, heads))
        self.LayerNorm_0 = layer_norm(dim)
        self.register_buffer("positions", torch.from_numpy(
            sinusoids(max_frames, dim)), persistent=False)
        built(self, device)

    def forward(self, mel: torch.Tensor, mask: torch.Tensor | None = None):
        B, T, _ = mel.shape
        if mask is None:
            mask = torch.ones((B, T), dtype=torch.bool, device=mel.device)
        with no_tf32():
            # zero padding frames so the convs' receptive fields cannot
            # leak padding into valid positions (mask invariance)
            x = (mel * mask[..., None]).transpose(1, 2)
            x = gelu(self.Conv_0(x))
            x = gelu(self.Conv_1(x)).transpose(1, 2)
            t2 = x.shape[1]
            x = x + self.positions[None, :t2]
            mask2 = mask[:, ::2][:, :t2]
            bias = attn_bias(mask2)
            for i in range(self.layers):
                x = getattr(self, f"TransformerBlock_{i}")(x, bias)
            return self.LayerNorm_0(x), mask2


class ConvModule(nn.Module):
    """Conformer convolution module: LN, GLU pointwise, masked depthwise
    conv (SAME), LN (in place of BatchNorm: no batch statistics), swish,
    pointwise."""

    def __init__(self, dim: int, kernel: int = 15):
        super().__init__()
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_0 = dense(dim, 2 * dim)
        self.Conv_0 = conv(dim, dim, kernel, groups=dim)
        self.LayerNorm_1 = layer_norm(dim)
        self.Dense_1 = dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = F.glu(self.Dense_0(self.LayerNorm_0(x)), dim=-1)
        h = h * mask[..., None]  # keep padding out of the depthwise conv
        h = self.Conv_0(h.transpose(1, 2)).transpose(1, 2)
        return self.Dense_1(F.silu(self.LayerNorm_1(h)))


class FFModule(nn.Module):
    """Conformer feed-forward half: LN, swish MLP."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_0 = dense(dim, dim * mult)
        self.Dense_1 = dense(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.silu(self.Dense_0(self.LayerNorm_0(x))))


class ConformerBlock(nn.Module):
    """Macaron FFN halves around attention and the conv module, final LN."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.FFModule_0 = FFModule(dim)
        self.LayerNorm_0 = layer_norm(dim)
        self.MHSA_0 = MHSA(dim, heads)
        self.ConvModule_0 = ConvModule(dim)
        self.FFModule_1 = FFModule(dim)
        self.LayerNorm_1 = layer_norm(dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.FFModule_0(x)
        x = x + self.MHSA_0(self.LayerNorm_0(x), bias)
        x = x + self.ConvModule_0(x, mask)
        x = x + 0.5 * self.FFModule_1(x)
        return self.LayerNorm_1(x)


class ConformerEncoder(nn.Module):
    """Conformer encoder: features [B, T, in_dim] (+ [B, T] bool mask) ->
    ([B, ceil(T/subsample), dim], its mask)."""

    def __init__(self, dim: int = 144, layers: int = 4, heads: int = 4,
                 subsample: int = 2, in_dim: int = 80, device=None):
        super().__init__()
        self.dim, self.layers, self.subsample = dim, layers, subsample
        self.Dense_0 = dense(in_dim, dim)
        if subsample > 1:
            self.Dense_1 = dense(subsample * dim, dim)
        for i in range(layers):
            self.add_module(f"ConformerBlock_{i}", ConformerBlock(dim, heads))
        built(self, device)

    def forward(self, feat: torch.Tensor, mask: torch.Tensor | None = None):
        B, T, _ = feat.shape
        if mask is None:
            mask = torch.ones((B, T), dtype=torch.bool, device=feat.device)
        with no_tf32():
            feat = feat * mask[..., None]  # see WhisperEncoder: invariance
            s = self.subsample
            x = self.Dense_0(feat)
            if s > 1:
                pad = (-T) % s
                x = F.pad(x, (0, 0, 0, pad))
                m = F.pad(mask, (0, pad))
                x = self.Dense_1(x.reshape(B, -1, s * self.dim))
                mask = m.reshape(B, -1, s).any(dim=-1)
            bias = attn_bias(mask)
            mf = mask.to(x.dtype)
            for i in range(self.layers):
                x = getattr(self, f"ConformerBlock_{i}")(x, mf, bias)
            return x, mask


def whisper_tiny(in_dim: int = 80, device=None) -> WhisperEncoder:
    return WhisperEncoder(dim=384, layers=4, heads=6, in_dim=in_dim,
                          device=device)


def conformer_small(in_dim: int = 80, device=None) -> ConformerEncoder:
    return ConformerEncoder(dim=144, layers=4, heads=4, in_dim=in_dim,
                            device=device)
