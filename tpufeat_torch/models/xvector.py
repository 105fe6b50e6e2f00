"""X-vector speaker embeddings (Snyder et al. 2018) — counterpart of
``tpufeat/models/xvector.py``.

Frame features -> TDNN (dilated 1-D convolutions) -> masked statistics
pooling (mean and standard deviation over the valid frames) -> the
bottleneck embedding. Embeddings feed the same backend as i-vectors:
``length_normalize`` -> ``train_plda`` -> ``Plda.score``
(:mod:`tpufeat_torch.plda`). Training is softmax cross-entropy over
speaker labels (:func:`xvector_train_step`) with AdamW at optax's defaults
(:func:`tpufeat_torch.models.train.adamw`), TF32 off throughout.

The layers are flax's with its defaults and names (``tdnn0``, ``ln0``,
..., ``embed``, ``seg7``, ``head``), as in
:mod:`tpufeat_torch.models.encoder`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpufeat_torch import features
from tpufeat_torch.kernels.signal import no_tf32
from tpufeat_torch.models import encoder as enc_lib
from tpufeat_torch.models.train import TrainState, device_of, optimizer_step

__all__ = ["XvectorNet", "xvector_model", "extract_xvectors",
           "xvector_train_step", "XvectorState"]

#: an x-vector net's training state: the model, its optimizer, the step
XvectorState = TrainState

CONTEXT = ((5, 1), (3, 2), (3, 3), (1, 1), (1, 1))   # (width, dilation)


class XvectorNet(nn.Module):
    """TDNN x-vector network: [B, T, in_dim] features + [B, T] mask ->
    ([B, embed_dim] embeddings, [B, n_speakers] logits). ``embed_dim`` is
    the classic "xvector" tap (the first affine after pooling, before its
    nonlinearity, Kaldi's segment6)."""

    def __init__(self, n_speakers: int, in_dim: int, embed_dim: int = 192,
                 channels: int = 256,
                 context: Sequence[tuple[int, int]] = CONTEXT, device=None):
        super().__init__()
        self.context = tuple(context)
        n_in = in_dim
        for i, (width, dilation) in enumerate(self.context):
            self.add_module(f"tdnn{i}", enc_lib.conv(
                n_in, channels, width, dilation=dilation))
            self.add_module(f"ln{i}", enc_lib.layer_norm(channels))
            n_in = channels
        self.embed = enc_lib.dense(2 * channels, embed_dim)
        self.ln_emb = enc_lib.layer_norm(embed_dim)
        self.seg7 = enc_lib.dense(embed_dim, embed_dim)
        self.ln_seg7 = enc_lib.layer_norm(embed_dim)
        self.head = enc_lib.dense(embed_dim, n_speakers)
        enc_lib.built(self, device)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor):
        with no_tf32():
            x = feats
            m = mask.to(torch.float32)[..., None]              # [B, T, 1]
            for i in range(len(self.context)):
                x = getattr(self, f"tdnn{i}")((x * m).transpose(1, 2))
                x = F.relu(getattr(self, f"ln{i}")(x.transpose(1, 2)))
            # masked statistics pooling: mean + stddev over valid frames
            x = x * m
            n = torch.clamp(m.sum(dim=1), min=1.0)             # [B, 1]
            mean = x.sum(dim=1) / n
            var = (x * x).sum(dim=1) / n - mean * mean
            stats = torch.cat([mean, torch.sqrt(torch.clamp(var, min=1e-8))],
                              dim=-1)                          # [B, 2C]
            emb = self.embed(stats)                            # the xvector
            h = F.relu(self.ln_emb(emb))
            h = F.relu(self.ln_seg7(self.seg7(h)))
            return emb, self.head(h)


def xvector_model(n_speakers: int, *, in_dim: int = 39,
                  embed_dim: int = 192, channels: int = 256,
                  device=None) -> XvectorNet:
    """An x-vector net at Kaldi's recipe shape (channels 256, embedding
    192); ``in_dim``: the features' width (39 for ``KALDI39``)."""
    return XvectorNet(n_speakers, in_dim, embed_dim=embed_dim,
                      channels=channels, device=device)


def xvector_train_step(state: XvectorState, feats, mask, labels
                       ) -> tuple[XvectorState, torch.Tensor]:
    """One softmax cross-entropy step over speaker labels: (the updated
    state, the batch's mean loss before the update)."""
    dev = device_of(state.model)

    def loss_fn():
        _, logits = state.model(features.on_device(feats, dev).float(),
                                features.on_device(mask, dev))
        return F.cross_entropy(logits, features.on_device(labels,
                                                          dev).long())
    return optimizer_step(state, loss_fn)


def extract_xvectors(model: XvectorNet, feats, num_frames=None
                     ) -> torch.Tensor:
    """[B, T, D] padded features (+ optional [B] valid frame counts), or
    one [T, D] utterance -> [B, embed_dim] embeddings, on the model's
    device. Feed them to ``plda.length_normalize`` + ``plda.train_plda``
    like utterance i-vectors."""
    dev = device_of(model)
    feats = features.on_device(feats, dev).float()
    if feats.dim() == 2:
        feats = feats[None]
    B, T, _ = feats.shape
    if num_frames is None:
        mask = torch.ones((B, T), device=dev)
    else:
        mask = (torch.arange(T, device=dev)[None, :]
                < features.on_device(num_frames, dev)[:, None]).float()
    with torch.no_grad():
        emb, _ = model(feats, mask)
    return emb
