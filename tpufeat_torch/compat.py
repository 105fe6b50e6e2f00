"""Drop-in shims for existing toolchains — counterpart of
``tpufeat/compat.py``.

:class:`WhisperFeatureExtractor` mirrors the call surface of
``transformers.WhisperFeatureExtractor`` so a Hugging Face pipeline can
switch front-ends by changing one import:

    from tpufeat_torch.compat import WhisperFeatureExtractor
    fe = WhisperFeatureExtractor()                  # same defaults
    batch = fe([wav1, wav2], sampling_rate=16000)
    batch["input_features"]                         # [B, 80, 3000]

The compute is one batched :func:`tpufeat_torch.extract`: on the card the
fused route at bf16x3 (the hand-written signal kernel), on the CPU the
plain path at "highest". ``return_tensors="pt"`` is this framework's
counterpart of the reference's ``"jax"``.

:class:`TorchWavDataset`, :func:`pad_collate` and :class:`FeatureLoader`
are the ``torch.utils.data`` integration: WAVs decode and pad in the
DataLoader's worker processes (numpy only: a forked worker must not touch
CUDA), and the features are extracted in the main process on the card.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch

from tpufeat_torch import data, features, io
from tpufeat_torch.config import WHISPER80

__all__ = ["WhisperFeatureExtractor", "TorchWavDataset", "pad_collate",
           "FeatureLoader"]


class WhisperFeatureExtractor:
    """API-compatible subset of ``transformers.WhisperFeatureExtractor``.

    Supported surface: the constructor geometry arguments, ``__call__``
    with list/array input, ``padding="max_length"`` (Whisper's only
    deployed mode: zero-pad/truncate every utterance to ``chunk_length``
    seconds, normalization max over ALL frames including padding),
    ``return_tensors`` in {"np", "pt"}, and ``return_attention_mask``
    (frame-level validity). Unsupported corners (``padding=False``,
    ``return_token_timestamps``) raise rather than silently diverge.

    ``device``: where the features are computed, default the card (a call
    without one raises unless ``device="cpu"``). ``"pt"`` tensors stay
    there."""

    def __init__(self, feature_size: int = 80, sampling_rate: int = 16000,
                 hop_length: int = 160, chunk_length: int = 30,
                 n_fft: int = 400, padding_value: float = 0.0,
                 device=None):
        self.feature_size = feature_size
        self.sampling_rate = sampling_rate
        self.hop_length = hop_length
        self.chunk_length = chunk_length
        self.n_fft = n_fft
        self.padding_value = padding_value
        self.n_samples = chunk_length * sampling_rate
        self.nb_max_frames = self.n_samples // hop_length
        self.device = features.default_device(device)
        on_card = self.device.type == "cuda"
        self.config = dataclasses.replace(
            WHISPER80, sample_rate=sampling_rate, n_mels=feature_size,
            frame_length=n_fft, n_fft=n_fft, hop_length=hop_length,
            use_pallas=on_card, gemm_dft=on_card, fused_framing=on_card,
            matmul_precision="bf16x3" if on_card else "highest")

    @classmethod
    def from_pretrained(cls, path: str, **overrides):
        """Construct from a LOCAL checkpoint directory (or a direct
        ``preprocessor_config.json`` path): the fields this shim supports
        are read, everything else in the file is ignored. Hub names are
        refused (no downloads: the features depend only on the geometry
        fields)."""
        p = (os.path.join(path, "preprocessor_config.json")
             if os.path.isdir(path) else path)
        if not os.path.exists(p):
            raise ValueError(
                f"{path!r} is not a local checkpoint dir or config file "
                "(hub downloads are not supported; pass a local path)")
        with open(p) as f:
            d = json.load(f)
        kind = d.get("feature_extractor_type", "WhisperFeatureExtractor")
        if kind != "WhisperFeatureExtractor":
            raise ValueError(
                f"{p}: feature_extractor_type is {kind!r}; this shim "
                "implements WhisperFeatureExtractor semantics only")
        kw = {k: d[k] for k in ("feature_size", "sampling_rate",
                                "hop_length", "chunk_length", "n_fft",
                                "padding_value") if k in d}
        kw.update(overrides)
        return cls(**kw)

    def __call__(self, raw_speech, sampling_rate: int | None = None,
                 return_tensors: str = "np", padding: str = "max_length",
                 max_length: int | None = None, truncation: bool = True,
                 return_attention_mask: bool = False, **kwargs):
        if kwargs:
            raise TypeError(f"unsupported arguments: {sorted(kwargs)}")
        if padding != "max_length":
            raise ValueError(
                "only padding='max_length' (Whisper's deployed mode) is "
                f"supported, got {padding!r}")
        if return_tensors not in ("np", "pt"):
            raise ValueError(
                f"return_tensors={return_tensors!r} not supported "
                "(use 'np' or 'pt')")
        if sampling_rate is not None and sampling_rate != self.sampling_rate:
            raise ValueError(
                f"input sampling_rate {sampling_rate} != extractor's "
                f"{self.sampling_rate}; resample first "
                "(tpufeat_torch.resample)")
        n = self.n_samples if max_length is None else max_length
        utts = self._as_list(raw_speech)
        true_lens = []
        batch = np.full((len(utts), n), self.padding_value, np.float32)
        for i, u in enumerate(utts):
            u = np.asarray(u, np.float32).reshape(-1)
            if len(u) > n:
                if not truncation:
                    raise ValueError(
                        f"utterance {i} is {len(u)} samples > max "
                        f"{n} and truncation=False")
                u = u[:n]
            batch[i, : len(u)] = u
            true_lens.append(len(u))

        # transformers semantics: the padding is REAL audio (the
        # normalization max runs over all frames), so lengths = full n
        res = features.extract(batch, np.full((len(utts),), n, np.int64),
                               self.config, device=self.device)
        feats = res.features.transpose(-1, -2)           # [B, mel, T]
        out = {"input_features": feats}
        if return_attention_mask:
            t = np.arange(feats.shape[-1])[None, :]
            # transformers strides a sample-level mask by hop: ceil(len /
            # hop) frames, not this package's drop-last num_frames
            nf = np.minimum(
                -(-np.asarray(true_lens, np.int64) // self.hop_length),
                feats.shape[-1])
            out["attention_mask"] = torch.from_numpy(
                (t < nf[:, None]).astype(np.int32)).to(feats.device)
        if return_tensors == "np":
            out = {k: v.cpu().numpy() for k, v in out.items()}
        return _BatchFeature(out)

    @staticmethod
    def _as_list(raw_speech) -> Sequence[np.ndarray]:
        if isinstance(raw_speech, (list, tuple)):
            return [np.asarray(u) for u in raw_speech]
        arr = np.asarray(raw_speech)
        if arr.ndim == 1:
            return [arr]
        if arr.ndim == 2:
            return list(arr)
        raise ValueError(f"raw_speech must be 1-D, 2-D, or a list; got "
                         f"shape {arr.shape}")


class TorchWavDataset(torch.utils.data.Dataset):
    """Map-style ``torch.utils.data.Dataset`` over WAV paths.

    ``__getitem__`` returns ``(samples float32 [-1, 1], key)``, decoded by
    ``io.read_wav(native=)`` in the DataLoader's workers (numpy only: no
    CUDA state in a worker), while feature extraction belongs in the MAIN
    process on the card: pair this with :func:`pad_collate` and
    :class:`FeatureLoader`.

        ds = TorchWavDataset(paths)
        dl = torch.utils.data.DataLoader(ds, batch_size=64, num_workers=8,
                                         collate_fn=pad_collate)
        for batch in FeatureLoader(dl, KALDI39):
            batch["features"]        # torch.Tensor [B, T, D] on the card
    """

    def __init__(self, paths: Sequence[str], *, native: bool | None = None,
                 expected_rate: int | None = 16000):
        self.paths = list(paths)
        self.native = native
        self.expected_rate = expected_rate

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int):
        samples, rate = io.read_wav(self.paths[i], native=self.native)
        # a silent rate mismatch gives silently wrong features downstream;
        # expected_rate=None opts out for corpora resampled in the collate
        if self.expected_rate is not None and rate != self.expected_rate:
            raise ValueError(
                f"{self.paths[i]}: sample rate {rate} != expected "
                f"{self.expected_rate}; resample (tpufeat_torch.resample) "
                "or construct with expected_rate=None")
        return np.asarray(samples, np.float32), self.paths[i]


def pad_collate(batch, *, bucket: bool = True):
    """DataLoader ``collate_fn`` for ragged audio: a list of ``(samples,
    key)`` (or bare arrays) -> a dict with numpy ``signal [B, N]``,
    ``lengths [B]`` and ``keys``. With ``bucket`` the padded length snaps
    to the sqrt(2) grid (``data.bucket_length``), so a corpus comes in a
    handful of batch shapes. Numpy only: safe in DataLoader workers."""
    items = [(b, None) if not isinstance(b, tuple) else b for b in batch]
    sigs = [np.asarray(s, np.float32).reshape(-1) for s, _ in items]
    n = max((len(s) for s in sigs), default=0)
    if bucket:
        n = data.bucket_length(max(n, 1))
    x, lengths = data.pad_batch(sigs, target_len=n)
    return {"signal": x, "lengths": lengths,
            "keys": [k for _, k in items]}


class FeatureLoader:
    """Wrap any iterable of :func:`pad_collate` batches (typically a
    ``torch.utils.data.DataLoader``) and yield extracted features: the
    main-process half of the integration.

    Yields dicts: ``features [B, T, D]``, ``num_frames [B]``, ``mask [B,
    T]`` and the batch's ``keys``, extracted by :func:`features.extract`
    on ``device`` (default the card). With ``return_type="torch"`` the
    tensors stay on that device: the consumer is a torch model on the same
    card (the reference copied to the host only to cross from JAX to
    torch). ``return_type="np"`` returns host numpy arrays (bfloat16
    features as float32). ``generator`` (for ``cfg.dither > 0``): batch
    ``i`` draws its noise from a generator seeded from ``generator``'s seed
    and ``i``, so a batch's noise depends on its index alone."""

    def __init__(self, loader, cfg, *, return_type: str = "torch",
                 generator: torch.Generator | None = None, device=None):
        if return_type not in ("torch", "np"):
            raise ValueError(f"return_type {return_type!r} not in "
                             "('torch', 'np')")
        self.loader, self.cfg = loader, cfg
        self.return_type, self.generator = return_type, generator
        self.device = features.default_device(device)

    def batch_generator(self, i: int) -> torch.Generator | None:
        """Batch ``i``'s noise source on the loader's device, or None."""
        if self.generator is None:
            return None
        seed = np.random.SeedSequence(
            [self.generator.initial_seed(), i]).generate_state(1, np.uint64)
        return torch.Generator(self.device).manual_seed(int(seed[0] >> 1))

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            res = features.extract(
                np.asarray(batch["signal"], np.float32),
                np.asarray(batch["lengths"], np.int64), self.cfg,
                device=self.device, generator=self.batch_generator(i))
            out = {"features": res.features, "num_frames": res.num_frames,
                   "mask": res.mask}
            if self.return_type == "np":
                out = {k: (v.float() if v.is_floating_point() else v
                           ).cpu().numpy() for k, v in out.items()}
            out["keys"] = batch.get("keys")
            yield out

    def __len__(self) -> int:
        return len(self.loader)


class _BatchFeature(dict):
    """Minimal stand-in for transformers.BatchFeature: a dict whose keys
    are also attributes (``batch.input_features``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None
