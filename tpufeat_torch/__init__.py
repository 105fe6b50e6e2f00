"""tpufeat_torch — the PyTorch + CUDA port of ``tpufeat`` for NVIDIA Hopper.

The first slice: batched one-shot extraction of the main path (Whisper
log-mel and MFCC-13, plus the presets that need no new code), with the
fused signal kernel written in CUDA for ``sm_90a``. It imports torch and
numpy, never jax or ``tpufeat``, and builds no CUDA code at import:

    from tpufeat_torch import extract, read_wav, WHISPER80
    samples, rate = read_wav("utt.wav")
    feats = extract(samples, cfg=WHISPER80, device="cuda").features
"""

from tpufeat_torch.config import (  # noqa: F401
    FBANK80, GFCC13, KALDI39, MFCC13_HTK, PRESETS, WHISPER80, WHISPER128,
    FeatureConfig)
from tpufeat_torch.features import (  # noqa: F401
    FeatureResult, extract, frames, logmel, mel_spectrogram, mfcc,
    spectrogram)
from tpufeat_torch.io import read_wav, write_wav  # noqa: F401
