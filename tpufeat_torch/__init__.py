"""tpufeat_torch — the PyTorch + CUDA port of ``tpufeat`` for NVIDIA Hopper.

So far: batched one-shot extraction (Whisper log-mel, MFCC-13 and the
presets that need no other code, on the fused, staged and plain routes)
and the streaming front-end, with the fused signal kernel and the two
staged kernels written in CUDA for ``sm_90a``. It imports torch and numpy,
never jax or ``tpufeat``, and builds no CUDA code at import:

    from tpufeat_torch import extract, read_wav, WHISPER80
    samples, rate = read_wav("utt.wav")
    feats = extract(samples, cfg=WHISPER80, device="cuda").features
"""

from tpufeat_torch.config import (  # noqa: F401
    FBANK80, GFCC13, KALDI39, MFCC13_HTK, PRESETS, STREAMING160, WHISPER80,
    WHISPER128, FeatureConfig)
from tpufeat_torch.features import (  # noqa: F401
    FeatureResult, extract, frames, logmel, mel_spectrogram, mfcc,
    spectrogram)
from tpufeat_torch.io import read_wav, write_wav  # noqa: F401
from tpufeat_torch.streaming import (  # noqa: F401
    StreamingFrontend, StreamState, extract_scan, init_state, process_chunk,
    process_chunk_static, scan_chunks, scan_chunks_static)
