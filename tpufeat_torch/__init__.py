"""tpufeat_torch — the PyTorch + CUDA port of ``tpufeat`` for NVIDIA Hopper.

So far: batched one-shot extraction of every preset (Whisper log-mel,
MFCC-13, Kaldi-39 with deltas and CMVN, fbank, GFCC, PLP, PNCC, the log
power spectrum; VTLN and dither) on the fused, staged and plain routes,
the streaming front-end, the online config-3 pipeline
(``StreamingPipeline``: deltas, running, sliding or Kaldi online CMVN, a
transform, Kaldi pitch rows, a 48 kHz or other input rate) and its slot
manager (``StreamPool``), the polyphase resampler (``resampling``), the
pitch tracker (``pitch``), augmentation and VAD (``augment``), the
beamformer (``beamform``), the speaker stack (``ivector``, ``plda``,
``fmllr``, ``diarization``; i-vectors in ``StreamingPipeline`` too), and
the host tools (``feats_io``, ``data``, ``cli``, the corpus pipeline
``pipeline``), with
the fused signal kernel and the two staged kernels written in CUDA for
``sm_90a``. It imports torch and numpy, never jax or ``tpufeat``, and
builds no CUDA code at import:

    from tpufeat_torch import extract, read_wav, WHISPER80
    samples, rate = read_wav("utt.wav")
    feats = extract(samples, cfg=WHISPER80, device="cuda").features
"""

from tpufeat_torch.config import (  # noqa: F401
    FBANK80, GFCC13, KALDI39, MFCC13_HTK, PLP13, PNCC13, PRESETS, SPEC257,
    STREAMING160, WHISPER80, WHISPER128, FeatureConfig)
from tpufeat_torch.features import (  # noqa: F401
    FeatureResult, extract, extract_chunked, frames, logmel, make_extractor,
    mel_spectrogram, mfcc, online_cmvn, sliding_cmvn, spectrogram)
from tpufeat_torch.io import read_wav, write_wav  # noqa: F401
from tpufeat_torch.resampling import resample  # noqa: F401
from tpufeat_torch.streaming import (  # noqa: F401
    OnlineCmvn, PoolRows, StreamingDeltas, StreamingFrontend,
    StreamingPipeline, StreamingSlidingCMVN, StreamPool, StreamState,
    extract_scan, init_state, process_chunk, process_chunk_static,
    scan_chunks, scan_chunks_static)
