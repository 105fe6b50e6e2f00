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
``pipeline``, the native C++ decoder and goldens ``cpp_golden``), and the
ASR models fed by the front-end (``models``: Whisper-tiny and Conformer
encoders, CTC and RNN-T training steps and decoders, x-vectors), with
the fused signal kernel and the two staged kernels written in CUDA for
``sm_90a``. It imports torch and numpy, never jax or ``tpufeat``, and
builds no CUDA code and no C++ library at import. Its namespace is the
reference's (``tpufeat.__all__``, the TPU-only ``enable_compile_cache``
aside), with the models' entry points beside it:

    from tpufeat_torch import extract, read_wav, WHISPER80
    samples, rate = read_wav("utt.wav")
    feats = extract(samples, cfg=WHISPER80, device="cuda").features
"""

from tpufeat_torch import cpp_golden  # noqa: F401
from tpufeat_torch.augment import (  # noqa: F401
    DEFAULT_ENDPOINT_RULES, EndpointRule, StreamingEndpointer,
    StreamingEnergyVAD, add_noise, add_reverb, energy_vad, kaldi_vad,
    segments_to_samples, spec_augment, speech_segments, speed_perturb)
from tpufeat_torch.beamform import delay_and_sum, gcc_phat, steer  # noqa: F401
from tpufeat_torch.config import (  # noqa: F401
    FBANK80, GFCC13, KALDI39, MFCC13_HTK, PLP13, PNCC13, PRESETS, SPEC257,
    STREAMING160, WHISPER80, WHISPER128, FeatureConfig)
from tpufeat_torch.diarization import (  # noqa: F401
    StreamingDiarizer, cluster_affinity, diarize, diarize_long,
    plda_affinity, refine_labels, segment_ivectors, sliding_windows,
    two_stage_cluster)
from tpufeat_torch.features import (  # noqa: F401
    FeatureResult, extract, extract_chunked, frames, logmel, make_extractor,
    mel_spectrogram, mfcc, online_cmvn, sliding_cmvn, spectrogram)
from tpufeat_torch.fmllr import (  # noqa: F401
    est_fmllr, estimate_fmllr, estimate_vtln_warp, fmllr_objective,
    fmllr_stats)
from tpufeat_torch.io import read_wav, write_wav  # noqa: F401
from tpufeat_torch.ivector import (  # noqa: F401
    DiagUbm, IvectorExtractor, StreamingIvector, ivector_features,
    train_diag_ubm, train_ivector_extractor, utterance_ivector)
from tpufeat_torch.models.encoder import (  # noqa: F401
    ConformerEncoder, WhisperEncoder, conformer_small, whisper_tiny)
from tpufeat_torch.models.train import (  # noqa: F401
    TrainState, asr_forward, beam_transducer_decode, ctc_train_step,
    greedy_ctc_decode, greedy_transducer_decode, make_models,
    make_transducer, prefix_beam_ctc_decode, token_error_rate,
    transducer_loss, transducer_train_step)
from tpufeat_torch.models.xvector import (  # noqa: F401
    XvectorNet, extract_xvectors, xvector_model, xvector_train_step)
from tpufeat_torch.pitch import (  # noqa: F401
    PitchConfig, StreamingPitch, StreamingPitchFeatures,
    config_for as pitch_config_for, pitch_features, track as track_pitch)
from tpufeat_torch.plda import (  # noqa: F401
    Plda, ivector_mean, length_normalize, train_plda)
from tpufeat_torch.resampling import StreamingResampler, resample  # noqa: F401
from tpufeat_torch.streaming import (  # noqa: F401
    OnlineCmvn, PoolRows, StreamingDeltas, StreamingFrontend,
    StreamingPipeline, StreamingSlidingCMVN, StreamPool, StreamState,
    extract_scan, init_state, process_chunk, process_chunk_static,
    scan_chunks, scan_chunks_static)

__version__ = "0.2.0"

__all__ = [
    "FeatureConfig", "MFCC13_HTK", "WHISPER80", "KALDI39", "STREAMING160",
    "FBANK80", "PLP13", "GFCC13", "PNCC13", "WHISPER128", "SPEC257",
    "PRESETS", "FeatureResult", "extract", "extract_chunked", "frames",
    "spectrogram",
    "mel_spectrogram", "logmel", "mfcc", "make_extractor", "read_wav",
    "write_wav", "StreamingFrontend", "StreamState", "init_state",
    "process_chunk", "process_chunk_static", "scan_chunks",
    "scan_chunks_static", "extract_scan", "StreamingDeltas",
    "StreamingPipeline", "StreamingSlidingCMVN", "StreamPool", "PoolRows",
    "sliding_cmvn",
    "OnlineCmvn", "online_cmvn",
    "resample", "StreamingResampler",
    "spec_augment", "energy_vad", "kaldi_vad", "StreamingEnergyVAD",
    "add_noise", "add_reverb", "EndpointRule", "DEFAULT_ENDPOINT_RULES",
    "StreamingEndpointer", "speech_segments", "segments_to_samples",
    "speed_perturb", "PitchConfig", "pitch_config_for",
    "pitch_features", "track_pitch", "StreamingPitch",
    "StreamingPitchFeatures", "gcc_phat", "steer", "delay_and_sum",
    "DiagUbm", "IvectorExtractor",
    "StreamingIvector", "ivector_features", "train_diag_ubm",
    "train_ivector_extractor", "utterance_ivector",
    "Plda", "train_plda", "length_normalize", "ivector_mean",
    "est_fmllr", "estimate_fmllr", "fmllr_stats", "fmllr_objective",
    "estimate_vtln_warp",
    "diarize", "diarize_long", "two_stage_cluster", "segment_ivectors",
    "sliding_windows", "plda_affinity",
    "cluster_affinity", "StreamingDiarizer", "refine_labels",
    "__version__",
    # the port's models (tpufeat.models is not in the reference's namespace)
    "WhisperEncoder", "ConformerEncoder", "whisper_tiny", "conformer_small",
    "make_models", "make_transducer", "TrainState", "asr_forward",
    "ctc_train_step", "transducer_train_step", "transducer_loss",
    "greedy_ctc_decode", "prefix_beam_ctc_decode",
    "greedy_transducer_decode", "beam_transducer_decode",
    "token_error_rate", "XvectorNet", "xvector_model", "extract_xvectors",
    "xvector_train_step",
    "cpp_golden",
]
