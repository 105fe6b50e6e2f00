"""ctypes bindings for the native C++ golden (``cpp_ref/mfcc.cc``):
counterpart of ``tpufeat/cpp_golden.py``.

The library is compiled from ``cpp_ref/mfcc.cc``, unchanged, with g++ and
``cpp_ref/Makefile``'s flags, at the first call that needs it — never at
import. It goes into ``tpufeat_torch/_build/<hash of source and
flags>/``, compiled under a name of its own and renamed into place, so
processes that build at once never load a half-written library; nothing
is written into ``cpp_ref/``. It gives a third, independent float64
implementation of the MFCC, fbank, spectrogram, PLP, pitch, resampling,
CMVN and gammatone goldens, and the native WAV decoders: one file
(:func:`read_wav_native`), a header scan (:func:`wav_header`) and a
batch decoded on a pool of threads (:func:`read_wav_batch`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

from tpufeat_torch.config import FeatureConfig

__all__ = ["available", "mfcc_native", "fbank_native", "spec_native",
           "plp_native", "resample_native", "pitch_native",
           "sliding_cmvn_native", "online_cmvn_native", "read_wav_native",
           "wav_header", "read_wav_batch", "gammatone_fb_native"]

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "cpp_ref" / "mfcc.cc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"
#: cpp_ref/Makefile's CXXFLAGS
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")

_D = ctypes.c_double
_I = ctypes.c_int
_L = ctypes.c_long
_PD = ctypes.POINTER(ctypes.c_double)

# name -> (restype, argtypes), as tpufeat/cpp_golden.py declares them
_SIGNATURES = {
    "tpufeat_gammatone_fb_f64": (None, [_I, _I, _I, _D, _D, _PD]),
    "tpufeat_mfcc_f64": (_L, [_PD, _L, _I, _I, _I, _I, _D, _I, _I, _D, _D,
                              _D, _I, _D, _D, _D, _PD]),
    "tpufeat_fbank_f64": (_L, [_PD, _L, _I, _I, _I, _I, _D, _I, _D, _D, _D,
                               _I, _D, _D, _D, _PD]),
    "tpufeat_spec_f64": (_L, [_PD, _L, _I, _I, _I, _D, _D, _I, _PD]),
    "tpufeat_plp_f64": (_L, [_PD, _L, _I, _I, _I, _I, _D, _I, _I, _D, _D,
                             _D, _D, _I, _PD]),
    "tpufeat_num_frames": (_L, [_L, _I, _I]),
    "tpufeat_pitch_num_frames": (_L, [_L, _I, _I, _I, _I]),
    "tpufeat_pitch_f64": (_L, [_PD, _L, _I, _I, _I, _I, _I, _D, _D, _D, _I,
                               _I, _PD, _PD]),
    "tpufeat_resample_len": (_L, [_L, _I, _I]),
    "tpufeat_resample_poly_f64": (_L, [_PD, _L, _I, _I, _PD]),
    "tpufeat_sliding_cmvn_f64": (None, [_PD, _L, _I, _I, _I, _I, _I, _PD]),
    "tpufeat_online_cmvn_f64": (None, [_PD, _L, _I, _I, _D, _PD, _PD, _D,
                                       _PD, _PD, _I, _I, _I, _PD]),
    "tpufeat_read_wav": (_L, [ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_float), _L,
                              ctypes.POINTER(_I)]),
    "tpufeat_read_wav_batch": (_L, [ctypes.POINTER(ctypes.c_char_p), _L,
                                    ctypes.POINTER(ctypes.c_float), _L,
                                    ctypes.POINTER(_L), ctypes.POINTER(_I),
                                    _I]),
}


def library_path() -> pathlib.Path:
    """Where the library of this source and these flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0"
                            + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / digest / "libtpufeat_ref.so"


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("the C++ golden needs g++ (or $CXX) on PATH")
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.parent / f"build.{os.getpid()}.so"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed with exit code "
                               f"{proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, so)        # atomic: a concurrent build never tears
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """True when the library is built, or builds now, and loads."""
    try:
        _lib()
        return True
    except (OSError, RuntimeError):
        return False


def _ptr(a: np.ndarray | None):
    return None if a is None else a.ctypes.data_as(_PD)


def _f64(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64)


def _classic_frames(x: np.ndarray, cfg: FeatureConfig, dim: int
                    ) -> tuple[np.ndarray, int]:
    """A zero [F, dim] float64 output for ``x`` under classic framing, F."""
    nf = _lib().tpufeat_num_frames(len(x), cfg.frame_length, cfg.hop_length)
    return np.zeros((max(nf, 0), dim), np.float64), nf


def _check(got: int, want: int) -> None:
    if got != want:
        raise RuntimeError(f"the C++ golden wrote {got} rows, expected "
                           f"{want}")


def mfcc_native(signal: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """The C++ double-precision MFCC pipeline. Classic (config-1 style)
    semantics only: center=False, Hamming, HTK bin-style mel, natural log."""
    if cfg.center or cfg.window != "hamming" or cfg.mel_scale != "htk" \
            or cfg.mel_bin_style != "bin" or cfg.log != "natural" \
            or cfg.kaldi_mode or cfg.n_mfcc <= 0 \
            or cfg.mel_norm is not None or cfg.spectrum != "power":
        raise ValueError("C++ golden covers the classic MFCC configuration")
    x = _f64(signal)
    out, nf = _classic_frames(x, cfg, cfg.n_mfcc)
    if nf > 0:
        _check(_lib().tpufeat_mfcc_f64(
            _ptr(x), len(x), cfg.sample_rate, cfg.frame_length,
            cfg.hop_length, cfg.n_fft, cfg.preemphasis, cfg.n_mels,
            cfg.n_mfcc, cfg.fmin, cfg.fmax_hz, cfg.log_floor, cfg.lifter,
            cfg.vtln_warp, cfg.vtln_low, cfg.vtln_high, _ptr(out)), nf)
    return out


def fbank_native(signal: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """The C++ double-precision log-mel filterbank pipeline (classic framing
    semantics, like :func:`mfcc_native`; ``use_energy`` prepends the log
    frame energy, Kaldi compute-fbank-feats --use-energy)."""
    if cfg.center or cfg.window != "hamming" or cfg.mel_scale != "htk" \
            or cfg.mel_bin_style != "bin" or cfg.log != "natural" \
            or cfg.kaldi_mode or cfg.n_mfcc != 0 or cfg.n_mels <= 0 \
            or cfg.mel_norm is not None or cfg.spectrum != "power" \
            or cfg.plp_order != 0:
        raise ValueError("C++ golden covers the classic filterbank "
                         "configuration (n_mfcc=0, Hamming, HTK bin mel, "
                         "natural log)")
    x = _f64(signal)
    out, nf = _classic_frames(x, cfg, cfg.n_mels + int(cfg.use_energy))
    if nf > 0:
        _check(_lib().tpufeat_fbank_f64(
            _ptr(x), len(x), cfg.sample_rate, cfg.frame_length,
            cfg.hop_length, cfg.n_fft, cfg.preemphasis, cfg.n_mels, cfg.fmin,
            cfg.fmax_hz, cfg.log_floor, int(cfg.use_energy), cfg.vtln_warp,
            cfg.vtln_low, cfg.vtln_high, _ptr(out)), nf)
    return out


def spec_native(signal: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """The C++ double-precision spectrogram-features pipeline (classic
    framing semantics, like :func:`mfcc_native`)."""
    if cfg.center or cfg.window != "hamming" or cfg.log != "natural" \
            or cfg.kaldi_mode or cfg.n_mels != 0 \
            or cfg.spectrum != "power":
        raise ValueError("C++ golden covers the classic spectrogram "
                         "configuration (n_mels=0, Hamming, natural log)")
    x = _f64(signal)
    out, nf = _classic_frames(x, cfg, cfg.n_bins)
    if nf > 0:
        _check(_lib().tpufeat_spec_f64(
            _ptr(x), len(x), cfg.frame_length, cfg.hop_length, cfg.n_fft,
            cfg.preemphasis, cfg.log_floor, int(cfg.use_energy), _ptr(out)),
            nf)
    return out


def plp_native(signal: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """The C++ double-precision PLP pipeline (classic framing semantics,
    like :func:`mfcc_native`; its own FFT and Durbin recursion)."""
    if cfg.center or cfg.window != "hamming" or cfg.mel_scale != "htk" \
            or cfg.mel_bin_style != "bin" or cfg.kaldi_mode \
            or cfg.mel_norm is not None or cfg.spectrum != "power" \
            or cfg.plp_order <= 0 or cfg.vtln_warp != 1.0:
        raise ValueError("C++ golden covers the classic PLP configuration")
    x = _f64(signal)
    out, nf = _classic_frames(x, cfg, cfg.plp_order + 1)
    if nf > 0:
        _check(_lib().tpufeat_plp_f64(
            _ptr(x), len(x), cfg.sample_rate, cfg.frame_length,
            cfg.hop_length, cfg.n_fft, cfg.preemphasis, cfg.n_mels,
            cfg.plp_order, cfg.fmin, cfg.fmax_hz, cfg.log_floor,
            cfg.plp_compress, cfg.lifter, _ptr(out)), nf)
    return out


def resample_native(signal: np.ndarray, p: int, q: int) -> np.ndarray:
    """The C++ double polyphase resampler (scipy ``resample_poly``'s default
    Kaiser-5 windowed-sinc design, direct upfirdn sum)."""
    lib = _lib()
    x = _f64(signal)
    n_out = lib.tpufeat_resample_len(len(x), int(p), int(q))
    out = np.zeros(max(n_out, 0), np.float64)
    if n_out > 0:
        _check(lib.tpufeat_resample_poly_f64(_ptr(x), len(x), int(p),
                                             int(q), _ptr(out)), n_out)
    return out


def pitch_native(signal: np.ndarray, cfg) -> tuple[np.ndarray, np.ndarray]:
    """The C++ double-precision pitch tracker (NCCF + Viterbi) -> (hz [F],
    pov [F]). ``cfg`` is a :class:`tpufeat_torch.pitch.PitchConfig`; a
    resampled lag grid runs the C++ polyphase decimator first."""
    import math
    lib = _lib()
    x = _f64(signal)
    if cfg.resampled:
        g = math.gcd(cfg.sample_rate, cfg.lag_rate)
        x = resample_native(x, cfg.lag_rate // g, cfg.sample_rate // g)
        cfg = cfg.inner()
    nf = lib.tpufeat_pitch_num_frames(len(x), cfg.frame_length,
                                      cfg.hop_length, cfg.lag_max,
                                      int(cfg.center))
    hz = np.zeros(max(nf, 0), np.float64)
    pov = np.zeros(max(nf, 0), np.float64)
    if nf > 0:
        _check(lib.tpufeat_pitch_f64(
            _ptr(x), len(x), cfg.sample_rate, cfg.frame_length,
            cfg.hop_length, cfg.lag_min, cfg.lag_max, cfg.penalty,
            cfg.ballast, cfg.lag_bias, int(cfg.center), int(cfg.refine),
            _ptr(hz), _ptr(pov)), nf)
    return hz, pov


def _features_2d(feat) -> np.ndarray:
    f = _f64(feat)
    if f.ndim != 2:
        raise ValueError(f"want [T, D], got shape {f.shape}")
    return f


def sliding_cmvn_native(feat: np.ndarray, window: int = 600,
                        min_window: int = 100, center: bool = False,
                        norm_vars: bool = False) -> np.ndarray:
    """C++ double sliding-window CMVN over [T, D] rows."""
    f = _features_2d(feat)
    out = np.zeros_like(f)
    if f.shape[0]:
        _lib().tpufeat_sliding_cmvn_f64(
            _ptr(f), f.shape[0], f.shape[1], window, min_window,
            int(center), int(norm_vars), _ptr(out))
    return out


def online_cmvn_native(feat: np.ndarray, window: int = 600,
                       speaker_stats=None, global_stats=None,
                       speaker_frames: int = 600, global_frames: int = 200,
                       norm_vars: bool = False) -> np.ndarray:
    """C++ double Kaldi-online2 OnlineCmvn over [T, D] rows. Priors are
    ``(count, sum, sumsq)`` triples, objects with those fields
    (:class:`tpufeat_torch.data.CmvnStats`) or None."""
    f = _features_2d(feat)

    def unpack(st):
        if st is None:
            return 0.0, None, None
        if isinstance(st, (tuple, list)):  # tuples have a .count method
            c, s, s2 = float(st[0]), st[1], st[2]
        else:
            c, s, s2 = float(st.count), st.sum, st.sumsq
        s, s2 = _f64(s), _f64(s2)
        if s.shape != (f.shape[1],) or s2.shape != (f.shape[1],):
            raise ValueError("prior stats dim mismatch")
        return c, s, s2

    cs, ssum, ssq = unpack(speaker_stats)
    cg, gsum, gsq = unpack(global_stats)
    out = np.zeros_like(f)
    if f.shape[0]:
        _lib().tpufeat_online_cmvn_f64(
            _ptr(f), f.shape[0], f.shape[1], window, cs, _ptr(ssum),
            _ptr(ssq), cg, _ptr(gsum), _ptr(gsq), speaker_frames,
            global_frames, int(norm_vars), _ptr(out))
    return out


def wav_header(path: str) -> tuple[int, int]:
    """(samples per channel, rate) from the C++ parser's header-only read
    (``tpufeat_read_wav(path, NULL, 0, &rate)``); ValueError when it cannot
    read the file."""
    rate = _I(0)
    n = _lib().tpufeat_read_wav(os.fsencode(path), None, 0,
                                ctypes.byref(rate))
    if n == -2:
        raise ValueError(f"unsupported WAVE format (supported: PCM "
                         f"8/16/24/32-bit, IEEE float 32/64-bit): {path}")
    if n < 0:
        raise ValueError(f"not a readable WAV: {path}")
    return int(n), rate.value


def read_wav_native(path: str) -> tuple[np.ndarray, int]:
    """Decode a WAV with the C++ RIFF parser -> (float32 mono, rate).

    Formats: PCM 8/16/24/32-bit, IEEE float 32/64-bit (extensible headers
    too); anything else raises instead of decoding garbage. Channels are
    averaged."""
    n, _ = wav_header(path)
    out = np.zeros(n, np.float32)
    rate = _I(0)
    got = _lib().tpufeat_read_wav(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ctypes.byref(rate))
    if got != n:
        raise OSError(f"short read decoding {path}")
    return out, rate.value


def read_wav_batch(paths: list[str], max_samples: int, n_threads: int = 0
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode many WAVs at once on the native pool of threads (``n_threads``
    0: one per core) -> (batch [B, max_samples] float32 zero-padded,
    lengths [B] int64 with -1 for a file that failed or is longer than
    ``max_samples``, rates [B] int32)."""
    lib = _lib()
    b = len(paths)
    arena = np.zeros((b, max_samples), np.float32)
    lengths = np.zeros(b, np.int64)
    rates = np.zeros(b, np.int32)
    if b:
        names = (ctypes.c_char_p * b)(*[os.fsencode(p) for p in paths])
        lib.tpufeat_read_wav_batch(
            names, b, arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_samples, lengths.ctypes.data_as(ctypes.POINTER(_L)),
            rates.ctypes.data_as(ctypes.POINTER(_I)), n_threads)
    return arena, lengths, rates


def gammatone_fb_native(sample_rate: int, n_fft: int, n_out: int,
                        fmin: float, fmax: float) -> np.ndarray:
    """C++ double gammatone/ERB |H|^2 filterbank -> [n_fft//2+1, n_out]."""
    out = np.zeros((n_fft // 2 + 1, n_out), np.float64)
    _lib().tpufeat_gammatone_fb_f64(int(sample_rate), int(n_fft), int(n_out),
                                    float(fmin), float(fmax), _ptr(out))
    return out
