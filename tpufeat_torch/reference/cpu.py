"""Serial NumPy float64 golden pipeline — the port's copy of the feature
goldens of ``tpufeat/reference/cpu.py``.

The numerical oracle against which the accelerated path is validated with
max-abs-error, usable where jax is not installed (``chip_smoke.py`` on the
GPU host). Everything is float64, stage-by-stage, written for auditability
rather than speed. The pitch tracker's and the beamformer's goldens are
here too, those of the speaker stack (i-vectors, PLDA, fMLLR) and those
of the models' losses (the RNN-T loss by enumeration, the CTC sequence
log-probability by the forward pass).

The radix-2 FFT here mirrors the reference's centerpiece OpenCL kernel
(SURVEY.md §2 C5: iterative Cooley-Tukey, bit-reversal + log2(N) butterfly
passes) in pure NumPy; the pipeline itself uses ``np.fft.rfft`` and the two
are cross-validated in tests (the radix-2 path only applies to power-of-two
n_fft).
"""

from __future__ import annotations

import numpy as np

from tpufeat_torch import matrices
from tpufeat_torch.config import FeatureConfig

__all__ = [
    "radix2_fft",
    "preemphasis",
    "frame_signal",
    "spectrogram",
    "logmel",
    "mfcc",
    "plp",
    "pncc",
    "pncc_from_power",
    "deltas",
    "cmvn",
    "frame_energy",
    "extract",
    "diag_gmm_log_likes",
    "gmm_posteriors",
    "ivector_stats",
    "ivector_estimate",
    "ivector_features",
    "plda_transform_ivector",
    "plda_log_likelihood_ratio",
    "fmllr_stats",
    "transducer_loss",
    "ctc_sequence_logp",
]


# ---------------------------------------------------------------------------
# Radix-2 iterative FFT (audit twin of the reference's OpenCL kernel, C5)
# ---------------------------------------------------------------------------

def radix2_fft(x: np.ndarray) -> np.ndarray:
    """Iterative Cooley-Tukey radix-2 DIT FFT, complex128, length power of 2.

    Bit-reversal permutation followed by log2(N) butterfly passes — the same
    schedule the reference's OpenCL kernel runs with one work-item per
    butterfly pair and a barrier between passes (SURVEY.md §3.1).
    """
    x = np.asarray(x, dtype=np.complex128).copy()
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"radix2_fft needs power-of-two length, got {n}")
    levels = n.bit_length() - 1
    # bit-reversal permutation
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(levels):
        rev |= ((idx >> b) & 1) << (levels - 1 - b)
    x = x[..., rev]
    # butterfly passes
    half = 1
    while half < n:
        w = np.exp(-2j * np.pi * np.arange(half) / (2 * half))
        x = x.reshape(x.shape[:-1] + (n // (2 * half), 2 * half))
        even = x[..., :half]
        odd = x[..., half:] * w
        x = np.concatenate([even + odd, even - odd], axis=-1)
        x = x.reshape(x.shape[:-2] + (n,))
        half *= 2
    return x


# ---------------------------------------------------------------------------
# Pipeline stages (all float64)
# ---------------------------------------------------------------------------

def preemphasis(x: np.ndarray, alpha: float, prev: float = 0.0) -> np.ndarray:
    """y[t] = x[t] - alpha*x[t-1], with x[-1] := prev (0 for one-shot).

    Reference C2. ``prev`` carries the last raw sample of the previous chunk
    in streaming mode (config 4)."""
    x = np.asarray(x, dtype=np.float64)
    if alpha == 0.0:
        return x.copy()
    shifted = np.concatenate([np.array([prev], dtype=np.float64), x[:-1]])
    return x - alpha * shifted


def _reflect_pad(x: np.ndarray, pad: int) -> np.ndarray:
    """librosa/torch-style reflect padding (no edge repetition)."""
    return np.pad(x, (pad, pad), mode="reflect")


def frame_signal(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Slice into overlapped frames [n_frames, frame_length] (reference C3).

    center=False: snip-edges, frames = 1 + (N - frame_length)//hop.
    center=True: reflect-pad n_fft//2 each side, frame t starts at
    t*hop - n_fft//2 in the original signal (Whisper/torch.stft convention),
    optionally dropping the final frame.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    fl, hop = cfg.frame_length, cfg.hop_length
    nf = cfg.num_frames(n)
    if cfg.center:
        x = _reflect_pad(x, cfg.n_fft // 2)
    if nf <= 0:
        return np.zeros((0, fl), dtype=np.float64)
    idx = np.arange(nf).reshape(-1, 1) * hop + np.arange(fl).reshape(1, -1)
    return x[idx]


def _window_frames(frames: np.ndarray, cfg: FeatureConfig,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Per-frame conditioning + window (references C2/C4).

    In kaldi_mode the reference order is applied per frame: dither,
    DC-offset removal, pre-emphasis within the frame (x[-1] := x[0]), then
    window. Dither (cfg.dither > 0) is a randomized augmentation knob: the
    golden applies it here per frame copy in kaldi_mode and at the sample
    level in :func:`spectrogram` otherwise, mirroring the accelerated
    path's ``extract(..., rng=...)`` — equivalent in distribution, never
    bit-comparable, so parity tests always run with dither = 0."""
    frames = frames.astype(np.float64)
    if cfg.kaldi_mode:
        if cfg.dither > 0:
            rng = rng or np.random.default_rng(0)
            frames = frames + cfg.dither * rng.standard_normal(frames.shape)
        if cfg.dc_offset:
            frames = frames - frames.mean(axis=-1, keepdims=True)
        if cfg.preemphasis:
            first = frames[..., :1] - cfg.preemphasis * frames[..., :1]
            rest = frames[..., 1:] - cfg.preemphasis * frames[..., :-1]
            frames = np.concatenate([first, rest], axis=-1)
    w = matrices.window(cfg.window, cfg.frame_length)
    return frames * w


def spectrogram(x: np.ndarray, cfg: FeatureConfig,
                preemph_prev: float = 0.0) -> np.ndarray:
    """Signal -> power/magnitude spectrogram [n_frames, n_fft//2+1].

    References C2-C6 composed: dither (when configured), pre-emphasis
    (signal-level unless kaldi_mode), framing, window, zero-pad to n_fft,
    rFFT, |.|^2 (or |.|)."""
    x = np.asarray(x, dtype=np.float64)
    if cfg.dither > 0 and not cfg.kaldi_mode:
        # sample-level dither, mirroring the accelerated path (kaldi_mode
        # applies it per frame copy in _window_frames instead)
        x = x + cfg.dither * np.random.default_rng(0).standard_normal(x.shape)
    if cfg.preemphasis and not cfg.kaldi_mode:
        x = preemphasis(x, cfg.preemphasis, preemph_prev)
    frames = frame_signal(x, cfg)
    frames = _window_frames(frames, cfg)
    spec = np.fft.rfft(frames, n=cfg.n_fft, axis=-1)
    mag2 = spec.real**2 + spec.imag**2
    return mag2 if cfg.spectrum == "power" else np.sqrt(mag2)


def logmel(x: np.ndarray, cfg: FeatureConfig,
           preemph_prev: float = 0.0) -> np.ndarray:
    """Signal -> (log-)mel features [n_frames, n_mels] (references C7+C8)."""
    spec = spectrogram(x, cfg, preemph_prev)
    fb = matrices.mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax_hz,
        cfg.mel_scale, cfg.mel_norm, cfg.mel_bin_style,
        cfg.vtln_warp, cfg.vtln_low, cfg.vtln_high)
    mel = spec @ fb
    return apply_log(mel, cfg)


def apply_log(mel: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Log compression (reference C8). ``whisper`` applies the full Whisper
    normalization: log10 -> clamp at (per-utterance) max-8 -> (x+4)/4."""
    if cfg.log == "none":
        return mel
    if cfg.log == "natural":
        return np.log(np.maximum(mel, cfg.log_floor))
    if cfg.log == "log10":
        return np.log10(np.maximum(mel, cfg.log_floor))
    if cfg.log == "whisper":
        ls = np.log10(np.maximum(mel, cfg.log_floor))
        ls = np.maximum(ls, ls.max() - 8.0)
        return (ls + 4.0) / 4.0
    raise ValueError(cfg.log)


def frame_energy(x: np.ndarray, cfg: FeatureConfig,
                 preemph_prev: float = 0.0) -> np.ndarray:
    """Kaldi-style log frame energy: log(max(sum x^2, floor)) over the
    conditioned (pre-emphasized, unwindowed) frame."""
    x = np.asarray(x, dtype=np.float64)
    if cfg.preemphasis and not cfg.kaldi_mode:
        x = preemphasis(x, cfg.preemphasis, preemph_prev)
    frames = frame_signal(x, cfg)
    if cfg.kaldi_mode:
        if cfg.dc_offset:
            frames = frames - frames.mean(axis=-1, keepdims=True)
        if cfg.preemphasis:
            first = frames[..., :1] - cfg.preemphasis * frames[..., :1]
            rest = frames[..., 1:] - cfg.preemphasis * frames[..., :-1]
            frames = np.concatenate([first, rest], axis=-1)
    e = (frames ** 2).sum(axis=-1)
    return np.log(np.maximum(e, cfg.log_floor))


def mfcc(x: np.ndarray, cfg: FeatureConfig,
         preemph_prev: float = 0.0) -> np.ndarray:
    """Signal -> MFCC [n_frames, n_mfcc] (reference C9)."""
    lm = logmel(x, cfg, preemph_prev)
    dct = matrices.dct_matrix(cfg.n_mels, cfg.n_mfcc)
    out = lm @ dct
    if cfg.lifter > 0:
        out = out * matrices.lifter_vector(cfg.n_mfcc, cfg.lifter)
    if cfg.use_energy:
        out = out.copy()
        out[:, 0] = frame_energy(x, cfg, preemph_prev)
    return out


def plp(x: np.ndarray, cfg: FeatureConfig,
        preemph_prev: float = 0.0) -> np.ndarray:
    """Signal -> PLP cepstra [n_frames, plp_order+1] (beyond-reference
    family; formula conventions in tpufeat/plp.py's docstring).

    Deliberately implemented with DIFFERENT algorithms than the
    accelerated path so agreement is meaningful: the autocorrelation is
    an explicit even-symmetric extension + np.fft.ifft (vs the cos-matrix
    matmul), and the LPC solve is a direct per-frame Toeplitz system via
    scipy (vs the unrolled Levinson-Durbin recursion)."""
    from scipy.linalg import solve_toeplitz

    order = cfg.plp_order
    spec = spectrogram(x, cfg, preemph_prev)
    fb = matrices.mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax_hz,
        cfg.mel_scale, cfg.mel_norm, cfg.mel_bin_style,
        cfg.vtln_warp, cfg.vtln_low, cfg.vtln_high)
    mel = spec @ fb
    el = matrices.equal_loudness_vector(
        cfg.n_mels, cfg.fmin, cfg.fmax_hz, cfg.mel_scale)
    p = np.maximum(mel * el, cfg.log_floor) ** cfg.plp_compress
    a = np.concatenate([p[:, :1], p, p[:, -1:]], axis=1)   # [F, M+2]
    sym = np.concatenate([a, a[:, -2:0:-1]], axis=1)       # period 2(M+1)
    r = np.fft.ifft(sym, axis=1).real[:, : order + 1]
    lpc = np.zeros((r.shape[0], order))
    for f in range(r.shape[0]):
        lpc[f] = solve_toeplitz(r[f, :order], r[f, 1: order + 1])
    err = r[:, 0] - (lpc * r[:, 1:]).sum(axis=1)
    c = np.zeros_like(lpc)
    for n in range(1, order + 1):
        acc = lpc[:, n - 1].copy()
        for k in range(1, n):
            acc += (k / n) * c[:, k - 1] * lpc[:, n - k - 1]
        c[:, n - 1] = acc
    out = np.concatenate(
        [np.log(np.maximum(err, cfg.log_floor))[:, None], c], axis=1)
    if cfg.lifter > 0:
        out = out * matrices.lifter_vector(order + 1, cfg.lifter)
    return out


def deltas(feat: np.ndarray, window: int = 2) -> np.ndarray:
    """Regression deltas d_t = sum_n n*(c_{t+n}-c_{t-n}) / (2*sum_n n^2)
    with replicated edge padding (reference C16 / SURVEY.md §2.1 config 3)."""
    n = window
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    padded = np.pad(feat, ((n, n), (0, 0)), mode="edge")
    out = np.zeros_like(feat)
    for i in range(1, n + 1):
        out += i * (padded[n + i: n + i + feat.shape[0]]
                    - padded[n - i: n - i + feat.shape[0]])
    return out / denom


def cmvn(feat: np.ndarray, mode: str = "mean") -> np.ndarray:
    """Per-utterance cepstral mean (and variance) normalization (C16)."""
    if mode == "none":
        return feat
    out = feat - feat.mean(axis=0, keepdims=True)
    if mode == "meanvar":
        out = out / np.sqrt(feat.var(axis=0, keepdims=True) + 1e-10)
    return out


def sliding_cmvn(feat: np.ndarray, window: int = 600,
                 min_window: int = 100, center: bool = False,
                 norm_vars: bool = False) -> np.ndarray:
    """Sliding-window cepstral mean (and variance) normalization — the
    float64 golden for :func:`tpufeat.features.sliding_cmvn` (the online
    normalization online ASR actually deploys; Kaldi's
    ``apply-cmvn-sliding``, whose window-clamping rules this reproduces;
    reference C16's online sibling).

    Per frame t of [T, D] ``feat`` the window is:
      - ``center=True``: ``[t - window//2, t - window//2 + window)``;
      - ``center=False`` (causal): ``[t - window, t + 1)``, except the
        first frames borrow future context up to ``min_window`` frames so
        early estimates aren't single-frame noise.
    Both are then clamped inside ``[0, T)`` by shifting (not shrinking,
    except when T itself is short). Direct per-frame loops — the oracle,
    not the fast path."""
    T, _ = feat.shape
    x = feat.astype(np.float64)
    out = np.empty_like(x)
    for t in range(T):
        if center:
            ws = t - window // 2
            we = ws + window
        else:
            ws = t - window
            we = t + 1
        if ws < 0:
            we -= ws
            ws = 0
        if not center and we > t + 1:
            we = max(t + 1, min_window)
        if we > T:
            ws = max(ws - (we - T), 0)
            we = T
        seg = x[ws:we]
        mean = seg.mean(axis=0)
        out[t] = x[t] - mean
        if norm_vars:
            var = np.maximum((seg * seg).mean(axis=0) - mean * mean,
                             1e-10)
            out[t] /= np.sqrt(var)
    return out


def online_cmvn(feat: np.ndarray, window: int = 600,
                speaker_stats=None, global_stats=None,
                speaker_frames: int = 600, global_frames: int = 200,
                norm_vars: bool = False) -> np.ndarray:
    """Kaldi online2 ``OnlineCmvn`` — the float64 golden for
    :func:`tpufeat.features.online_cmvn`: per frame t the statistics are
    the trailing ``min(t+1, window)`` frames, smoothed (while the window
    is short) with up to ``speaker_frames`` worth of the speaker prior
    then up to ``global_frames`` of the global prior, total never
    exceeding ``window`` (the SmoothOnlineCmvnStats rule). Priors are
    ``(count, sum, sumsq)`` triples or :class:`tpufeat.data.CmvnStats`.
    Direct per-frame loop — the oracle, not the fast path."""
    def unpack(st):
        if st is None:
            return 0.0, 0.0, 0.0
        if isinstance(st, (tuple, list)):  # tuples HAVE a .count method
            return float(st[0]), np.asarray(st[1], np.float64), \
                np.asarray(st[2], np.float64)
        return float(st.count), np.asarray(st.sum, np.float64), \
            np.asarray(st.sumsq, np.float64)

    cs, ssum, ssq = unpack(speaker_stats)
    cg, gsum, gsq = unpack(global_stats)
    T, _ = feat.shape
    x = feat.astype(np.float64)
    out = np.empty_like(x)
    for t in range(T):
        seg = x[max(0, t + 1 - window): t + 1]
        c = float(len(seg))
        tot_sum = seg.sum(axis=0)
        tot_sq = (seg * seg).sum(axis=0)
        ks = min(max(window - c, 0.0), float(speaker_frames), cs)
        if ks > 0:
            tot_sum = tot_sum + (ks / cs) * ssum
            tot_sq = tot_sq + (ks / cs) * ssq
        kg = min(max(window - c - ks, 0.0), float(global_frames), cg)
        if kg > 0:
            tot_sum = tot_sum + (kg / cg) * gsum
            tot_sq = tot_sq + (kg / cg) * gsq
        n = c + ks + kg
        mean = tot_sum / n
        out[t] = x[t] - mean
        if norm_vars:
            var = np.maximum(tot_sq / n - mean * mean, 1e-10)
            out[t] /= np.sqrt(var)
    return out


def pncc_from_power(p: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Float64 golden for :func:`tpufeat_torch.pncc.pncc_from_power` (one
    utterance, [F, M] gammatone power -> [F, pncc_ceps]): plain loops over
    the Kim & Stern 2012 equations with that module's constants."""
    from tpufeat_torch import pncc as pn
    p = np.asarray(p, np.float64)
    F, M = p.shape
    # medium-time power: clipped-window mean
    q = np.empty_like(p)
    for l in range(F):
        lo, hi = max(0, l - pn.M_MED), min(F, l + pn.M_MED + 1)
        q[l] = p[lo:hi].mean(axis=0)
    # frame recursions
    r = np.empty_like(q)
    qle = 0.9 * q[0]
    qf = np.maximum(q[0] - qle, 0.0)
    qp = qf.copy()
    for l in range(F):
        if l > 0:
            lam = np.where(q[l] >= qle, pn.LAMBDA_A, pn.LAMBDA_B)
            qle = lam * qle + (1.0 - lam) * q[l]
        q0 = np.maximum(q[l] - qle, 0.0)
        if l > 0:
            lam = np.where(q0 >= qf, pn.LAMBDA_A, pn.LAMBDA_B)
            qf = lam * qf + (1.0 - lam) * q0
        else:
            qf = q0.copy()
        qp_prev = q0.copy() if l == 0 else qp
        qtm = np.where(q0 >= pn.LAMBDA_T * qp_prev, q0,
                       pn.MU_T * qp_prev)
        qp = np.maximum(pn.LAMBDA_T * qp_prev, q0)
        r[l] = np.where(q[l] >= pn.C_EXC * qle, qtm, qf)
    # spectral weight smoothing
    w = r / np.maximum(q, 1e-20)
    s_ = np.empty_like(w)
    for m in range(M):
        lo, hi = max(0, m - pn.N_SPEC), min(M, m + pn.N_SPEC + 1)
        s_[:, m] = w[:, lo:hi].mean(axis=1)
    t = p * s_
    # mean power normalization
    mu = np.empty(F)
    for l in range(F):
        tb = t[l].mean()
        mu[l] = tb if l == 0 else (pn.LAMBDA_MU * mu[l - 1]
                                   + (1.0 - pn.LAMBDA_MU) * tb)
    u = t / np.maximum(mu[:, None], 1e-20)
    v = np.maximum(u, cfg.log_floor) ** pn.POWER
    out = v @ matrices.dct_matrix(M, cfg.pncc_ceps)
    if cfg.lifter > 0:
        out = out * matrices.lifter_vector(cfg.pncc_ceps, cfg.lifter)
    return out


def pncc(x: np.ndarray, cfg: FeatureConfig,
         preemph_prev: float = 0.0) -> np.ndarray:
    """Signal -> PNCC [n_frames, pncc_ceps]: the gammatone power through
    :func:`logmel` with log "none", then the PNCC tail."""
    return pncc_from_power(logmel(x, cfg, preemph_prev), cfg)


def extract(x: np.ndarray, cfg: FeatureConfig,
            preemph_prev: float = 0.0) -> np.ndarray:
    """Full golden pipeline: signal -> features [n_frames, feature_dim].

    The float64 oracle for the end-to-end parity tests (SURVEY.md §4)."""
    if cfg.plp_order > 0:
        base = plp(x, cfg, preemph_prev)
    elif cfg.pncc:
        base = pncc(x, cfg, preemph_prev)
    elif cfg.n_mfcc > 0:
        base = mfcc(x, cfg, preemph_prev)
    elif cfg.n_mels == 0:
        # spectrogram features (Kaldi compute-spectrogram-feats analogue):
        # (log-)power spectrum, optionally with the conditioned-frame log
        # energy substituted into element 0 (same substitution as MFCC c0)
        base = apply_log(spectrogram(x, cfg, preemph_prev), cfg)
        if cfg.use_energy:
            base = base.copy()
            base[:, 0] = frame_energy(x, cfg, preemph_prev)
    else:
        base = logmel(x, cfg, preemph_prev)
        if cfg.use_energy:
            # fbank + energy (Kaldi compute-fbank-feats --use-energy):
            # the log frame energy is PREPENDED (dim n_mels+1), unlike
            # the MFCC / spectrogram substitution of element 0
            base = np.concatenate(
                [frame_energy(x, cfg, preemph_prev)[:, None], base],
                axis=-1)
    if cfg.deltas:
        outs, d = [base], base
        for _ in range(cfg.delta_order):
            d = deltas(d, cfg.delta_window)
            outs.append(d)
        base = np.concatenate(outs, axis=-1)
    if cfg.cmvn.startswith("sliding"):
        return sliding_cmvn(base, cfg.cmvn_window, cfg.cmvn_min_window,
                            cfg.cmvn_center,
                            cfg.cmvn.endswith("meanvar"))
    return cmvn(base, cfg.cmvn)


def pitch(x: np.ndarray, cfg) -> tuple[np.ndarray, np.ndarray]:
    """Golden pitch tracker -> (pitch_hz [F], pov [F]).

    Independent of tpufeat_torch/pitch.py by construction: scipy
    ``resample_poly`` for the lag-grid decimation (the port's polyphase
    resampler is tested against exactly this), direct
    per-lag correlation loops (no FFT), a plain-Python Viterbi with
    explicit backtrace, and inline parabolic refinement. ``cfg`` is a
    tpufeat_torch.pitch.PitchConfig."""
    x = np.asarray(x, dtype=np.float64)
    if getattr(cfg, "resampled", False):
        import math
        from scipy.signal import resample_poly
        g = math.gcd(cfg.sample_rate, cfg.lag_rate)
        x = resample_poly(x, cfg.lag_rate // g, cfg.sample_rate // g)
        cfg = cfg.inner()
    W, hop = cfg.frame_length, cfg.hop_length
    L0, L1 = cfg.lag_min, cfg.lag_max
    wext = W + L1
    F = cfg.num_frames(len(x))
    L = L1 - L0 + 1
    rms2 = float(np.mean(x * x)) if len(x) else 0.0  # pre-pad RMS
    ballast = cfg.ballast * (W * rms2) ** 2
    if getattr(cfg, "center", False):
        pad = wext // 2
        x = np.pad(x, (pad, pad))
    scores = np.zeros((F, L))
    for t in range(F):
        b = x[t * hop: t * hop + wext]
        a = b[:W]
        e0 = float(a @ a)
        for j, lag in enumerate(range(L0, L1 + 1)):
            seg = b[lag: lag + W]
            den = np.sqrt(e0 * float(seg @ seg) + ballast + 1e-20)
            scores[t, j] = float(a @ seg) / den
    lags = np.arange(L0, L1 + 1, dtype=np.float64)
    trans = cfg.penalty * (np.log(lags)[:, None] - np.log(lags)[None, :]) ** 2
    shaped = scores - cfg.lag_bias * np.log(lags / L0)  # short-lag tilt
    v = shaped[0].copy()
    ptrs = np.zeros((F - 1, L), dtype=np.int64) if F > 1 else \
        np.zeros((0, L), dtype=np.int64)
    for t in range(1, F):
        cand = v[:, None] - trans
        ptrs[t - 1] = np.argmax(cand, axis=0)
        v = shaped[t] + np.max(cand, axis=0)
    path = np.zeros(F, dtype=np.int64)
    if F:
        path[-1] = int(np.argmax(v))
        for t in range(F - 2, -1, -1):
            path[t] = ptrs[t][path[t + 1]]
    delta = np.zeros(F)
    if getattr(cfg, "refine", False):
        # parabolic sub-lag refinement on the raw NCCF (pitch.refine_lag's
        # twin): vertex of the parabola through the decided
        # lag and its neighbors, gated on real curvature, clipped to
        # half a lag step
        for t in range(F):
            j = path[t]
            if 0 < j < L - 1:
                ym, y0, yp = scores[t, j - 1], scores[t, j], scores[t, j + 1]
                den = ym - 2.0 * y0 + yp
                if den < -1e-2:
                    delta[t] = min(0.5, max(-0.5, 0.5 * (ym - yp) / den))
    hz = cfg.sample_rate / (lags[path] + delta)
    pov = scores[np.arange(F), path]
    return hz, pov


# --- multi-channel beamforming (goldens for tpufeat_torch.beamform) ---

def _bf_pow2(n: int, w: int) -> int:
    p = 1
    while p < n + 2 * w:
        p *= 2
    return p


def gcc_phat(x: np.ndarray, max_delay: int = 64, ref: int = 0,
             subsample: bool = True) -> np.ndarray:
    """Float64 golden for :func:`tpufeat_torch.beamform.gcc_phat` ([C, N] ->
    [C] delays; positive = channel is late vs ref)."""
    x = np.asarray(x, np.float64)
    C, N = x.shape
    p = _bf_pow2(N, max_delay)
    X = np.fft.rfft(x, n=p, axis=-1)
    out = np.zeros(C)
    for c in range(C):
        cross = X[c] * np.conj(X[ref])
        cross /= np.maximum(np.abs(cross), 1e-12)
        corr = np.fft.irfft(cross, n=p)
        win = np.concatenate([corr[p - max_delay:],
                              corr[: max_delay + 1]])
        i = int(np.argmax(win))
        d = float(i - max_delay)
        if subsample and 0 < i < 2 * max_delay:
            cm, c0, cp = win[i - 1], win[i], win[i + 1]
            den = cm - 2.0 * c0 + cp
            if abs(den) > 1e-12:
                d += float(np.clip(0.5 * (cm - cp) / den, -1.0, 1.0))
        out[c] = d
    out[ref] = 0.0
    return out


def delay_and_sum(x: np.ndarray, max_delay: int = 64, ref: int = 0,
                  subsample: bool = True) -> np.ndarray:
    """Float64 golden for :func:`tpufeat_torch.beamform.delay_and_sum`
    ([C, N] -> [N]): phase-ramp steering + channel mean."""
    x = np.asarray(x, np.float64)
    C, N = x.shape
    d = gcc_phat(x, max_delay, ref, subsample)
    p = _bf_pow2(N, 1)
    X = np.fft.rfft(x, n=p, axis=-1)
    k = np.arange(p // 2 + 1)
    y = np.fft.irfft(X * np.exp(2j * np.pi * k[None, :] * d[:, None] / p),
                     n=p, axis=-1)[:, :N]
    return y.mean(axis=0)


# --- i-vectors (goldens for tpufeat_torch.ivector) ---

def diag_gmm_log_likes(x: np.ndarray, weights: np.ndarray,
                       means: np.ndarray, vars_: np.ndarray) -> np.ndarray:
    """Float64 golden for :meth:`tpufeat_torch.ivector.DiagUbm.log_likes`:
    direct per-gaussian evaluation, no GEMM re-association."""
    x = np.asarray(x, np.float64)
    w = np.asarray(weights, np.float64)
    mu = np.asarray(means, np.float64)
    var = np.asarray(vars_, np.float64)
    d = x[:, None, :] - mu[None, :, :]                  # [T, G, D]
    return (np.log(w)[None, :]
            - 0.5 * np.log(2.0 * np.pi * var).sum(axis=1)[None, :]
            - 0.5 * (d * d / var[None]).sum(axis=2))


def gmm_posteriors(x: np.ndarray, weights, means, vars_,
                   min_post: float = 0.0) -> np.ndarray:
    """Softmax responsibilities with Kaldi-style min_post pruning."""
    ll = diag_gmm_log_likes(x, weights, means, vars_)
    ll -= ll.max(axis=1, keepdims=True)
    post = np.exp(ll)
    post /= post.sum(axis=1, keepdims=True)
    if min_post > 0.0:
        post[post < min_post] = 0.0
        post /= np.maximum(post.sum(axis=1, keepdims=True), 1e-20)
    return post


def ivector_stats(x: np.ndarray, weights, means, vars_, *,
                  posterior_scale: float = 1.0,
                  min_post: float = 0.0):
    """(N [G], centered F [G, D]) Baum-Welch stats — golden for
    :meth:`tpufeat_torch.ivector.IvectorExtractor.stats`."""
    post = gmm_posteriors(x, weights, means, vars_,
                          min_post) * posterior_scale
    n = post.sum(axis=0)
    f = post.T @ np.asarray(x, np.float64) \
        - n[:, None] * np.asarray(means, np.float64)
    return n, f


def ivector_estimate(n: np.ndarray, f: np.ndarray, M: np.ndarray,
                     vars_: np.ndarray, max_count: float = 0.0
                     ) -> np.ndarray:
    """Posterior-mean i-vector from (N, F) stats — golden for
    :meth:`tpufeat_torch.ivector.IvectorExtractor.estimate`."""
    M = np.asarray(M, np.float64)
    inv = 1.0 / np.asarray(vars_, np.float64)           # [G, D]
    n = np.asarray(n, np.float64)
    f = np.asarray(f, np.float64)
    if max_count > 0.0:
        factor = min(1.0, max_count / max(n.sum(), 1e-20))
        n, f = n * factor, f * factor
    P = inv[:, :, None] * M                             # Σ⁻¹M [G, D, K]
    K = M.shape[2]
    L = np.eye(K) + np.einsum("g,gdk,gdl->kl", n, M, P)
    b = np.einsum("gd,gdk->k", f, P)
    return np.linalg.solve(L, b)


def ivector_features(x: np.ndarray, weights, means, vars_, M, *,
                     period: int = 10, posterior_scale: float = 0.1,
                     max_count: float = 0.0,
                     min_post: float = 0.0) -> np.ndarray:
    """Per-frame online i-vectors — float64 golden for
    :func:`tpufeat_torch.ivector.ivector_features` (direct loop over boundary
    grid: frame t carries the estimate from frames [0, (t//period)*
    period))."""
    x = np.asarray(x, np.float64)
    T = x.shape[0]
    K = np.asarray(M).shape[2]
    out = np.zeros((T, K))
    post = gmm_posteriors(x, weights, means, vars_,
                          min_post) * posterior_scale
    mu = np.asarray(means, np.float64)
    for m in range(-(-T // period)):
        lo, hi = m * period, min((m + 1) * period, T)
        p = post[:lo]
        n = p.sum(axis=0)
        f = p.T @ x[:lo] - n[:, None] * mu
        out[lo:hi] = ivector_estimate(n, f, M, vars_, max_count)
    return out


# --- PLDA (goldens for tpufeat_torch.plda) ---

def plda_transform_ivector(mean, transform, psi, x, n_examples=1,
                           normalize_length: bool = True) -> np.ndarray:
    """Float64 golden for :meth:`tpufeat_torch.plda.Plda.transform_ivector`:
    y = A(x - mean), optionally scaled so sum(y^2/(psi + 1/n)) == dim
    (Kaldi GetNormalizationFactor: a mean of n utterances has
    within-class variance 1/n)."""
    mean = np.asarray(mean, np.float64)
    a = np.asarray(transform, np.float64)
    psi = np.asarray(psi, np.float64)
    y = (np.asarray(x, np.float64) - mean) @ a.T
    if normalize_length:
        n = np.broadcast_to(np.asarray(n_examples, np.float64),
                            y.shape[:-1])
        sq = (y * y / (psi[None, :] + 1.0 / n[..., None])).sum(
            axis=-1, keepdims=True)
        y = y * np.sqrt(mean.size / np.where(sq > 0, sq, 1.0))
    return y


def plda_log_likelihood_ratio(mean, transform, psi, enroll, n_enroll,
                              test,
                              normalize_length: bool = True) -> np.ndarray:
    """Float64 golden for :meth:`tpufeat_torch.plda.Plda.score`: naive
    per-pair Kaldi LogLikelihoodRatio loop over [E, K] x [T, K] raw
    i-vectors -> [E, T]."""
    psi = np.asarray(psi, np.float64)
    n = np.broadcast_to(np.asarray(n_enroll, np.float64),
                        (np.shape(enroll)[0],))
    u = plda_transform_ivector(mean, transform, psi, enroll, n,
                               normalize_length=normalize_length)
    v = plda_transform_ivector(mean, transform, psi, test,
                               normalize_length=normalize_length)
    out = np.empty((u.shape[0], v.shape[0]))
    vn = 1.0 + psi
    for e in range(u.shape[0]):
        npsi = n[e] * psi
        m = npsi / (npsi + 1.0) * u[e]
        vg = 1.0 + psi / (npsi + 1.0)
        for t in range(v.shape[0]):
            given = -0.5 * (np.log(2.0 * np.pi * vg)
                            + (v[t] - m) ** 2 / vg).sum()
            without = -0.5 * (np.log(2.0 * np.pi * vn)
                              + v[t] ** 2 / vn).sum()
            out[e, t] = given - without
    return out


# --- fMLLR (goldens for tpufeat_torch.fmllr) ---

def fmllr_stats(x: np.ndarray, weights, means, vars_,
                min_post: float = 0.0):
    """Float64 golden for :func:`tpufeat_torch.fmllr.fmllr_stats`: naive
    frame x gaussian loop. [T, D] -> (beta, K [D, D+1],
    G [D, D+1, D+1])."""
    x = np.asarray(x, np.float64)
    means = np.asarray(means, np.float64)
    vars_ = np.asarray(vars_, np.float64)
    post = gmm_posteriors(x, weights, means, vars_, min_post)
    T, D = x.shape
    beta = post.sum()
    K = np.zeros((D, D + 1))
    G = np.zeros((D, D + 1, D + 1))
    for t in range(T):
        xe = np.append(x[t], 1.0)
        outer = np.outer(xe, xe)
        for g in range(means.shape[0]):
            if post[t, g] == 0.0:
                continue
            K += post[t, g] * (means[g] / vars_[g])[:, None] * xe[None, :]
            G += (post[t, g] / vars_[g])[:, None, None] * outer[None]
    return float(beta), K, G


# ---------------------------------------------------------------------------
# The models' losses (goldens of tpufeat_torch.models.train)
# ---------------------------------------------------------------------------

def transducer_loss(log_probs: np.ndarray, labels, T: int, U: int,
                    blank: int = 0) -> float:
    """Float64 golden for :func:`tpufeat_torch.models.train.transducer_loss`
    (single sequence): brute-force log-sum over ALL monotonic
    alignments by memoized recursion. ``log_probs``: [T, U+1, V]
    ALREADY log-softmaxed joint outputs."""
    import functools
    e = np.asarray(log_probs, np.float64)
    lab = tuple(int(v) for v in labels)

    @functools.lru_cache(maxsize=None)
    def p(t, u):
        if t == T - 1 and u == U:
            return e[t, u, blank]
        outs = []
        if t < T - 1:
            outs.append(e[t, u, blank] + p(t + 1, u))
        if u < U:
            outs.append(e[t, u, lab[u]] + p(t, u + 1))
        m = max(outs)
        return m + np.log(sum(np.exp(o - m) for o in outs))

    return float(-p(0, 0))


def ctc_sequence_logp(log_probs: np.ndarray, seq, blank: int = 0) -> float:
    """Float64 golden: log P(label sequence | CTC) by the standard
    forward pass over the blank-interleaved expansion. ``log_probs``:
    [T, V] ALREADY log-softmaxed."""
    lp = np.asarray(log_probs, np.float64)
    ext = [blank]
    for v in seq:
        ext += [int(v), blank]
    S = len(ext)
    NEG = -np.inf
    a = np.full(S, NEG)
    a[0] = lp[0, blank]
    if S > 1:
        a[1] = lp[0, ext[1]]
    for t in range(1, lp.shape[0]):
        b = np.full(S, NEG)
        for s in range(S):
            acc = a[s]
            if s >= 1:
                acc = np.logaddexp(acc, a[s - 1])
            if s >= 2 and ext[s] != blank and ext[s] != ext[s - 2]:
                acc = np.logaddexp(acc, a[s - 2])
            b[s] = acc + lp[t, ext[s]]
        a = b
    return float(np.logaddexp(a[S - 1], a[S - 2] if S > 1 else NEG))
