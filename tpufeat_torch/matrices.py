"""Precomputed DSP constant matrices (window, mel filterbank, DCT, lifter).

A copy of ``tpufeat/matrices.py``: the same numpy code, so every constant
the port builds is bit for bit the reference's. All constructors are pure
NumPy float64 and cached. The torch pipeline casts them to float32 once per
(config, device); the float64 originals feed the golden
(``tpufeat_torch.reference.cpu``).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "window",
    "hz_to_mel",
    "mel_to_hz",
    "mel_filterbank",
    "dct_matrix",
    "lifter_vector",
    "dft_matrices",
    "dft_matrix_combined",
    "kaldi_conditioning_matrix",
]


@functools.lru_cache(maxsize=None)
def window(kind: str, length: int) -> np.ndarray:
    """Analysis window, float64, shape [length].

    - ``hamming``: symmetric, 0.54 - 0.46 cos(2*pi*n/(L-1))  (reference C4)
    - ``hann_periodic``: 0.5 - 0.5 cos(2*pi*n/L) (torch.hann_window default,
      what Whisper uses)
    - ``povey``: Kaldi's (0.5 - 0.5 cos(2*pi*n/(L-1)))**0.85
    - ``rect``: ones
    """
    n = np.arange(length, dtype=np.float64)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (length - 1))
    if kind == "hann_periodic":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)
    if kind == "povey":
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))) ** 0.85
    if kind == "rect":
        return np.ones(length, dtype=np.float64)
    raise ValueError(f"unknown window kind {kind!r}")


def hz_to_mel(f, scale: str = "htk"):
    """Hz -> mel. ``htk``: 2595*log10(1+f/700). ``slaney``: linear below
    1 kHz (f / (200/3)), logarithmic above (librosa/Slaney toolbox)."""
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    if scale == "erb":
        # Glasberg & Moore ERB-rate scale (the gammatone/GFCC spacing):
        # E(f) = 21.4 log10(1 + 0.00437 f)
        return 21.4 * np.log10(1.0 + 0.00437 * f)
    if scale == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp  # 15.0
        logstep = np.log(6.4) / 27.0
        mel = f / f_sp
        above = f >= min_log_hz
        mel = np.where(
            above,
            min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
            mel,
        )
        return mel
    raise ValueError(f"unknown mel scale {scale!r}")


def mel_to_hz(m, scale: str = "htk"):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    if scale == "erb":
        return (10.0 ** (m / 21.4) - 1.0) / 0.00437
    if scale == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        f = m * f_sp
        above = m >= min_log_mel
        f = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)
        return f
    raise ValueError(f"unknown mel scale {scale!r}")


def vtln_warp_freq(freq, low_freq: float, high_freq: float,
                   vtln_low: float, vtln_high: float, warp: float):
    """Kaldi-convention piecewise-linear VTLN frequency warp (published
    spec: Kaldi feat/mel-computations.cc ``MelBanks::VtlnWarpFreq``;
    independent construction here).

    The mid band [l, h] is scaled by 1/warp; affine segments join it
    continuously and monotonically to the FIXED endpoints low_freq and
    high_freq, so the warped filterbank still spans exactly
    [low_freq, high_freq]:

        l = vtln_low  * max(1, warp)      h = vtln_high * min(1, warp)
        W(f) = low_freq  + scale_left  * (f - low_freq)    f <  l
             = f / warp                                    l <= f < h
             = high_freq + scale_right * (f - high_freq)   f >= h

    with scale_left / scale_right chosen for continuity at l and h.
    Frequencies outside [low_freq, high_freq] pass through unchanged.
    ``freq`` may be a scalar or ndarray (float64)."""
    if warp <= 0:
        raise ValueError(f"vtln warp must be positive, got {warp}")
    if not low_freq <= vtln_low < vtln_high <= high_freq:
        raise ValueError(
            f"need low_freq <= vtln_low < vtln_high <= high_freq, got "
            f"{low_freq} / {vtln_low} / {vtln_high} / {high_freq}")
    l = vtln_low * max(1.0, warp)
    h = vtln_high * min(1.0, warp)
    if not low_freq < l < h < high_freq:
        raise ValueError(
            f"warp {warp} pushes the cutoffs ({l:.1f}, {h:.1f}) outside "
            f"({low_freq}, {high_freq}); tighten vtln_low/vtln_high")
    scale = 1.0 / warp
    scale_left = (scale * l - low_freq) / (l - low_freq)
    scale_right = (high_freq - scale * h) / (high_freq - h)
    f = np.asarray(freq, np.float64)
    out = np.where(f < l, low_freq + scale_left * (f - low_freq),
                   np.where(f < h, scale * f,
                            high_freq + scale_right * (f - high_freq)))
    return np.where((f < low_freq) | (f > high_freq), f, out)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    scale: str = "htk",
    norm: str | None = None,
    bin_style: str = "bin",
    vtln_warp: float = 1.0,
    vtln_low: float = 100.0,
    vtln_high: float = -500.0,
) -> np.ndarray:
    """Triangular mel filterbank, float64, shape [n_fft//2 + 1, n_mels].

    Laid out for right-multiplication: ``mel = power @ W`` with ``power``
    of shape [frames, n_bins] — the orientation the MXU matmul in the fused
    Pallas kernel consumes (SURVEY.md §2 C7).

    bin_style:
      - ``bin``: classic HTK/python_speech_features construction — triangle
        corners snapped to integer FFT bins ``floor((n_fft+1)*f/sr)``
        (SURVEY.md §2 C7 names exactly this mapping).
      - ``continuous``: librosa-style — triangles evaluated at exact bin
        center frequencies ``k*sr/n_fft`` (Whisper's filterbank).
      - ``gammatone``: 4th-order gammatone POWER-response weights at
        the scale's center points (pair with ``scale="erb"`` for the
        classic GFCC bank): ``w(f) = |H(f)|^2 = (1 + ((f - fc)/b)^2)^-4``
        with ``|H| = (1 + x^2)^-(order/2)`` and ``b = 1.019 * ERB(fc)``
        (Glasberg & Moore), unit peak at fc. The SQUARED magnitude is
        the right weight because this matrix multiplies the POWER
        spectrum (Kim & Stern 2012 define channel power as
        sum_k |X_k|^2 |H_m(k)|^2 — review fix; the earlier |H| weights
        under-rolled the skirts by half). Rides the same MXU matmul as
        the triangles.
    """
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(
        hz_to_mel(fmin, scale), hz_to_mel(fmax, scale), n_mels + 2
    )
    hz_pts = mel_to_hz(mel_pts, scale)
    if vtln_warp != 1.0:
        # Kaldi's VtlnWarpMelFreq: warp the triangle corner frequencies
        # (mel-domain warp == frequency-domain warp of the corner points);
        # vtln_high <= 0 means fmax + vtln_high, Kaldi's CLI convention.
        vh = vtln_high if vtln_high > 0 else fmax + vtln_high
        hz_pts = vtln_warp_freq(hz_pts, fmin, fmax, vtln_low, vh,
                                vtln_warp)
    weights = np.zeros((n_bins, n_mels), dtype=np.float64)

    if bin_style == "bin":
        bins = np.floor((n_fft + 1) * hz_pts / sample_rate).astype(np.int64)
        for m in range(n_mels):
            lo, ctr, hi = bins[m], bins[m + 1], bins[m + 2]
            for k in range(lo, ctr):
                if ctr > lo:
                    weights[k, m] = (k - lo) / (ctr - lo)
            for k in range(ctr, hi):
                if hi > ctr:
                    weights[k, m] = (hi - k) / (hi - ctr)
    elif bin_style == "gammatone":
        fft_freqs = np.arange(n_bins, dtype=np.float64) * sample_rate / n_fft
        fc = hz_pts[1: n_mels + 1]                       # center points
        erb = 24.7 * (4.37 * fc / 1000.0 + 1.0)
        b = 1.019 * erb
        rel = (fft_freqs[:, None] - fc[None, :]) / b[None, :]
        weights = (1.0 + rel * rel) ** -4.0     # |H|^2, 4th order
    elif bin_style == "continuous":
        fft_freqs = np.arange(n_bins, dtype=np.float64) * sample_rate / n_fft
        fdiff = np.diff(hz_pts)
        ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
        for m in range(n_mels):
            lower = -ramps[m] / fdiff[m]
            upper = ramps[m + 2] / fdiff[m + 1]
            weights[:, m] = np.maximum(0.0, np.minimum(lower, upper))
    else:
        raise ValueError(f"unknown bin_style {bin_style!r}")

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm.reshape(1, -1)
    elif norm is not None:
        raise ValueError(f"unknown mel norm {norm!r}")
    return weights


@functools.lru_cache(maxsize=None)
def mel_center_freqs(n_mels: int, fmin: float, fmax: float,
                     scale: str = "htk") -> np.ndarray:
    """Center frequency (Hz) of each filterbank band, float64 [n_mels] —
    the same mel-spaced grid :func:`mel_filterbank` builds its triangles
    on (points 1..n_mels of the n_mels+2 linspace)."""
    mel_pts = np.linspace(
        hz_to_mel(fmin, scale), hz_to_mel(fmax, scale), n_mels + 2)
    return mel_to_hz(mel_pts, scale)[1: n_mels + 1]


@functools.lru_cache(maxsize=None)
def equal_loudness_vector(n_mels: int, fmin: float, fmax: float,
                          scale: str = "htk") -> np.ndarray:
    """Equal-loudness weight El(f) at each band center, float64 [n_mels]
    (PLP step 2; Hermansky 1990 eq. 4 / the Kaldi-HTK approximation):

        El(f) = (f^2/(f^2+1.6e5))^2 * (f^2+1.44e6)/(f^2+9.61e6)
    """
    f2 = mel_center_freqs(n_mels, fmin, fmax, scale) ** 2
    return ((f2 / (f2 + 1.6e5)) ** 2) * (f2 + 1.44e6) / (f2 + 9.61e6)


@functools.lru_cache(maxsize=None)
def plp_idft_matrix(n_mels: int, order: int) -> np.ndarray:
    """IDFT-to-autocorrelation matrix, float64 [n_mels + 2, order + 1].

    ``r = a @ M`` with ``a`` the compressed band spectrum extended by
    duplicated endpoints (a_0 := E_1, a_{M+1} := E_M). Columns evaluate
    the inverse DFT of the even-symmetric period-N extension (N = 2(M+1)):

        r_k = (1/N) [a_0 + (-1)^k a_{M+1} + 2 sum_{j=1..M} a_j cos(pi k j / (M+1))]
    """
    m1 = n_mels + 1
    j = np.arange(n_mels + 2, dtype=np.float64).reshape(-1, 1)
    k = np.arange(order + 1, dtype=np.float64).reshape(1, -1)
    mat = 2.0 * np.cos(np.pi * k * j / m1)
    mat[0, :] = 1.0
    mat[-1, :] = (-1.0) ** np.arange(order + 1)
    return mat / (2.0 * m1)


@functools.lru_cache(maxsize=None)
def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, float64, shape [n_in, n_out].

    ``mfcc = logmel @ D`` with logmel [frames, n_in]. Matches
    ``scipy.fft.dct(x, type=2, norm="ortho")`` truncated to n_out
    coefficients (reference C9: c_i = sum_j x_j cos(pi*i*(2j+1)/(2M)) with
    ortho scaling sqrt(2/M), c_0 scaled by 1/sqrt(2))."""
    j = np.arange(n_in, dtype=np.float64).reshape(-1, 1)
    i = np.arange(n_out, dtype=np.float64).reshape(1, -1)
    mat = np.cos(np.pi * i * (2.0 * j + 1.0) / (2.0 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[:, 0] *= 1.0 / np.sqrt(2.0)
    return mat


@functools.lru_cache(maxsize=None)
def lifter_vector(n_coeffs: int, lifter: int) -> np.ndarray:
    """Sinusoidal lifter 1 + (L/2) sin(pi*i/L), float64, shape [n_coeffs]."""
    if lifter <= 0:
        return np.ones(n_coeffs, dtype=np.float64)
    i = np.arange(n_coeffs, dtype=np.float64)
    return 1.0 + (lifter / 2.0) * np.sin(np.pi * i / lifter)


@functools.lru_cache(maxsize=None)
def dft_matrices(
    frame_length: int, n_fft: int, window_kind: str
) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT-as-GEMM matrices with the window folded in, float64.

    Returns (C, S), each [frame_length, n_fft//2 + 1], such that for a raw
    frame x of length ``frame_length`` (implicitly zero-padded to n_fft):

        Re(rfft(w*x, n_fft)) =  x @ C        (C[j,k] = w[j]*cos(2*pi*j*k/n_fft))
        Im(rfft(w*x, n_fft)) =  x @ S        (S[j,k] = -w[j]*sin(2*pi*j*k/n_fft))

    This is the GEMM-native NDFT formulation: on TPU the DFT becomes two MXU
    matmuls instead of an FFT, trading ~18x FLOPs for full fusion — and the
    pipeline is >3000x below the v5e compute roofline (SURVEY.md §6), so the
    trade is free.
    """
    w = window(window_kind, frame_length)
    j = np.arange(frame_length, dtype=np.float64).reshape(-1, 1)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64).reshape(1, -1)
    ang = 2.0 * np.pi * j * k / n_fft
    c = np.cos(ang) * w.reshape(-1, 1)
    s = -np.sin(ang) * w.reshape(-1, 1)
    return c, s


@functools.lru_cache(maxsize=None)
def dft_matrix_combined(
    frame_length: int, n_fft: int, window_kind: str
) -> np.ndarray:
    """Re and Im DFT-as-GEMM matrices packed into ONE [frame_length, n_fft]
    matrix so the kernel's DFT is a single MXU matmul chain.

    Column layout for n_bins = n_fft//2 + 1:
      - cols 0 .. n_bins-1:            Re(X_k)         (all bins)
      - cols n_bins-1+k, k=1..n_bins-2: Im(X_k)        (interior bins only —
        Im(X_0) and Im(X_{n_fft/2}) are identically zero for real input, so
        storing them would waste two MXU lanes)

    Total columns = 2*n_bins - 2 = n_fft exactly. The power spectrum is then
    a LINEAR rearrangement of the squared columns, |X_k|^2 = z_k^2 +
    z_{n_bins-1+k}^2, which folds straight into the mel matmul
    (:func:`mel_filterbank_folded`) — the power spectrum never exists as a
    tensor."""
    c, s = dft_matrices(frame_length, n_fft, window_kind)
    n_bins = n_fft // 2 + 1
    return np.concatenate([c, s[:, 1: n_bins - 1]], axis=1)


@functools.lru_cache(maxsize=None)
def mel_filterbank_folded(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    scale: str = "htk",
    norm: str | None = None,
    bin_style: str = "bin",
    vtln_warp: float = 1.0,
    vtln_low: float = 100.0,
    vtln_high: float = -500.0,
) -> np.ndarray:
    """Mel filterbank rearranged for the combined-DFT column layout
    (:func:`dft_matrix_combined`): shape [n_fft, n_mels] with row k = FB[k]
    for k < n_bins and row n_bins-1+k = FB[k] for the interior Im columns.
    ``mel = (z*z) @ W`` then equals ``|X|^2 @ FB`` exactly."""
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax,
                        scale, norm, bin_style, vtln_warp, vtln_low,
                        vtln_high)
    n_bins = n_fft // 2 + 1
    out = np.zeros((n_fft, n_mels), dtype=np.float64)
    out[:n_bins] = fb
    out[n_bins:] = fb[1: n_bins - 1]
    return out


@functools.lru_cache(maxsize=None)
def kaldi_conditioning_matrix(
    frame_length: int, preemphasis: float, dc_offset: bool
) -> np.ndarray:
    """Kaldi's per-frame conditioning as a [frame_length, frame_length]
    right-multiplication matrix: for a row-vector frame f,

        f @ M  ==  per-frame-preemphasis(dc-offset-removal(f))

    Both steps are linear, so M = (I - J/L) @ T with J the all-ones matrix
    (mean removal) and T the pre-emphasis bidiagonal (T[i,i]=1,
    T[i-1,i]=-alpha, T[0,0]=1-alpha — Kaldi's x[-1]:=x[0] convention).
    Left-multiplying the DFT matrices by M folds kaldi_mode into the fused
    signal kernel with zero runtime cost (framing.condition_frames is the
    materialized-frames twin)."""
    L = frame_length
    m = np.eye(L, dtype=np.float64)
    if dc_offset:
        m = m - np.full((L, L), 1.0 / L)
    if preemphasis:
        t = np.eye(L, dtype=np.float64)
        t[0, 0] = 1.0 - preemphasis
        idx = np.arange(L - 1)
        t[idx, idx + 1] = -preemphasis
        m = m @ t
    return m


@functools.lru_cache(maxsize=None)
def nccf_gemm_matrices(
    frame_length: int, lag_min: int, lag_max: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Cross-correlation-as-GEMM matrices for the NCCF numerators,
    float64 (pitch C-analog; beyond-reference capability).

    For an extended pitch frame b of length wext = frame_length + lag_max
    and its prefix a = b[:frame_length], the linear correlation

        num[l] = sum_i a_i * b_{i+l},   l in [lag_min, lag_max]

    equals the circular correlation at transform length n = wext (the
    largest touched index is frame_length - 1 + lag_max = n - 1, so
    nothing wraps), and a DFT of length n is just a pair of GEMMs —
    n need not be a power of two. Returns (C, S, Ci, Si):

        C, S   [wext, n//2 + 1]:  Fb = b @ C + i * (b @ S)
                                  Fa = a @ C[:frame_length] + i * ...
        Ci, Si [n//2 + 1, L]:     num = Re(conj(Fa)*Fb) @ Ci
                                        + Im(conj(Fa)*Fb) @ Si

    (Ci/Si fold the hermitian-extension weights and the 1/n of the
    inverse transform, and evaluate ONLY the L = lag_max - lag_min + 1
    lags the tracker scores — the full-length irfft the FFT formulation
    computes is 2/3 wasted work.) On the MXU this replaces three
    VPU-bound pow-of-two FFTs per frame (rfft x2 + irfft at
    2^ceil(log2(2 * wext))) with three dense matmuls; pitch_bench.py
    measures the speedup on chip."""
    n = frame_length + lag_max
    k = np.arange(n // 2 + 1, dtype=np.float64)
    i = np.arange(n, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(i, k) / n
    c, s = np.cos(ang), -np.sin(ang)
    lags = np.arange(lag_min, lag_max + 1, dtype=np.float64)
    w = np.full(n // 2 + 1, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    angi = 2.0 * np.pi * np.outer(k, lags) / n
    ci = w[:, None] * np.cos(angi) / n
    si = -w[:, None] * np.sin(angi) / n
    return c, s, ci, si
