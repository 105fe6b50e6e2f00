"""Feature-extraction configuration — a copy of ``tpufeat/config.py``.

The same frozen (hence hashable) dataclass with the same fields and presets,
so a config converts 1:1 between the two packages (:func:`from_reference`).
Hashability keys the per-(config, device) constant caches of the port.

``use_pallas + gemm_dft + fused_framing`` select the hand-written Hopper
signal kernel (``tpufeat_torch/kernels/signal.py``), and
``matmul_precision`` how many bf16 passes on the tensor cores each of its
products takes: six for "highest", three for "bf16x3", one for "default"
(see that module).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Full specification of one front-end pipeline.

    Mirrors the reference's stage list (SURVEY.md §2, C2-C9 + C15/C16):
    pre-emphasis -> framing/overlap -> window -> FFT -> power -> mel -> log
    -> DCT-II (-> lifter -> deltas -> CMVN).
    """

    # --- sampling / framing (reference C3) ---
    sample_rate: int = 16000
    frame_length: int = 400          # 25 ms @ 16 kHz
    hop_length: int = 160            # 10 ms @ 16 kHz
    n_fft: int = 512                 # zero-pad 400 -> 512 (reference C5)
    # center=True: reflect-pad n_fft//2 each side (Whisper/librosa style);
    # center=False: snip-edges framing, frames = 1 + (N - frame_length)//hop.
    center: bool = False
    # Whisper's torch.stft path computes 1 + N//hop centered frames and then
    # drops the final one, keeping exactly N//hop.
    drop_last_frame: bool = False

    # --- per-sample / per-frame conditioning (reference C2) ---
    preemphasis: float = 0.97
    # kaldi_mode=True processes each gathered frame independently (Kaldi's
    # order: dither -> DC offset -> per-frame pre-emphasis with x[-1]:=x[0]
    # -> window); kaldi_mode=False pre-emphasizes the whole signal first
    # (classic MFCC / python_speech_features order).
    kaldi_mode: bool = False
    dc_offset: bool = False          # subtract per-frame mean (kaldi_mode)
    dither: float = 0.0              # stddev of additive noise; 0 = off

    # --- window (reference C4) ---
    window: str = "hamming"          # hamming|hann_periodic|povey|rect

    # --- spectrum (reference C5/C6) ---
    spectrum: str = "power"          # power (|X|^2) | magnitude (|X|)

    # --- mel filterbank (reference C7) ---
    n_mels: int = 26                 # 0 -> no filterbank: raw (log-)power-
    #                                  spectrum features of dim n_fft//2+1
    #                                  (Kaldi compute-spectrogram-feats
    #                                  analogue; requires n_mfcc=0 and runs
    #                                  the XLA path — the fused Pallas
    #                                  kernels are mel-path kernels)
    mel_scale: str = "htk"           # htk (2595*log10(1+f/700)) | slaney
    mel_norm: Optional[str] = None   # None | "slaney" (area normalization)
    # "bin": integer FFT-bin triangles, floor((n_fft+1)*f/sr), the classic
    #   HTK/python_speech_features construction named in SURVEY.md §2 C7.
    # "continuous": librosa-style triangles evaluated at exact bin
    #   frequencies k*sr/n_fft (what Whisper's mel_filters uses).
    mel_bin_style: str = "bin"
    fmin: float = 0.0
    fmax: Optional[float] = None     # None -> sample_rate / 2
    # Vocal-tract-length normalization (Kaldi-convention piecewise-linear
    # warp of the triangle corner frequencies; matrices.vtln_warp_freq).
    # 1.0 = off. Typical per-speaker factors: 0.8-1.2.
    vtln_warp: float = 1.0
    vtln_low: float = 100.0          # warp band lower cutoff (Hz)
    vtln_high: float = -500.0        # upper cutoff; <= 0 means fmax + value

    # --- log compression (reference C8) ---
    log: str = "natural"             # natural|log10|whisper|none
    log_floor: float = 1e-10
    # "whisper": log10(max(S,1e-10)); L = max(L, L.max()-8); L = (L+4)/4,
    # with the max taken per-utterance over VALID frames only when batched.

    # --- cepstrum (reference C9) ---
    n_mfcc: int = 13                 # 0 -> stop at (log-)mel features
    lifter: int = 0                  # sinusoidal lifter length L; 0 = off
    use_energy: bool = False         # Kaldi-style log frame energy
    #                                  log(max(sum x^2, floor)) over the
    #                                  conditioned frame. MFCC: replaces c0;
    #                                  spectrogram (n_mels=0): replaces
    #                                  element 0; fbank (n_mfcc=0, n_mels>0):
    #                                  PREPENDED as an extra first column
    #                                  (dim n_mels+1), Kaldi
    #                                  compute-fbank-feats --use-energy

    # --- PLP (beyond-reference capability; tpufeat/plp.py) ---
    plp_order: int = 0               # LPC model order p; 0 = PLP off.
    #                                  When > 0 the cepstrum stage is
    #                                  replaced by the PLP chain (equal
    #                                  loudness -> (.)^plp_compress -> IDFT
    #                                  autocorrelation -> Levinson-Durbin ->
    #                                  LPC cepstra), output dim p+1 with
    #                                  c0 = ln(residual energy). Requires
    #                                  log="none", n_mfcc=0, use_energy off.
    plp_compress: float = 1.0 / 3.0  # intensity-loudness power law
    pncc: bool = False               # PNCC chain (Kim & Stern 2012) on the
    #                                  filterbank power (tpufeat/pncc.py);
    #                                  requires log="none", n_mfcc=0
    pncc_ceps: int = 13              # DCT coefficients kept by the chain

    # --- post (reference C16, config 3) ---
    deltas: bool = False             # append delta + delta-delta
    delta_window: int = 2
    delta_order: int = 2             # how many delta stages to append
    #                                  (Kaldi add-deltas --delta-order):
    #                                  1 = Δ only, 2 = Δ+ΔΔ (default),
    #                                  3 = +ΔΔΔ (HTK's _T)
    cmvn: str = "none"               # none|mean|meanvar (per-utterance,
    #                                  masked over valid frames) |
    #                                  sliding|sliding-meanvar (windowed —
    #                                  Kaldi apply-cmvn-sliding semantics,
    #                                  the normalization online ASR
    #                                  deploys; see features.sliding_cmvn)
    cmvn_window: int = 600           # sliding-CMVN window (frames)
    cmvn_min_window: int = 100       # causal start-edge future borrow
    cmvn_center: bool = False        # True: window centered on t (offline
    #                                  only); False: causal [t-window, t]

    # --- execution ---
    out_dtype: str = "float32"       # feature output dtype: float32|bfloat16
    #                                  (bf16 halves feature bandwidth when
    #                                  feeding a bf16 encoder; compute stays
    #                                  f32 internally)
    # Matmul precision of the fused, staged GEMM and tail kernels
    # (csrc/signal_mma.cu), every product at it as on the TPU, as bf16
    # products of the operands' pieces hi, mid, lo. "highest": six
    # (hi*hi + hi*mid + mid*hi + hi*lo + mid*mid + lo*hi, XLA's f32
    # emulation), within about 1e-6 of fp32 and inside the 1e-3 golden
    # budget. "bf16x3": the first three (hi*hi + hi*lo + lo*hi), inside the
    # budget for MFCC-13 and Whisper but not for FBANK80's DC band after
    # pre-emphasis (the TPU's neither). "default": one bf16 product,
    # training-only.
    matmul_precision: str = "highest"
    use_pallas: bool = False         # run the fused signal kernel
    gemm_dft: bool = False           # DFT as a GEMM against the windowed
    #                                  DFT matrix instead of an rFFT
    fused_framing: bool = False      # frame inside the kernel: frames never
    #                                  touch device memory. The Hopper
    #                                  kernel needs all three flags set

    def __post_init__(self):
        if self.frame_length > self.n_fft:
            raise ValueError(
                f"frame_length {self.frame_length} > n_fft {self.n_fft}")
        if self.window not in ("hamming", "hann_periodic", "povey", "rect"):
            raise ValueError(f"unknown window {self.window!r}")
        if self.mel_scale not in ("htk", "slaney", "erb"):
            raise ValueError(f"unknown mel_scale {self.mel_scale!r}")
        if self.mel_bin_style not in ("bin", "continuous",
                                      "gammatone"):
            raise ValueError(f"unknown mel_bin_style {self.mel_bin_style!r}")
        if self.log not in ("natural", "log10", "whisper", "none"):
            raise ValueError(f"unknown log {self.log!r}")
        if self.cmvn not in ("none", "mean", "meanvar", "sliding",
                             "sliding-meanvar"):
            raise ValueError(f"unknown cmvn {self.cmvn!r}")
        if self.cmvn.startswith("sliding"):
            if self.cmvn_window < 1 or self.cmvn_min_window < 1:
                raise ValueError(
                    "sliding CMVN needs cmvn_window >= 1 and "
                    f"cmvn_min_window >= 1 (got {self.cmvn_window}, "
                    f"{self.cmvn_min_window})")
            if self.cmvn_min_window > self.cmvn_window:
                # Kaldi asserts this too; beyond-window borrow would also
                # break the streaming twin's exactness (its first-batch
                # emission assumes the borrow never reaches past the
                # window, streaming.StreamingSlidingCMVN)
                raise ValueError(
                    f"cmvn_min_window {self.cmvn_min_window} > "
                    f"cmvn_window {self.cmvn_window}")
        if self.deltas and not 1 <= self.delta_order <= 3:
            # 3 is HTK's ceiling (_T, third differential); online latency
            # also grows as order*2*delta_window lookahead frames
            raise ValueError(
                f"delta_order must be 1..3, got {self.delta_order}")
        if self.spectrum not in ("power", "magnitude"):
            raise ValueError(f"unknown spectrum {self.spectrum!r}")
        if self.out_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown out_dtype {self.out_dtype!r}")
        if self.matmul_precision not in ("highest", "bf16x3", "default"):
            raise ValueError(
                f"unknown matmul_precision {self.matmul_precision!r}")
        if self.plp_order > 0:
            if self.log != "none" or self.n_mfcc != 0 or self.use_energy:
                raise ValueError(
                    "PLP configs define their own compression/cepstrum: "
                    "set log='none', n_mfcc=0, use_energy=False "
                    f"(got log={self.log!r}, n_mfcc={self.n_mfcc}, "
                    f"use_energy={self.use_energy})")
            if not 0.0 < self.plp_compress <= 1.0:
                raise ValueError(
                    f"plp_compress must be in (0, 1], got "
                    f"{self.plp_compress}")
        if self.pncc:
            if (self.log != "none" or self.n_mfcc != 0
                    or self.use_energy or self.plp_order > 0
                    or self.n_mels == 0):
                raise ValueError(
                    "PNCC configs define their own compression/cepstrum: "
                    "set log='none', n_mfcc=0, use_energy=False, "
                    "plp_order=0 on a filterbank config (got "
                    f"log={self.log!r}, n_mfcc={self.n_mfcc}, "
                    f"use_energy={self.use_energy}, "
                    f"plp_order={self.plp_order}, n_mels={self.n_mels})")
            if not 1 <= self.pncc_ceps <= self.n_mels:
                raise ValueError(
                    f"pncc_ceps must be in [1, n_mels], got "
                    f"{self.pncc_ceps}")
        if self.vtln_warp != 1.0:
            if not 0.25 <= self.vtln_warp <= 4.0:
                raise ValueError(
                    f"vtln_warp {self.vtln_warp} outside [0.25, 4.0]")
            # resolve + range-check the cutoffs eagerly so a bad config
            # fails at construction, not at first matrix build
            from tpufeat_torch import matrices
            vh = (self.vtln_high if self.vtln_high > 0
                  else self.fmax_hz + self.vtln_high)
            matrices.vtln_warp_freq(
                self.fmin, self.fmin, self.fmax_hz, self.vtln_low, vh,
                self.vtln_warp)
        if self.n_mels == 0:
            # spectrogram-features mode (Kaldi compute-spectrogram-feats):
            # the pipeline stops at the (log-)power spectrum, dim n_bins
            if self.n_mfcc != 0 or self.plp_order != 0:
                raise ValueError(
                    "n_mels=0 (spectrogram features) has no filterbank to "
                    "feed a cepstrum: set n_mfcc=0 and plp_order=0 "
                    f"(got n_mfcc={self.n_mfcc}, plp_order={self.plp_order})")
            if self.log == "whisper":
                raise ValueError(
                    "log='whisper' is a mel-path normalization; spectrogram "
                    "features (n_mels=0) support log in "
                    "('natural', 'log10', 'none')")
            if self.use_pallas:
                raise ValueError(
                    "the fused Pallas kernels are mel-path kernels "
                    "(DFT -> mel matmul on the MXU); spectrogram features "
                    "(n_mels=0) run the XLA path — set use_pallas=False "
                    "(gemm_dft=True is still honored)")
        elif self.n_mels < 0:
            raise ValueError(f"n_mels must be >= 0, got {self.n_mels}")
        if (self.use_energy and self.n_mfcc == 0 and self.n_mels > 0
                and self.plp_order == 0 and self.log not in
                ("natural", "log10")):
            # fbank + energy (Kaldi compute-fbank-feats --use-energy)
            # prepends a LOG frame energy column; linear ("none") or
            # whisper-normalized filterbanks can't host it coherently
            raise ValueError(
                "use_energy on filterbank configs (n_mfcc=0, n_mels>0) "
                "prepends a log frame energy column and requires log in "
                f"('natural', 'log10'), got log={self.log!r}")
        if self.gemm_dft and self.n_fft % 2:
            # the combined Re/Im DFT matrix drops Im(X_0) and Im(X_{n/2}),
            # which are only identically zero for EVEN n_fft
            raise ValueError(
                f"gemm_dft kernels require even n_fft (got {self.n_fft}); "
                f"use the rfft path (gemm_dft=False) for odd sizes")

    # ---- derived quantities (all static / python ints) ----

    @property
    def fmax_hz(self) -> float:
        return self.sample_rate / 2 if self.fmax is None else self.fmax

    @property
    def n_bins(self) -> int:
        """Number of rFFT bins."""
        return self.n_fft // 2 + 1

    @property
    def feature_dim(self) -> int:
        if self.plp_order > 0:
            base = self.plp_order + 1
        elif self.pncc:
            base = self.pncc_ceps
        elif self.n_mels == 0:
            base = self.n_bins          # spectrogram features
        elif self.n_mfcc > 0:
            base = self.n_mfcc
        else:
            # fbank: use_energy PREPENDS a log-energy column (Kaldi
            # compute-fbank-feats --use-energy), unlike the MFCC /
            # spectrogram paths where it substitutes element 0
            base = self.n_mels + (1 if self.use_energy else 0)
        return base * (1 + self.delta_order) if self.deltas else base

    def num_frames(self, n_samples: int) -> int:
        """Frame count for an utterance of ``n_samples`` (static version)."""
        if self.center:
            n = 1 + n_samples // self.hop_length
            return n - 1 if self.drop_last_frame else n
        if n_samples < self.frame_length:
            return 0
        return 1 + (n_samples - self.frame_length) // self.hop_length


# --- presets: BASELINE.json configs[0..3] (SURVEY.md §2.1) ---

#: Config 1 — classic MFCC-13: 25ms/10ms Hamming frames, 512-pt FFT,
#: 26 HTK mel bins, natural log, DCT-II keep 13.
MFCC13_HTK = FeatureConfig()

#: Config 2 — Whisper-style 80-bin log-mel: 400-pt FFT, hop 160, periodic
#: Hann, centered reflect padding, Slaney mel (area-normalized), Whisper
#: log10/clamp/scale normalization. No pre-emphasis, no cepstrum.
WHISPER80 = FeatureConfig(
    frame_length=400,
    hop_length=160,
    n_fft=400,
    center=True,
    drop_last_frame=True,
    preemphasis=0.0,
    window="hann_periodic",
    n_mels=80,
    mel_scale="slaney",
    mel_norm="slaney",
    mel_bin_style="continuous",
    log="whisper",
    n_mfcc=0,
)

#: Config 3 — Kaldi-style 39-dim: MFCC-13 + deltas + delta-deltas with
#: per-utterance (masked) cepstral mean normalization.
KALDI39 = FeatureConfig(
    deltas=True,
    cmvn="mean",
)

#: Config 4 — streaming front-end (used with streaming.StreamingFrontend;
#: the pipeline itself is the classic MFCC-13 one).
STREAMING160 = FeatureConfig()

#: Kaldi-fbank-style 80-bin log-mel (natural log, HTK mel, no cepstrum) —
#: the common neural-ASR input when not using the Whisper normalization.
FBANK80 = FeatureConfig(n_mels=80, n_mfcc=0)

#: Kaldi-style 13-dim PLP (beyond the reference's feature families):
#: 23 HTK mel bands -> equal loudness -> cube root -> order-12 LPC
#: cepstra + residual-log-energy c0 (tpufeat/plp.py).
PLP13 = FeatureConfig(n_mels=23, n_mfcc=0, log="none", plp_order=12)

#: Kaldi compute-spectrogram-feats analogue (beyond the reference's feature
#: families): 257-dim log power spectrum with Kaldi's per-frame conditioning
#: (dither off for parity; dc-offset removal, Povey window, per-frame
#: pre-emphasis) and the raw log frame energy in element 0.
SPEC257 = FeatureConfig(n_mels=0, n_mfcc=0, kaldi_mode=True, dc_offset=True,
                        window="povey", use_energy=True)

#: Whisper-large-v3 front-end: identical to WHISPER80 but 128 mel bins
#: (the only change OpenAI made for v3; parity-tested vs transformers'
#: WhisperFeatureExtractor(feature_size=128)).
WHISPER128 = dataclasses.replace(WHISPER80, n_mels=128)

#: Gammatone cepstral coefficients (beyond the reference's feature
#: families): 64 fourth-order gammatone |H|^2 power filters at ERB-rate
#: spacing (Glasberg & Moore), log compression, DCT-II keep 13 — the
#: spectral-domain GFCC construction used in robust speaker-ID. Shares
#: every kernel with the mel path (the bank is just a different
#: precomputed matrix).
GFCC13 = FeatureConfig(n_mels=64, n_mfcc=13, mel_scale="erb",
                       mel_bin_style="gammatone", fmin=50.0)

#: PNCC (Kim & Stern 2012) — robust-ASR cepstra (beyond the reference's
#: feature families): 40 gammatone-ERB power channels -> asymmetric
#: noise suppression + temporal masking + mean power normalization ->
#: 1/15 power law -> DCT-II keep 13 (tpufeat/pncc.py).
PNCC13 = FeatureConfig(n_mels=40, n_mfcc=0, mel_scale="erb",
                       mel_bin_style="gammatone", fmin=200.0,
                       log="none", pncc=True)

PRESETS = {
    "mfcc13": MFCC13_HTK,
    "gfcc13": GFCC13,
    "pncc13": PNCC13,
    "whisper80": WHISPER80,
    "whisper128": WHISPER128,
    "kaldi39": KALDI39,
    "streaming160": STREAMING160,
    "fbank80": FBANK80,
    "plp13": PLP13,
    "spec257": SPEC257,
}


def from_reference(fields: dict) -> FeatureConfig:
    """Build the port's config from a ``tpufeat`` config's fields, e.g.
    ``from_reference(dataclasses.asdict(jax_cfg))``. The two dataclasses
    share every field, so the result compares equal field for field."""
    names = {f.name for f in dataclasses.fields(FeatureConfig)}
    unknown = sorted(set(fields) - names)
    if unknown:
        raise ValueError(f"fields unknown to FeatureConfig: {unknown}")
    return FeatureConfig(**fields)


def speaker_from_reference(fields: dict):
    """Build the port's speaker model from a ``tpufeat`` model's numpy
    fields, e.g. ``speaker_from_reference(dict(weights=ubm.weights,
    means=ubm.means, vars=ubm.vars))``: {weights, means, vars} gives an
    ``ivector.DiagUbm``, the same and ``M`` an ``ivector.IvectorExtractor``,
    {mean, transform, psi} a ``plda.Plda``. The arrays are copied as
    float64, the models' own precision."""
    from tpufeat_torch.ivector import DiagUbm, IvectorExtractor
    from tpufeat_torch.plda import Plda

    kinds = {frozenset({"weights", "means", "vars"}): "ubm",
             frozenset({"weights", "means", "vars", "M"}): "extractor",
             frozenset({"mean", "transform", "psi"}): "plda"}
    kind = kinds.get(frozenset(fields))
    if kind is None:
        raise ValueError(f"fields {sorted(fields)} name no speaker model; "
                         f"want one of {[sorted(k) for k in kinds]}")
    f = {k: np.array(v, np.float64) for k, v in fields.items()}
    if kind == "plda":
        return Plda(f["mean"], f["transform"], f["psi"])
    ubm = DiagUbm(f["weights"], f["means"], f["vars"])
    return ubm if kind == "ubm" else IvectorExtractor(ubm, f["M"])
