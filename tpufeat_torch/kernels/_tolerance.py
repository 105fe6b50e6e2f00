"""How far a tensor-core kernel (K1, K3, K4) may be from its plain twin,
and the comparison that holds it there; the CPU tests, the card tests and
``chip_smoke.py`` use it.

The kernel and the twin (``kernels/signal.py``, ``kernels/staged.py``)
compute the same products and differ in the order of their f32 sums. What
that allows, per output (:func:`twin_tolerance`): TOL_TWIN of max(1,
|twin|) for what the bounds do not model (the log's last ulps), the error
bound of that order through every later stage (:func:`sum_order_bound`),
and at ``"default"``, where a bf16 rounding of a value the two sum apart
can land one bf16 ulp away, the bound of such flips
(:func:`one_pass_bound`). K4's inputs are the spectrum rows themselves, so
its bound starts at the mel sum (:func:`tail_stages`).

The flip bound is loose: a flip of a bf16-rounded log-mel moves all of a
frame's MFCCs, by up to about 1 abs with lifter 22, and a wrong pass count
stays inside it. So at ``"default"`` :func:`compare_to_twin` also counts
whole frames: in every window of FLIP_WINDOW = 64 consecutive frames (the
call's rows in order; the width of the kernel's tile when the bound was
set, kept when the tile grew) at most FLIP_FRAMES may have an output past
TOL_TWIN. A sound kernel flips a frame now and then; a pass swap or a
wrong tile moves nearly every frame of a window.
On an H100 (``chip_smoke.py``, PERF.md) the sound kernel showed at most 4
such frames in a window and 1.2 % of a 3000-frame call's frames; the
bf16x3 kernel held as the default one, 64 and 100 %.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpufeat_torch.config import FeatureConfig
from tpufeat_torch.kernels.signal import (
    _LOG_KIND, cs_constant, dct_constant, fb_constant, log_tail, mm,
    no_tf32, passes, put, split_bf16)
from tpufeat_torch.kernels.staged import tail_fb_constant

TOL_TWIN = 1e-4        # kernel vs twin, relative to max(1, |twin|.max())
FLIP_FRAMES = 8        # at "default": frames past TOL_TWIN per window
FLIP_WINDOW = 64       # consecutive frames of such a window
TWIN_ROWS = 1 << 16    # rows per chunk of twin_tolerance


class Agreement(NamedTuple):
    max_abs_err: float
    scaled: float          # max_abs_err / max(1, |twin|.max())
    frames_past: float     # share of frames with an output past TOL_TWIN
    worst_window: int      # most such frames in one window of the tile's


def twin_stages(frames: torch.Tensor, cfg: FeatureConfig,
                fold_kaldi: bool) -> dict:
    """The twin's stages on ``frames`` [R, frame_length] (float64 where
    they feed a bound): z, S = |frames| @ |CS|, the spectrum and the mel."""
    cs = put(cs_constant(cfg, fold_kaldi), frames.device)
    fb = put(fb_constant(cfg), frames.device)
    with no_tf32():
        z = mm(frames, cs, passes(cfg))
        s = frames.abs() @ cs.abs()
    z, s, fb = z.double(), s.double(), fb.double()
    sq = z * z
    if cfg.spectrum == "magnitude":
        nb = cfg.n_bins
        im2 = torch.zeros_like(sq[:, :nb])
        im2[:, 1: nb - 1] = sq[:, nb:]
        spec = torch.sqrt(sq[:, :nb] + im2)
    else:
        spec = sq
    return dict(z=z, s=s, spec=spec, fb=fb, mel=spec @ fb)


def tail_stages(spec: torch.Tensor, cfg: FeatureConfig) -> dict:
    """K4's stages on spectrum rows ``spec`` [R, n_bins], float64: the
    spectrum and the mel (no DFT: both sides split the same rows)."""
    fb = put(tail_fb_constant(cfg), spec.device).double()
    spec = spec.double()
    return dict(spec=spec, fb=fb, mel=spec @ fb)


def sum_order_bound(t: dict, cfg: FeatureConfig) -> torch.Tensor:
    """Per-output bound on |kernel - twin| from the order of the f32 sums
    alone, from the twin's stages ``t`` on frames [R, frame_length]
    (:func:`twin_stages`) or spectrum rows (:func:`tail_stages`); [R, D].

    Both compute the same products and differ in the order of the f32
    sums. A sum of n terms rounds to within about sqrt(n) 2^-24 of the sum
    of their magnitudes (the probabilistic form of the sum's error bound,
    Higham and Mary 2019; the worst case n 2^-24 is some 35 times looser
    at n = 1200 and no longer tells bf16x3 from one pass). So each side's z
    (n = passes x frame_length terms) is off by about sqrt(n) 2^-24 S,
    S = |frames| @ |CS|, and the two by dz = 2 sqrt(n) 2^-24 S: relative
    to S, not to |z|, which is how a narrow mel band over a near-silent bin
    gets a large relative error. Then z*z moves by (2|z| + dz) dz (|X| by
    its two dz), and what the split of the spectrum drops by 2^-16 of it
    at one and three passes (hi + lo keeps 16 bits), 2^-24 at six (hi +
    mid + lo keeps all of an f32's); the mel sum by its own 2 sqrt(n)
    2^-24, the log by the mel's move over the smaller of the two mels (over
    ln 10 for log10), and the DCT by the log-mel's moves, its split and its
    sum, through |dct|. Where the bins are not near-silent this stays below
    TOL_TWIN. K4's stages have no z: the spectrum is the input, the same
    on both sides."""
    n = passes(cfg)
    split = 2.0 ** -24 if n == 6 else 2.0 ** -16
    u = 2.0 ** -24
    if "z" in t:
        dz = 2 * math.sqrt(n * cfg.frame_length) * u * t["s"]
        if cfg.spectrum == "magnitude":
            nb = cfg.n_bins
            dspec = dz[:, :nb].clone()
            dspec[:, 1: nb - 1] += dz[:, nb:]
        else:
            dspec = (2 * t["z"].abs() + dz) * dz
        dspec = dspec + split * t["spec"]
    else:
        dspec = torch.zeros_like(t["spec"])
    fb = t["fb"].abs()
    dmel = dspec @ fb + 2 * math.sqrt(n * fb.shape[0]) * u * (t["spec"] @ fb)
    if cfg.log == "none":
        dlog = dmel
    else:
        per = 1.0 if _LOG_KIND[cfg.log] == 1 else 1.0 / math.log(10.0)
        dlog = per * dmel / torch.clamp(t["mel"] - dmel, min=cfg.log_floor)
    dct = dct_constant(cfg)
    if dct is None:
        return dlog
    logmel = log_tail(t["mel"], None, cfg).abs()
    w = torch.tensor(dct, dtype=torch.float64, device=logmel.device).abs()
    return (dlog + split * logmel) @ w + \
        2 * math.sqrt(n * w.shape[0]) * u * (logmel @ w)


def one_pass_bound(logmel: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Per-output bound on the bf16 flips of ``"default"`` between the
    kernel and the twin, from the twin's log-mel ``logmel`` [..., n_mels]
    (its output with n_mfcc = 0).

    The two sum z in another order, so bf16_rn(z*z) can land one bf16 ulp
    apart (at most 2^-7 of the term), and the mel, a sum of non-negative
    terms, moves by at most 2^-7 of itself: the log by 2^-7 (natural),
    2^-7 / ln 10 (log10), or the mel by 2^-7 |mel| (no log). With a DCT,
    bf16_rn of that log-mel can then also move by one ulp of itself, and
    each mel reaches output d through |dct_hi[m, d]|."""
    lm = logmel.detach().double()
    if cfg.log == "none":
        moved = 2.0 ** -7 * lm.abs()
    else:
        per = 1.0 if _LOG_KIND[cfg.log] == 1 else 1.0 / math.log(10.0)
        moved = torch.full_like(lm, 2.0 ** -7 * per)
    dct = dct_constant(cfg)
    if dct is None:
        return moved
    ulp = torch.ldexp(torch.ones_like(lm), torch.frexp(lm)[1] - 8)
    weights = split_bf16(torch.tensor(dct))[0].double().abs()
    return (moved + ulp) @ weights.to(lm.device)


def twin_tolerance(want: torch.Tensor, inputs: torch.Tensor,
                   cfg: FeatureConfig, fold_kaldi: bool = True,
                   spectrum: bool = False) -> torch.Tensor:
    """Elementwise bound on |kernel - twin| for the outputs ``want`` of
    ``inputs``: frames [R, frame_length] (K1, K3), or with ``spectrum``
    K4's spectrum rows [R, n_bins]. TOL_TWIN of max(1, |want|), plus
    :func:`sum_order_bound`, plus at ``"default"`` :func:`one_pass_bound`.
    Chunked over rows."""
    lead = want.shape[:-1]
    want = want.reshape(-1, want.shape[-1])
    inputs = inputs.reshape(-1, inputs.shape[-1])
    parts = []
    for r0 in range(0, inputs.shape[0], TWIN_ROWS):
        chunk = inputs[r0: r0 + TWIN_ROWS]
        t = tail_stages(chunk, cfg) if spectrum else \
            twin_stages(chunk, cfg, fold_kaldi)
        tol = sum_order_bound(t, cfg)
        if passes(cfg) == 1:
            tol = tol + one_pass_bound(log_tail(t["mel"], None, cfg), cfg)
        parts.append(tol)
    scale = TOL_TWIN * max(1.0, want.abs().max().item())
    return (torch.cat(parts) + scale).reshape(*lead, want.shape[-1])


def frames_past(err: torch.Tensor, limit: float) -> tuple[float, int]:
    """(share of frames with an error past ``limit``, most such frames in
    one window of FLIP_WINDOW consecutive frames) of errors
    [..., D], one frame per row."""
    past = (err.reshape(-1, err.shape[-1]) > limit).any(-1)
    pad = -past.numel() % FLIP_WINDOW
    windows = torch.cat([past, past.new_zeros(pad)]).reshape(
        -1, FLIP_WINDOW).sum(-1)
    return past.double().mean().item(), int(windows.max().item())


def compare_to_twin(got: torch.Tensor, want: torch.Tensor,
                    inputs: torch.Tensor, cfg: FeatureConfig,
                    fold_kaldi: bool = True, what: str = "",
                    spectrum: bool = False) -> Agreement:
    """A kernel's output against its twin's for ``inputs`` (frames, or
    with ``spectrum`` K4's spectrum rows); raises AssertionError past
    :func:`twin_tolerance`, or at ``"default"`` where a window of
    FLIP_WINDOW rows holds more than FLIP_FRAMES rows past TOL_TWIN
    (see the module docstring)."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: not finite")
    err = (got.double() - want.double()).abs()
    tol = twin_tolerance(want, inputs, cfg, fold_kaldi, spectrum)
    if not bool((err <= tol).all()):
        worst = (err / tol).max().item()
        raise AssertionError(f"{what}: error up to {worst:.3f} x the "
                             f"tolerance (max abs error {err.max():.3e})")
    scale = max(1.0, want.abs().max().item())
    share, window = frames_past(err, TOL_TWIN * scale)
    if passes(cfg) == 1 and window > FLIP_FRAMES:
        raise AssertionError(f"{what}: {window} of {FLIP_WINDOW} "
                             f"consecutive frames past {TOL_TWIN} scaled "
                             f"(at most {FLIP_FRAMES} may flip)")
    return Agreement(err.max().item(), err.max().item() / scale, share,
                     window)
