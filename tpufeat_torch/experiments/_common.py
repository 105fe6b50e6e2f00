"""What the anatomy runners share: the scripts' geometries, their draws,
the timing loop of a runner's ``main``, and the tolerances that hold the
kernel to its plain twin.

Each runner module ports one script of ``benchmarks/experiments/`` to the
one Hopper kernel of the family (``kernels/anatomy.py``): ``inputs``
draws the script's arrays from ``np.random.default_rng(0)`` in the
script's order, ``MODES`` maps each of the script's mode names to
(DFT precision, mel precision, tail), and ``main`` times every mode on
the card.

Tolerances (:func:`compare`), kernel or twin against a reference:

- pre-log outputs (``nolog``, ``dftonly``): max abs error <= 1e-5 scaled
  by max(1, |want|.max()); products of bf16 operands are exact in f32 on
  both sides, so only the order of the f32 sums differs;
- log outputs (``sqlog``, ``log``): <= 1e-3 abs where the reference |m|
  is at least 1e-2 of the call's max |m|. The constants are standard
  normal, so the mels are signed (scale ~2e4) and log10(m*m + 1e-10)
  amplifies rounding without bound where |m| is near 0; those entries
  are masked and counted. The mask follows from the pre-log tolerance:
  an error of 1e-5 of max |m| moves log10(m*m) by 0.87e-5 max|m| / |m|,
  which is within 1e-3 where |m| >= 0.87e-2 of max |m|. (At a 1e-3 mask
  the kernel's tensor-core sums reached 1.075e-3 on the card.)
- a mel product of one or two bf16 passes (``bf16x1``, ``bf16x2``) drops
  the lo part of z*z, so a one-ulp f32 difference in z (another sum
  order) can move bf16_rn(z*z) by one bf16 ulp (at most 2^-7 of it), and
  m by that through one |FB| entry. Those modes are held on |m|
  (recovered from a log tail) within that one-flip bound,
  :func:`flip_tolerance`. It does not separate pass counts (they differ
  by 1.7e-3 to 4.4e-3 of max |m| from f32), so the passes are checked
  where no z*z is rounded differently: the ``dftonly`` tail at every DFT
  precision, and every mel precision behind an identity DFT (z = the
  signal, exactly), both at the pre-log tolerance.
- the TPU's HIGH (bf16x3 here, f32 in Pallas interpret mode) is held on
  |m| within 1e-4 (``TOL_HIGH``).
"""

from __future__ import annotations

import subprocess
import sys
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch import features
from tpufeat_torch.kernels import anatomy
from tpufeat_torch.profile_stream import event_ms

NCS, NM = 512, 128          # DFT columns, mel bands
HOP, ROWW, H = 160, 640, 4  # one hop; a phase row holds H hops
REPS = 11                   # timed runs per mode (median)
TOL_PRE = 1e-5
TOL_HIGH = 1e-4
TOL_LOG = 1e-3
MASK_FRACTION = 1e-2


class Inputs(NamedTuple):
    main: torch.Tensor          # [B, R, W] f32
    bnd: torch.Tensor           # [B, nblk, 8, W] f32
    consts: anatomy.Constants


def win(p: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """Phase p's two aligned lane windows (start, size), the scripts'
    ``win``: row r's window, then the first k1 lanes of row r + 1."""
    s0 = p * HOP
    e0 = min(s0 + 400, ROWW)
    a0 = (s0 // 128) * 128
    b0 = -(-e0 // 128) * 128
    rem = max(0, s0 + 400 - ROWW)
    b1 = -(-rem // 128) * 128 if rem else 0
    return (a0, b0 - a0), (0, b1)


def rows(m, idx):
    """Rows ``idx`` of a matrix given as an array or a (hi, lo[, f32])
    tuple of arrays."""
    if isinstance(m, (tuple, list)):
        return tuple(np.asarray(a)[idx] for a in m)
    return np.asarray(m)[idx]


def phase_terms(pairs) -> list:
    """The term table of the four-phase geometry: ``pairs[p]`` is phase
    p's (D0, D1) as the script holds them (D1 None or unused where k1 is
    0). Term 0 contracts row r's window a0 : a0 + k0, term 1 the first k1
    lanes of row r + 1 (the scripts' roll by one row)."""
    terms = []
    for p, (d0, d1) in enumerate(pairs):
        (a0, _), (_, k1) = win(p)
        phase = [(0, a0, d0)]
        if k1:
            phase.append((1, 0, rows(d1, slice(0, k1))))
        terms.append(phase)
    return terms


def signal(rng, shape_main, shape_bnd, device):
    """``main`` and ``bnd`` as the scripts draw them: float64 normals, then
    float32."""
    dev = features.default_device(device)
    main = torch.from_numpy(rng.standard_normal(shape_main).astype(np.float32))
    bnd = torch.from_numpy(rng.standard_normal(shape_bnd).astype(np.float32))
    return main.to(dev), bnd.to(dev), dev


def phase_inputs(device, B: int, F: int, TR: int,
                 k1_only: bool = False) -> Inputs:
    """The four-phase scripts' draws (``phase_kernel``, ``phase_anatomy``
    1-4): main [B, F/4, 640], bnd, then per phase D0 [k0, 512] and D1
    [max(k1, 128), 512] (drawn even where k1 is 0 and D1 is unused), then
    FB [512, 128]. ``k1_only`` is ``phase_anatomy5``'s order: D1 [k1, 512]
    only where k1 > 0."""
    R = F // H
    rng = np.random.default_rng(0)
    main, bnd, dev = signal(rng, (B, R, ROWW), (B, R // TR, 8, ROWW), device)
    pairs = []
    for p in range(4):
        (_, k0), (_, k1) = win(p)
        d0 = rng.standard_normal((k0, NCS)).astype(np.float32)
        d1 = None
        if k1 or not k1_only:
            d1 = rng.standard_normal(
                (k1 if k1_only else max(k1, 128), NCS)).astype(np.float32)
        pairs.append((d0, d1))
    fb = rng.standard_normal((NCS, NM)).astype(np.float32)
    return Inputs(main, bnd,
                  anatomy.constants_from_numpy(phase_terms(pairs), fb, dev))


def phase_runner(script: str, modes: dict, same: dict, tr: int,
                 k1_only: bool = False):
    """(``inputs``, ``main``) of a four-phase script's runner: its draws at
    its sizes with ``tr`` rows per block by default, and its timing."""
    def inputs(device=None, B: int = 128, F: int = 3072,
               TR: int = tr) -> Inputs:
        """The script's arrays at its sizes (or smaller ones): main
        [B, F/4, 640], bnd [B, F/(4*TR), 8, 640], then its matrices."""
        return phase_inputs(device, B, F, TR, k1_only)

    def main() -> int:
        return run(script, modes, inputs, same)
    return inputs, main


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def call(inp: Inputs, spec, kernel=None):
    """A no-argument call of one mode: the kernel (default) or ``kernel``,
    e.g. the plain twin."""
    dft, mel, tail = spec
    fn = kernel or anatomy.anatomy_features
    return lambda: fn(inp.main, inp.bnd, inp.consts, dft, mel, tail)


def run(script: str, modes: dict, inputs, same: dict) -> int:
    """A runner's ``main``: every mode of ``script`` on the card, timed.
    ``same`` maps a mode to the mode whose function it computes (the TPU
    script's variants that differ only in summation order)."""
    if not torch.cuda.is_available():
        print(f"{script}: needs a CUDA card (torch.cuda.is_available() is "
              f"False)", file=sys.stderr)
        return 1
    name = card()
    inp = inputs("cuda")
    print(f"{script}: main {tuple(inp.main.shape)} bnd "
          f"{tuple(inp.bnd.shape)} [{name}]")
    for mode, (dft, mel, tail) in modes.items():
        ms = event_ms(call(inp, (dft, mel, tail)), REPS)
        note = f" (the function of {same[mode]})" if mode in same else ""
        print(f"{mode:10s}: {ms:8.3f} ms  {dft} DFT, {mel or 'no'} mel, "
              f"{tail}{note} [{name}]", flush=True)
    return 0


# ---------------------------------------------------------------------------
# Tolerances (see the module docstring)
# ---------------------------------------------------------------------------

def magnitude(out: torch.Tensor, tail: str) -> torch.Tensor:
    """|m| from an output: sqrt(10**out) for sqlog (m*m + 1e-10), 10**out
    for log (negative m floored to 1e-10), |out| for nolog."""
    out = out.double()
    if tail == "sqlog":
        return (10.0 ** out).sqrt()
    if tail == "log":
        return 10.0 ** out
    return out.abs()


def lossy(mel: str | None, tail: str) -> bool:
    """Whether a mode's mel product drops the lo part of z*z, so that it
    is held within :func:`flip_tolerance` on |m|."""
    return tail != "dftonly" and mel in ("bf16x1", "bf16x2")


def flip_tolerance(inp: Inputs, dft: str, want: torch.Tensor,
                   tail: str) -> float:
    """The one-flip bound of one call, 2^-7 max(z*z) max|FB| / max|m|."""
    zmax = max(z.abs().max().item() for z in anatomy.spectra_reference(
        inp.main, inp.bnd, inp.consts, dft))
    fb = inp.consts.fb_f32 if inp.consts.fb_f32 is not None \
        else inp.consts.fb_hi
    mmax = magnitude(want, tail).max().item()
    return 2.0 ** -7 * zmax ** 2 * fb.float().abs().max().item() / mmax


def compare(got: torch.Tensor, want: torch.Tensor, tail: str,
            m: torch.Tensor | None = None, lossy_tol: float | None = None,
            what: str = "") -> tuple[float, float, int]:
    """(max abs error, the error checked, entries masked) of ``got``
    against ``want`` under the tolerances above; raises AssertionError
    past them. ``m``: the reference pre-log mel, for a log tail's mask.
    ``lossy_tol``: compare |m| (recovered from the output) within it."""
    got, want = got.detach().double(), want.detach().double()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: not finite")
    if lossy_tol is not None:
        got, want, tol = magnitude(got, tail), magnitude(want, tail), \
            lossy_tol
    elif tail in ("nolog", "dftonly"):
        tol = TOL_PRE
    else:
        m = m.detach().to(got.device).double().abs()
        keep = m >= MASK_FRACTION * m.max()
        err = (got - want).abs()[keep].max().item()
        if err > TOL_LOG:
            raise AssertionError(f"{what} {tail}: abs error {err:.3e} > "
                                 f"{TOL_LOG} on unmasked entries")
        return err, err, int((~keep).sum())
    err = (got - want).abs().max().item()
    scaled = err / max(1.0, want.abs().max().item())
    if scaled > tol:
        raise AssertionError(f"{what} {tail}: scaled error {scaled:.3e} > "
                             f"{tol:.3e}")
    return err, scaled, 0
