"""The phase-kernel anatomy family (K5a-h): the Hopper kernel's wrapper and
its plain twin.

Replaces the eight stand-alone TPU kernels of ``benchmarks/experiments/``
(``nopad_kernel``, ``repack_kernel``, ``phase_kernel``, ``phase_anatomy``
and ``phase_anatomy2-5``) with ONE CUDA kernel,
``tpufeat_torch/csrc/anatomy.cu``. The eight compute one function and
differ only in operand layout and in how the products are split into bf16:

- ``main`` f32 [B, R, W] holds rows of W samples (W = 160: one hop per row;
  W = 640: four hops, four frame phases), cut into ``nblk`` blocks of
  TR = R / nblk rows; ``bnd`` f32 [B, nblk, 8, W] holds each block's 8
  successor rows (the TPU scripts draw them independently of ``main``).
  ``ext`` is a block's TR rows followed by its 8 ``bnd`` rows.
- Phase p of block-row r is output frame ``r*H + p`` of its block:
  ``z = sum over p's terms (s, a, K) of ext[r + s, a : a + K] @ D_term``
  (the term table), then the tail: ``sqlog`` log10(max(m*m + 1e-10,
  1e-10)), ``log`` log10(max(m, 1e-10)), ``nolog`` m, with
  m = (z*z) @ FB, or ``dftonly`` z[:, :NM].
- Each product runs at a precision: ``bf16x1`` (hi*chi), ``bf16x2``
  (+ hi*clo), ``bf16x3`` (+ lo*chi) or ``f32``. The splits are made as
  the TPU kernels make them: hi = bf16_rn(x), lo = bf16_rn(x - hi), for
  the signal and for z*z before the mel product; the matrices arrive
  split. Products of bf16 operands are exact in f32, so the kernel and
  the twin differ only in the order of their f32 sums.

The twin (:func:`anatomy_features_reference`) runs these as f32 matrix
products of the bf16-rounded operands, TF32 off.
:func:`constants_from_numpy` carries a script's matrices (f32, or its
bf16 hi/lo pairs) over into the kernel's packed term table.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch.kernels import _build, signal

PRECISIONS = {"f32": 0, "bf16x1": 1, "bf16x2": 2, "bf16x3": 3}
TAILS = {"sqlog": 0, "log": 1, "nolog": 2, "dftonly": 3}
BND_ROWS = 8            # successor rows per block (``bnd``'s third axis)
MAX_PHASES, MAX_TERMS = 4, 4     # the kernel's term table: csrc/anatomy.cu
COLS = 128              # NM, and the kernel's column tile: NC % COLS == 0
DEPTH = 16              # every term's K is a multiple of the bf16 MMA depth
#: kernel launches so far (a plain count; the twin never adds to it)
launches = 0


class Constants(NamedTuple):
    """The term table and the packed matrices, on one device.

    ``table[p]`` lists phase p's terms as (row shift s, lane offset a,
    depth K, first row of the term's matrix in the packed ``d_*``). Each
    matrix kind is None where the source did not carry it: a script that
    holds only bf16 hi/lo pairs has no f32 matrices."""
    table: tuple
    d_hi: torch.Tensor | None      # [sum K, NC] bf16
    d_lo: torch.Tensor | None
    d_f32: torch.Tensor | None     # [sum K, NC] f32
    fb_hi: torch.Tensor | None     # [NC, NM] bf16
    fb_lo: torch.Tensor | None
    fb_f32: torch.Tensor | None    # [NC, NM] f32


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 with hi = bf16_rn(x), lo = bf16_rn(x - hi): the TPU
    scripts' ``astype(bfloat16)`` split, round to nearest even."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def _tensor(a) -> torch.Tensor:
    """A numpy (or torch) matrix as a CPU tensor; numpy bfloat16 arrays
    (as JAX hands them out) are taken by their bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _kinds(m) -> tuple:
    """(hi, lo, f32) CPU tensors of one matrix given as an f32 array (split
    here) or as a script's (hi, lo) or (hi, lo, f32) tuple."""
    if isinstance(m, (tuple, list)):
        parts = [_tensor(a) for a in m]
        if len(parts) not in (2, 3) or any(
                p.dtype != torch.bfloat16 for p in parts[:2]):
            raise ValueError("a split matrix is (hi, lo) or (hi, lo, f32) "
                             "with bf16 hi and lo")
        return parts[0], parts[1], parts[2].float() if len(parts) == 3 \
            else None
    f32 = _tensor(m).float()
    return (*split_bf16(f32), f32)


def _pack(mats: list, device) -> tuple:
    kinds = [_kinds(m) for m in mats]
    out = []
    for i in range(3):
        parts = [k[i] for k in kinds]
        out.append(None if any(p is None for p in parts)
                   else torch.cat(parts).contiguous().to(device))
    return tuple(out)


def constants_from_numpy(terms, fb, device) -> Constants:
    """The kernel's constants from a script's matrices.

    ``terms[p]`` lists phase p's terms as (row shift s, lane offset a,
    matrix), each matrix [K, NC] an f32 array (split into bf16 hi/lo here)
    or the script's own (hi, lo) or (hi, lo, f32) arrays; ``fb`` [NC, NM]
    likewise. The matrices are packed phase by phase, term by term."""
    table, mats, row = [], [], 0
    for phase in terms:
        entries = []
        for s, a, m in phase:
            k = _kinds(m)[0].shape[0]
            entries.append((int(s), int(a), k, row))
            mats.append(m)
            row += k
        table.append(tuple(entries))
    return Constants(tuple(table), *_pack(mats, device), *_pack([fb], device))


def _geometry(main, bnd, consts: Constants, dft: str, mel: str, tail: str):
    """Check the call; return (B, R, W, nblk, TR, NC, NM)."""
    for name, t, dims in (("main", main, 3), ("bnd", bnd, 4)):
        if not isinstance(t, torch.Tensor) or t.dim() != dims:
            raise ValueError(f"{name} must be a {dims}-d tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if main.device != bnd.device:
        raise ValueError(f"main on {main.device}, bnd on {bnd.device}")
    if main.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no anatomy kernel for device {main.device}")
    B, R, W = main.shape
    if bnd.shape[0] != B or bnd.shape[2] != BND_ROWS or bnd.shape[3] != W \
            or bnd.shape[1] < 1 or R % bnd.shape[1] or B < 1 or R < 1:
        raise ValueError(f"bnd {tuple(bnd.shape)} does not fit main "
                         f"{tuple(main.shape)}: need [B, nblk, 8, W] with "
                         f"nblk dividing R")
    nblk = bnd.shape[1]
    if dft not in PRECISIONS or (tail != "dftonly" and mel not in PRECISIONS):
        raise ValueError(f"precisions are {sorted(PRECISIONS)}, got "
                         f"{dft!r} and {mel!r}")
    if tail not in TAILS:
        raise ValueError(f"tails are {sorted(TAILS)}, got {tail!r}")
    if not 1 <= len(consts.table) <= MAX_PHASES or any(
            not 1 <= len(p) <= MAX_TERMS for p in consts.table):
        raise ValueError(f"the term table takes 1-{MAX_PHASES} phases of "
                         f"1-{MAX_TERMS} terms")
    used = [(dft, ("d_f32",) if dft == "f32" else ("d_hi", "d_lo"))]
    if tail != "dftonly":
        used.append((mel, ("fb_f32",) if mel == "f32" else ("fb_hi", "fb_lo")))
    for prec, fields in used:
        for f in fields:
            t = getattr(consts, f)
            if t is None:
                raise ValueError(f"{prec} needs the {f} matrices, which the "
                                 f"constants do not carry")
            if t.device != main.device:
                raise ValueError(f"constants on {t.device}, main on "
                                 f"{main.device}")
    d = consts.d_f32 if consts.d_f32 is not None else consts.d_hi
    fb = consts.fb_f32 if consts.fb_f32 is not None else consts.fb_hi
    NC, NM = d.shape[1], fb.shape[1]
    if fb.shape[0] != NC or NM != COLS or NC % COLS:
        raise ValueError(f"need DFT matrices [K, NC] and FB [NC, {COLS}] "
                         f"with NC a multiple of {COLS}, got NC={NC}, FB "
                         f"{tuple(fb.shape)}")
    if W % 4:
        raise ValueError(f"rows of W={W} samples: the kernel's 16-byte loads "
                         f"need W a multiple of 4")
    for phase in consts.table:
        for s, a, k, _ in phase:
            if not 0 <= s <= BND_ROWS or a < 0 or a % 4 or a + k > W \
                    or k % DEPTH or k < DEPTH:
                raise ValueError(f"term (s={s}, a={a}, K={k}) does not fit "
                                 f"W={W}: need 0 <= s <= {BND_ROWS}, a a "
                                 f"multiple of 4, a + K <= W, K a multiple "
                                 f"of {DEPTH}")
    return B, R, W, nblk, R // nblk, NC, NM


def _dot(x: torch.Tensor, m: tuple, prec: str) -> torch.Tensor:
    """x @ M at ``prec``; ``m`` is M's (hi, lo, f32) as f32 tensors."""
    if prec == "f32":
        return x @ m[2]
    xhi, xlo = (t.to(torch.float32) for t in split_bf16(x))
    out = xhi @ m[0]
    if prec != "bf16x1":
        out = out + xhi @ m[1]
    if prec == "bf16x3":
        out = out + xlo @ m[0]
    return out


def _as_f32(*ts):
    return tuple(None if t is None else t.to(torch.float32) for t in ts)


def apply_tail(m: torch.Tensor, tail: str) -> torch.Tensor:
    """The tail of a mel ``m`` (``dftonly`` and ``nolog`` keep it)."""
    if tail == "sqlog":
        return torch.log10(torch.clamp(m * m + 1e-10, min=1e-10))
    if tail == "log":
        return torch.log10(torch.clamp(m, min=1e-10))
    return m


def spectra_reference(main: torch.Tensor, bnd: torch.Tensor,
                      consts: Constants, dft: str = "bf16x3"):
    """The twin's first half: each phase's z [B, nblk, TR, NC], in turn:
    the terms' products of the rolled ``ext`` rows."""
    B, R, W, nblk, TR, _, _ = _geometry(main, bnd, consts, dft, None,
                                        "dftonly")
    ext = torch.cat([main.reshape(B, nblk, TR, W), bnd], dim=2)
    d = _as_f32(consts.d_hi, consts.d_lo, consts.d_f32)
    for phase in consts.table:
        z = None
        with signal.no_tf32():
            for s, a, k, row in phase:
                dm = tuple(None if t is None else t[row: row + k] for t in d)
                zk = _dot(ext[:, :, s: s + TR, a: a + k], dm, dft)
                z = zk if z is None else z + zk
        yield z


def anatomy_features_reference(main: torch.Tensor, bnd: torch.Tensor,
                               consts: Constants, dft: str = "bf16x3",
                               mel: str = "bf16x3",
                               tail: str = "sqlog") -> torch.Tensor:
    """Plain torch twin of :func:`anatomy_features`: per phase z
    (:func:`spectra_reference`), then the tail, the phases interleaved
    into frame order. [B, R * H, NM] float32."""
    B, R, _, _, _, _, NM = _geometry(main, bnd, consts, dft, mel, tail)
    fb = _as_f32(consts.fb_hi, consts.fb_lo, consts.fb_f32)
    outs = []
    for z in spectra_reference(main, bnd, consts, dft):
        if tail == "dftonly":
            outs.append(z[..., :NM])
        else:
            with signal.no_tf32():
                outs.append(apply_tail(_dot(z * z, fb, mel), tail))
    return torch.stack(outs, dim=3).reshape(B, R * len(outs), NM)


def work(main: torch.Tensor, bnd: torch.Tensor, consts: Constants,
         dft: str = "bf16x3", mel: str = "bf16x3", tail: str = "sqlog"
         ) -> tuple[dict, int]:
    """The least work of one call, from the shapes: ({"bf16": FLOP, "f32":
    FLOP} of the products at their precisions, one bf16 pass counting as
    2*M*N*K), and the bytes that must move: the signal and ``bnd`` read
    once, the matrices the call uses read once, the output written once.
    ``dftonly`` needs only z's first NM columns."""
    B, R, _, _, _, NC, NM = _geometry(main, bnd, consts, dft, mel, tail)
    flops = {"bf16": 0, "f32": 0}
    cols = NM if tail == "dftonly" else NC
    depth = sum(k for phase in consts.table for _, _, k, _ in phase)

    def add(prec, macs):
        kind = "f32" if prec == "f32" else "bf16"
        flops[kind] += 2 * macs * (1 if prec == "f32" else int(prec[-1]))

    add(dft, B * R * depth * cols)
    if tail != "dftonly":
        add(mel, B * R * len(consts.table) * NC * NM)
    used = [consts.d_f32] if dft == "f32" else [consts.d_hi, consts.d_lo]
    if tail != "dftonly":
        used += [consts.fb_f32] if mel == "f32" else [consts.fb_hi,
                                                      consts.fb_lo]
    moved = (main.numel() + bnd.numel() + B * R * len(consts.table) * NM) * 4
    moved += sum(t.numel() * t.element_size() for t in used)
    return flops, moved


@functools.lru_cache(maxsize=None)
def lib(csrc: str) -> ctypes.CDLL:
    """The kernel library (shared with the signal kernels), with this
    entry point's argument types declared."""
    so = signal.lib(csrc)
    i, p = ctypes.c_int, ctypes.c_void_p
    so.tpufeat_anatomy_features.argtypes = [
        i, p, p, i, i, i, i, i, p, p, p, p, p, i, p, p, p, i, i, i, i, p, p]
    so.tpufeat_anatomy_features.restype = i
    so.tpufeat_anatomy_resources.argtypes = [
        i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    so.tpufeat_anatomy_resources.restype = i
    return so


def resources(dft: str, mel: str) -> tuple[int, int]:
    """(dynamic shared memory per block in bytes, blocks per SM) of the
    kernel's launch at these precisions on the current CUDA device."""
    so = lib(str(_build.CSRC))
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    signal.raise_on(so, so.tpufeat_anatomy_resources(
        int(dft == "f32"), int(mel == "f32"), ctypes.byref(smem),
        ctypes.byref(blocks)), "occupancy query")
    return smem.value, blocks.value


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def anatomy_features(main: torch.Tensor, bnd: torch.Tensor,
                     consts: Constants, dft: str = "bf16x3",
                     mel: str = "bf16x3", tail: str = "sqlog"
                     ) -> torch.Tensor:
    """The anatomy function (see the module docstring): [B, R * H, NM]
    float32, frame r*H + p of each block from phase p of block-row r.

    A CUDA tensor launches the Hopper kernel on the current stream (the
    library builds at the first such call) and raises if the launch
    fails; a CPU tensor runs the plain twin. Nothing falls back."""
    global launches
    B, R, W, nblk, _, NC, NM = _geometry(main, bnd, consts, dft, mel, tail)
    if main.device.type == "cpu":
        return anatomy_features_reference(main, bnd, consts, dft, mel, tail)
    ptrs = [t for t in (main, bnd, *consts[1:]) if t is not None]
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("the kernel's 16-byte loads need every tensor to "
                         "start at a 16-byte boundary: pass a fresh copy")
    so = lib(str(_build.CSRC))
    H = len(consts.table)
    flat = [0] * (MAX_PHASES * MAX_TERMS * 4)
    for p, phase in enumerate(consts.table):
        for t, entry in enumerate(phase):
            flat[(p * MAX_TERMS + t) * 4:(p * MAX_TERMS + t + 1) * 4] = entry
    table = (ctypes.c_int * len(flat))(*flat)
    counts = (ctypes.c_int * MAX_PHASES)(*[len(p) for p in consts.table],
                                         *[0] * (MAX_PHASES - H))
    out = torch.empty(B, R * H, NM, device=main.device, dtype=torch.float32)
    mel_mode = PRECISIONS[mel] if tail != "dftonly" else PRECISIONS["f32"]
    err = so.tpufeat_anatomy_features(
        main.device.index, main.data_ptr(), bnd.data_ptr(), B, R, W, nblk,
        H, table, counts, _ptr(consts.d_hi), _ptr(consts.d_lo),
        _ptr(consts.d_f32), NC, _ptr(consts.fb_hi), _ptr(consts.fb_lo),
        _ptr(consts.fb_f32), NM, PRECISIONS[dft], mel_mode, TAILS[tail],
        out.data_ptr(), torch.cuda.current_stream(main.device).cuda_stream)
    signal.raise_on(so, err, "anatomy kernel launch")
    launches += 1
    return out
