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
- Each product runs at a precision of P bf16 passes: the first P products
  of :data:`signal.PASS_ORDER` over the operands' pieces hi = bf16_rn(x),
  lo = bf16_rn(x - hi), lo2 = bf16_rn(x - hi - lo), summed in that order:
  ``bf16x1`` (hi.hi), ``bf16x2`` (+ hi.lo), ``bf16x3`` (+ lo.hi) and
  ``bf16x6`` (+ hi.lo2 + lo.lo + lo2.hi), the TPU's Precision.HIGHEST
  (XLA's six-pass f32 emulation). The splits are made as the TPU kernels
  make them, for the signal and for z*z before the mel product; the
  matrices arrive split (``lo2`` needs the f32 matrix). Products of bf16
  operands are exact in f32, so the kernel and the twin differ only in
  the order of their f32 sums.

The twin (:func:`anatomy_features_reference`) runs these as f32 matrix
products of the bf16 pieces, TF32 off. :func:`constants_from_numpy`
carries a script's matrices (f32, or its bf16 hi/lo pairs) over into the
term table, the pieces, and the kernel's packed blocks
(:func:`pack_blocks`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpufeat_torch.kernels import _build, signal
from tpufeat_torch.kernels.signal import split_bf16, split_pieces

#: bf16 passes per product of each precision (the first P of PASS_ORDER)
PRECISIONS = {"bf16x1": 1, "bf16x2": 2, "bf16x3": 3, "bf16x6": 6}
TAILS = {"sqlog": 0, "log": 1, "nolog": 2, "dftonly": 3}
BND_ROWS = 8            # successor rows per block (``bnd``'s third axis)
MAX_PHASES, MAX_TERMS = 4, 4     # the kernel's term table: csrc/anatomy.cu
COLS = 128              # NM, and the kernel's column chunk: NC % COLS == 0
DEPTH = 16              # every term's K is a multiple of the wgmma depth
ZCOLS = 64              # columns of a packed DFT block: NZ
SLICE = 64              # depth of a staged matrix slice (one swizzled row)
PIECE_NAMES = ("hi", "lo", "lo2")
#: kernel launches so far (a plain count; the twin never adds to it)
launches = 0


class Constants(NamedTuple):
    """The term table, the matrices' pieces and their packed blocks, on one
    device.

    ``table[p]`` lists phase p's terms as (row shift s, lane offset a,
    depth K, first row of the term's matrix in the stacked ``d_*``). A
    kind is None where the source did not carry it: a script that holds
    only bf16 hi/lo pairs has no f32 matrices, so no ``lo2`` pieces."""
    table: tuple
    d_hi: torch.Tensor | None      # [sum K, NC] bf16
    d_lo: torch.Tensor | None
    d_lo2: torch.Tensor | None
    d_f32: torch.Tensor | None     # [sum K, NC] f32
    fb_hi: torch.Tensor | None     # [NC, NM] bf16
    fb_lo: torch.Tensor | None
    fb_lo2: torch.Tensor | None
    fb_f32: torch.Tensor | None    # [NC, NM] f32
    d_blocks: torch.Tensor         # [blocks, pieces, 64 * 64] bf16
    fb_blocks: torch.Tensor        # [NC / 64, pieces, 128 * 64] bf16


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
    """(hi, lo, lo2, f32) CPU tensors of one matrix given as an f32 array
    (split here) or as a script's (hi, lo) or (hi, lo, f32) tuple; lo2 =
    bf16_rn(f32 - hi - lo) needs the f32 matrix."""
    if isinstance(m, (tuple, list)):
        parts = [_tensor(a) for a in m]
        if len(parts) not in (2, 3) or any(
                p.dtype != torch.bfloat16 for p in parts[:2]):
            raise ValueError("a split matrix is (hi, lo) or (hi, lo, f32) "
                             "with bf16 hi and lo")
        if len(parts) == 2:
            return parts[0], parts[1], None, None
        f32 = parts[2].float()
        rest = f32 - parts[0].float() - parts[1].float()
        return parts[0], parts[1], rest.to(torch.bfloat16), f32
    f32 = _tensor(m).float()
    return (*split_pieces(f32, 3), f32)


def pack_blocks(pieces: list, transpose: bool) -> torch.Tensor:
    """A matrix's bf16 pieces as the kernel's packed blocks, [blocks,
    pieces, n * 64]: a block holds n output columns and 64 rows of the
    product's depth (zeros past the depth), each piece K-major (a row per
    output column) in wgmma's 128-byte swizzle.

    ``pieces`` are [K, NC] (a DFT matrix), blocks (j, c) of depth 64j..
    and n = 64 columns 64c.., in the order j * NC / 64 + c (a slice's
    column blocks side by side); or, with ``transpose``, FB [NC, 128],
    blocks c of depth 64c.. (z's columns) and all n = 128 mel columns."""
    m = torch.stack(pieces)                      # [P, K, N]
    P, K, N = m.shape
    if transpose:
        b = m.reshape(P, K // SLICE, SLICE, N).permute(1, 0, 3, 2)
        return signal.swizzled(b).contiguous()         # [c, P, n * k]
    ns = -(-K // SLICE)
    m = torch.nn.functional.pad(m, (0, 0, 0, ns * SLICE - K))
    b = m.reshape(P, ns, SLICE, N // ZCOLS, ZCOLS).permute(1, 3, 0, 4, 2)
    return signal.swizzled(b).reshape(ns * N // ZCOLS, P,
                                ZCOLS * SLICE).contiguous()


def _stack(kinds: list, i: int):
    parts = [k[i] for k in kinds]
    return None if any(p is None for p in parts) else torch.cat(parts)


def constants_from_numpy(terms, fb, device) -> Constants:
    """The kernel's constants from a script's matrices.

    ``terms[p]`` lists phase p's terms as (row shift s, lane offset a,
    matrix), each matrix [K, NC] an f32 array (split into bf16 pieces
    here) or the script's own (hi, lo) or (hi, lo, f32) arrays; ``fb``
    [NC, NM] likewise. The matrices are stacked phase by phase, term by
    term, and packed into blocks in that order: a term's first block is
    the sum of ceil(K / 64) * NC / 64 over the terms before it."""
    table, kinds, row = [], [], 0
    for phase in terms:
        entries = []
        for s, a, m in phase:
            k = _kinds(m)
            entries.append((int(s), int(a), k[0].shape[0], row))
            kinds.append(k)
            row += k[0].shape[0]
        table.append(tuple(entries))
    fbk = _kinds(fb)
    d = [_stack(kinds, i) for i in range(4)]
    n = 3 if d[2] is not None else 2
    d_blocks = torch.cat([pack_blocks(list(k[:n]), False) for k in kinds])
    nf = 3 if fbk[2] is not None else 2
    fb_blocks = pack_blocks(list(fbk[:nf]), True)
    put = (lambda t: None if t is None else t.contiguous().to(device))
    return Constants(tuple(table), *map(put, d), *map(put, fbk),
                     put(d_blocks), put(fb_blocks))


def first_blocks(consts: Constants) -> list:
    """Each term's first packed block, phase by phase (the kernel's term
    table)."""
    nc = consts.d_hi.shape[1]
    out, block = [], 0
    for phase in consts.table:
        out.append([])
        for _, _, k, _ in phase:
            out[-1].append(block)
            block += -(-k // SLICE) * (nc // ZCOLS)
    return out


def pieces(prec: str) -> tuple[int, int]:
    """(signal pieces, matrix pieces) a product at ``prec`` reads."""
    order = signal.PASS_ORDER[:PRECISIONS[prec]]
    return (1 + max(a for a, _ in order), 1 + max(b for _, b in order))


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
    used = [("d", dft)] + ([] if tail == "dftonly" else [("fb", mel)])
    for kind, prec in used:
        for f in (f"{kind}_{n}" for n in PIECE_NAMES[:pieces(prec)[1]]):
            t = getattr(consts, f)
            if t is None:
                raise ValueError(f"{prec} needs the {f} matrices (split from "
                                 f"f32 matrices), which the constants do "
                                 f"not carry")
            if t.device != main.device:
                raise ValueError(f"constants on {t.device}, main on "
                                 f"{main.device}")
    d, fb = consts.d_hi, consts.fb_hi
    NC, NM = d.shape[1], fb.shape[1]
    if fb.shape[0] != NC or NM != COLS or NC % COLS:
        raise ValueError(f"need DFT matrices [K, NC] and FB [NC, {COLS}] "
                         f"with NC a multiple of {COLS}, got NC={NC}, FB "
                         f"{tuple(fb.shape)}")
    if W % 4:
        raise ValueError(f"rows of W={W} samples: the kernel's bulk copies "
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
    """x @ M at ``prec``: the first P products of PASS_ORDER over x's
    pieces and ``m``, M's (hi, lo, lo2) as f32 tensors, summed in that
    order (``signal.mm``'s form)."""
    order = signal.PASS_ORDER[:PRECISIONS[prec]]
    xs = [t.to(torch.float32) for t in split_pieces(x, pieces(prec)[0])]
    out = None
    for a, b in order:
        term = xs[a] @ m[b]
        out = term if out is None else out + term
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
    d = _as_f32(consts.d_hi, consts.d_lo, consts.d_lo2)
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
    fb = _as_f32(consts.fb_hi, consts.fb_lo, consts.fb_lo2)
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
    """The least work of one call, from the shapes: ({"bf16": FLOP} of the
    products' passes, one pass counting as 2*M*N*K), and the bytes that
    must move: the signal and ``bnd`` read once, the matrix pieces the
    call uses read once, the output written once. ``dftonly`` needs only
    z's first NM columns."""
    B, R, _, _, _, NC, NM = _geometry(main, bnd, consts, dft, mel, tail)
    cols = NM if tail == "dftonly" else NC
    depth = sum(k for phase in consts.table for _, _, k, _ in phase)
    flops = 2 * B * R * depth * cols * PRECISIONS[dft]
    moved = (main.numel() + bnd.numel() + B * R * len(consts.table) * NM) * 4
    moved += 2 * consts.d_hi.shape[0] * cols * pieces(dft)[1]
    if tail != "dftonly":
        flops += 2 * B * R * len(consts.table) * NC * NM * PRECISIONS[mel]
        moved += 2 * NC * NM * pieces(mel)[1]
    return {"bf16": flops}, moved


@functools.lru_cache(maxsize=None)
def lib(csrc: str) -> ctypes.CDLL:
    """The kernel library (shared with the signal kernels), with this
    entry point's argument types declared."""
    so = signal.lib(csrc)
    i, p = ctypes.c_int, ctypes.c_void_p
    so.tpufeat_anatomy_features.argtypes = [
        i, p, p, i, i, i, i, i, p, p, p, i, p, i, i, i, i, i, i, p, p]
    so.tpufeat_anatomy_features.restype = i
    ip = ctypes.POINTER(i)
    so.tpufeat_anatomy_resources.argtypes = [i, i, ip, ip, ip, ip]
    so.tpufeat_anatomy_resources.restype = i
    return so


def resources(dft: str, mel: str | None) -> tuple[int, int, int, int]:
    """(dynamic shared memory per block in bytes, blocks per SM, registers
    per thread at launch, local memory per thread in bytes: spills) of the
    kernel's launch at these precisions (``mel`` None: dftonly) on the
    current CUDA device."""
    so = lib(str(_build.CSRC))
    vals = [ctypes.c_int() for _ in range(4)]
    signal.raise_on(so, so.tpufeat_anatomy_resources(
        PRECISIONS[dft], PRECISIONS[mel] if mel else 0,
        *map(ctypes.byref, vals)), "occupancy query")
    return tuple(v.value for v in vals)


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
    ptrs = (main, bnd, consts.d_blocks, consts.fb_blocks)
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("the kernel's bulk copies need every tensor to "
                         "start at a 16-byte boundary: pass a fresh copy")
    so = lib(str(_build.CSRC))
    H = len(consts.table)
    flat = [0] * (MAX_PHASES * MAX_TERMS * 4)
    for p, (phase, blocks) in enumerate(zip(consts.table,
                                            first_blocks(consts))):
        for t, ((s, a, k, _), block) in enumerate(zip(phase, blocks)):
            flat[(p * MAX_TERMS + t) * 4:(p * MAX_TERMS + t + 1) * 4] = \
                (s, a, k, block)
    table = (ctypes.c_int * len(flat))(*flat)
    counts = (ctypes.c_int * MAX_PHASES)(*[len(p) for p in consts.table],
                                         *[0] * (MAX_PHASES - H))
    out = torch.empty(B, R * H, NM, device=main.device, dtype=torch.float32)
    err = so.tpufeat_anatomy_features(
        main.device.index, main.data_ptr(), bnd.data_ptr(), B, R, W, nblk,
        H, table, counts, consts.d_blocks.data_ptr(),
        consts.d_blocks.shape[1], consts.fb_blocks.data_ptr(),
        consts.fb_blocks.shape[1], NC, NM, PRECISIONS[dft],
        0 if tail == "dftonly" else PRECISIONS[mel], TAILS[tail],
        out.data_ptr(), torch.cuda.current_stream(main.device).cuda_stream)
    signal.raise_on(so, err, "anatomy kernel launch")
    launches += 1
    return out
