"""The host side of the Hopper anatomy kernel (``csrc/anatomy.cu``) on the
CPU: the packed matrix blocks it reads by bulk copy, an emulation of its
slices and passes over those blocks against the plain twin, and the six
bf16 passes (``bf16x6``, the TPU's HIGHEST).

The emulation follows the kernel's order: per phase, per 64-column chunk
of z, per term and 64-deep slice (the last one 16, 32 or 48 deep where K
is not a multiple of 64: nopad's K = 160, repack's K = 80), per 16-deep
step, the first pass of PASS_ORDER into z's sum and the others into a
second one, added to z at the chunk's end; then z*z split into pieces
against FB's 64-deep slice of the chunk, 64 mel columns at a time,
likewise into two sums. It reads the
matrices only from the packed blocks, unswizzled here by the byte rule of
wgmma's 128-byte swizzle (address bits 4-6 XOR bits 7-9), so a fault in
the packing shows as a disagreement with the twin. Tolerances are
``tpufeat_torch.experiments._common``'s: the emulation and the twin
differ only in the order of their f32 sums.
"""

import importlib

import numpy as np
import pytest
import torch

from tpufeat_torch.experiments import _common
from tpufeat_torch.kernels import anatomy, signal

import _anatomy_cases as cases

GEOMETRIES = {          # runner, small sizes
    "hop160": ("nopad_kernel", dict(B=2, F=16, TF=8)),
    "repack": ("repack_kernel", dict(B=2, F=16, TF=8)),
    "phase4": ("phase_anatomy", dict(B=2, F=32, TR=8)),
}
PRECISIONS = ("bf16x1", "bf16x2", "bf16x3", "bf16x6")


def _inputs(geometry):
    runner, sizes = GEOMETRIES[geometry]
    return importlib.import_module(
        f"tpufeat_torch.experiments.{runner}").inputs("cpu", **sizes)


def _unswizzle(blocks):
    """[b, pieces, n * 64] packed bf16 -> [b, pieces, n, 64] f32 by the
    byte rule: element (r, k) at byte r*128 + 2k, bits 4-6 XORed with bits
    7-9."""
    n = blocks.shape[-1] // 64
    r = torch.arange(n)[:, None]
    k = torch.arange(64)[None, :]
    byte = r * 128 + 2 * k
    at = (byte ^ (((byte >> 7) & 7) << 4)) // 2
    return blocks[..., at.reshape(-1)].reshape(
        *blocks.shape[:2], n, 64).float()


def _emulate(main, bnd, consts, dft, mel, tail):
    """The kernel's sums in its own order, on the packed blocks."""
    B, R, W = main.shape
    nblk = bnd.shape[1]
    TR = R // nblk
    ext = torch.cat([main.reshape(B, nblk, TR, W), bnd], dim=2)
    d, fb = _unswizzle(consts.d_blocks), _unswizzle(consts.fb_blocks)
    firsts = anatomy.first_blocks(consts)
    NC = consts.d_hi.shape[1]
    chunks = (128 if tail == "dftonly" else NC) // 64
    outs = []
    for p, phase in enumerate(consts.table):
        m = torch.zeros(B, nblk, TR, 128)
        zs = []
        for c in range(chunks):
            z = torch.zeros(B, nblk, TR, 64)
            zc = torch.zeros(B, nblk, TR, 64)
            for t, (s, a, k, _) in enumerate(phase):
                ns = -(-k // 64)
                for j in range(ns):
                    blk = d[firsts[p][t] + j * (NC // 64) + c]  # [P, n, k]
                    for kk in range(min(64, k - 64 * j) // 16):
                        lanes = a + 64 * j + 16 * kk
                        xs = signal.split_pieces(
                            ext[:, :, s: s + TR, lanes: lanes + 16], 3)
                        for q, (qa, qb) in enumerate(signal.PASS_ORDER[
                                :anatomy.PRECISIONS[dft]]):
                            prod = xs[qa].float() @ \
                                blk[qb, :, 16 * kk: 16 * kk + 16].T
                            if q:
                                zc = zc + prod
                            else:
                                z = z + prod
            z = z + zc
            if tail == "dftonly":
                zs.append(z)
                continue
            sq = signal.split_pieces(z * z, 3)
            for h in range(2):      # mel columns 64h.., a sum each
                mh = m[..., 64 * h: 64 * h + 64]
                mc = torch.zeros_like(mh)
                for kk in range(4):
                    cols = 16 * kk
                    for q, (qa, qb) in enumerate(signal.PASS_ORDER[
                            :anatomy.PRECISIONS[mel]]):
                        prod = sq[qa][..., cols: cols + 16].float() @ \
                            fb[c, qb, 64 * h: 64 * h + 64, cols: cols + 16].T
                        if q:
                            mc = mc + prod
                        else:
                            mh = mh + prod
                m[..., 64 * h: 64 * h + 64] = mh + mc
        if tail == "dftonly":
            m = torch.cat(zs, dim=-1)
        outs.append(anatomy.apply_tail(m, tail))
    return torch.stack(outs, dim=3).reshape(B, R * len(outs), 128)


def _hold(got, inp, dft, mel, tail):
    """got against the twin under _common's tolerances."""
    want = anatomy.anatomy_features_reference(*inp, dft, mel, tail)
    if _common.lossy(mel, tail):
        tol = _common.flip_tolerance(inp, dft, want, tail)
        return _common.compare(got, want, tail, lossy_tol=tol)
    m64 = None if tail in ("nolog", "dftonly") else cases.pre_log_f64(
        *inp, *("f32" if p == "bf16x6" else p for p in (dft, mel)))
    return _common.compare(got, want, tail, m64)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_blocks_unpack_to_the_pieces(geometry):
    """Every packed block unswizzles to its 64 columns and 64 rows of the
    stacked pieces (hi, lo, lo2), zeros past the term's depth; FB's to its
    64 rows of FB."""
    consts = _inputs(geometry).consts
    d = _unswizzle(consts.d_blocks)
    pieces = [consts.d_hi, consts.d_lo, consts.d_lo2]
    NC = consts.d_hi.shape[1]
    for phase, firsts in zip(consts.table, anatomy.first_blocks(consts)):
        for (_, _, k, row), first in zip(phase, firsts):
            ns = -(-k // 64)
            for c in range(NC // 64):
                for j in range(ns):
                    blk = d[first + j * (NC // 64) + c]
                    depth = min(64, k - 64 * j)
                    for q, piece in enumerate(pieces):
                        want = piece[row + 64 * j: row + 64 * j + depth,
                                     64 * c: 64 * c + 64].float().T
                        assert torch.equal(blk[q, :, :depth], want)
                        assert not blk[q, :, depth:].any()
    fb = _unswizzle(consts.fb_blocks)
    for q, piece in enumerate([consts.fb_hi, consts.fb_lo, consts.fb_lo2]):
        for c in range(NC // 64):
            assert torch.equal(fb[c, q], piece[64 * c: 64 * c + 64].float().T)


def test_blocks_of_a_split_pair_hold_two_pieces():
    """A script's (hi, lo) matrices give two pieces a block: enough for
    bf16x3, not for bf16x6."""
    rng = np.random.default_rng(2)
    d = rng.standard_normal((80, 256)).astype(np.float32)
    fb = rng.standard_normal((256, 128)).astype(np.float32)
    def pair(m):
        return signal.split_bf16(torch.from_numpy(m))
    consts = anatomy.constants_from_numpy([[(0, 0, pair(d))]], pair(fb),
                                          "cpu")
    full = anatomy.constants_from_numpy([[(0, 0, d)]], fb, "cpu")
    assert consts.d_lo2 is None and consts.d_blocks.shape == (8, 2, 4096)
    assert torch.equal(consts.d_blocks.view(torch.int16),
                       full.d_blocks[:, :2].view(torch.int16))
    assert torch.equal(consts.fb_blocks.view(torch.int16),
                       full.fb_blocks[:, :2].view(torch.int16))
    assert consts.fb_blocks.shape == (4, 2, 8192)


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_emulation_of_the_kernel_matches_the_twin(geometry, prec):
    inp = _inputs(geometry)
    got = _emulate(*inp, prec, prec, "nolog")
    _hold(got, inp, prec, prec, "nolog")


@pytest.mark.parametrize("tail", ["sqlog", "log", "dftonly"])
@pytest.mark.parametrize("prec", ["bf16x3", "bf16x6"])
def test_emulation_of_every_tail_matches_the_twin(prec, tail):
    inp = _inputs("repack")
    got = _emulate(*inp, prec, prec, tail)
    _hold(got, inp, prec, prec, tail)


def test_pieces_of_the_matrices_and_of_the_square():
    """bf16x6's pieces: the constants' (hi, lo, lo2) are split_pieces of
    the f32 matrices and sum back to them exactly; the twin's mel product
    at bf16x6 is signal.mm's six passes of z*z against FB."""
    inp = _inputs("phase4")
    c = inp.consts
    for f32, parts in ((c.d_f32, (c.d_hi, c.d_lo, c.d_lo2)),
                       (c.fb_f32, (c.fb_hi, c.fb_lo, c.fb_lo2))):
        for got, want in zip(parts, signal.split_pieces(f32, 3)):
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert torch.equal(sum(p.float() for p in parts[1:]) + parts[0].float(),
                           f32)
    z = next(anatomy.spectra_reference(*inp, "bf16x6"))
    want = signal.mm(z * z, c.fb_f32, 6)
    got = anatomy.anatomy_features_reference(*inp, "bf16x6", "bf16x6",
                                             "nolog")
    B, R, _ = inp.main.shape
    assert torch.equal(got.reshape(B, -1, 4, 128)[:, :, 0],
                       want.reshape(B, -1, 128))


def test_six_passes_are_within_reach_of_f32():
    """bf16x6 against float64 products of the f32 matrices (z*z rounded
    to f32 once): within the pre-log 1e-5, as f32 products are."""
    inp = _inputs("phase4")
    got = anatomy.anatomy_features_reference(*inp, "bf16x6", "bf16x6",
                                             "nolog")
    want = cases.pre_log_f64(*inp, "f32", "f32")
    _common.compare(got, want, "nolog")


def test_work_counts_six_passes():
    inp = _inputs("phase4")
    flops = {p: anatomy.work(*inp, p, p, "sqlog")[0]["bf16"]
             for p in PRECISIONS}
    assert flops["bf16x6"] == 2 * flops["bf16x3"] == 6 * flops["bf16x1"]
    _, moved3 = anatomy.work(*inp, "bf16x3", "bf16x3")
    _, moved6 = anatomy.work(*inp, "bf16x6", "bf16x6")
    c = inp.consts
    assert moved6 - moved3 == 2 * (c.d_hi.numel() + c.fb_hi.numel())


def test_pieces_per_precision():
    assert {p: anatomy.pieces(p) for p in PRECISIONS} == {
        "bf16x1": (1, 1), "bf16x2": (1, 2), "bf16x3": (2, 2),
        "bf16x6": (3, 3)}
    assert set(anatomy.PRECISIONS) == set(PRECISIONS)
