"""The Hopper anatomy kernel (K5a-h) against its plain twin on the card.

Marked ``cuda``: run with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_anatomy.py`` on a machine with an H100 and nvcc
(``--noconftest`` because ``tests/conftest.py`` imports jax; this file
imports no jax). Without a card every test skips inside the ``cuda``
fixture. Tolerances are those of ``tpufeat_torch.experiments._common``
(the float64 mask from ``tests/_anatomy_cases.py``): pre-log
outputs within 1e-5 scaled, log outputs within 1e-3 abs where the
float64 |m| is at least 1e-2 of the call's max, and a mel product of one
or two bf16 passes within the bound of one bf16 flip of z*z; the pass
counts are checked where no rounding of z*z can differ (``dftonly``, and
an identity DFT).
"""

import importlib

import numpy as np
import pytest
import torch

from tpufeat_torch.experiments import RUNNERS, _common
from tpufeat_torch.kernels import anatomy

import _anatomy_cases as cases

pytestmark = pytest.mark.cuda

PRECISIONS = ("bf16x1", "bf16x2", "bf16x3", "bf16x6")
GEOMETRIES = {          # runner, small sizes
    "hop160": ("nopad_kernel", dict(B=2, F=16, TF=8)),
    "repack256": ("repack_kernel", dict(B=2, F=16, TF=8)),
    "phase4": ("phase_anatomy", dict(B=2, F=64, TR=8)),
    "phase4_k1": ("phase_anatomy5", dict(B=3, F=1280, TR=160)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(geometry, device):
    runner, sizes = GEOMETRIES[geometry]
    return importlib.import_module(
        f"tpufeat_torch.experiments.{runner}").inputs(device, **sizes)


def _check(inp, dft, mel, tail):
    before = anatomy.launches
    got = anatomy.anatomy_features(inp.main, inp.bnd, inp.consts, dft, mel,
                                   tail)
    torch.cuda.synchronize()
    assert anatomy.launches == before + 1
    want = anatomy.anatomy_features_reference(inp.main, inp.bnd, inp.consts,
                                              dft, mel, tail)
    if _common.lossy(mel, tail):
        tol = _common.flip_tolerance(inp, dft, want, tail)
        return _common.compare(got, want, tail, lossy_tol=tol)
    m64 = None if tail in ("nolog", "dftonly") else cases.pre_log_f64(
        inp.main, inp.bnd, inp.consts, *map(_mask_prec, (dft, mel)))
    return _common.compare(got, want, tail, m64)


def _mask_prec(prec):
    """The float64 mask's products: six passes are f32 within about 1e-6,
    so their mask is the f32 matrices'."""
    return "f32" if prec == "bf16x6" else prec


@pytest.mark.parametrize("mel", PRECISIONS)
@pytest.mark.parametrize("dft", PRECISIONS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_every_precision_matches_plain(cuda, geometry, dft, mel):
    _check(_inputs(geometry, cuda), dft, mel, "nolog")


@pytest.mark.parametrize("tail", sorted(anatomy.TAILS))
@pytest.mark.parametrize("prec", ["bf16x3", "bf16x6"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_every_tail_matches_plain(cuda, geometry, prec, tail):
    _check(_inputs(geometry, cuda), prec, prec, tail)


@pytest.mark.parametrize("dft", PRECISIONS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_dft_passes_without_the_square(cuda, geometry, dft):
    """z[:, :128] at every DFT precision: no z*z is rounded, so the kernel
    and the twin differ only in f32 sum order, far below the 2^-9-level
    step from one pass count to the next."""
    _check(_inputs(geometry, cuda), dft, None, "dftonly")


@pytest.mark.parametrize("mel", PRECISIONS)
def test_mel_passes_behind_an_identity_dft(cuda, mel):
    """One phase whose DFT is the identity, at bf16x6: z is the signal
    exactly (its hi + lo + lo2 against the identity's hi; the identity's
    lo and lo2 are 0), so z*z and its split are the same bits in the
    kernel and the twin, and the mel product's passes are held to the
    pre-log 1e-5."""
    inp = _inputs("phase4", cuda)
    fb = np.random.default_rng(1).standard_normal((512, 128))
    consts = anatomy.constants_from_numpy(
        [[(0, 0, np.eye(512, dtype=np.float32))]], fb.astype(np.float32),
        cuda)
    got = anatomy.anatomy_features(inp.main, inp.bnd, consts, "bf16x6",
                                   mel, "nolog")
    want = anatomy.anatomy_features_reference(inp.main, inp.bnd, consts,
                                              "bf16x6", mel, "nolog")
    z = anatomy.anatomy_features(inp.main, inp.bnd, consts, "bf16x6",
                                 None, "dftonly")
    torch.cuda.synchronize()
    assert got.shape == (2, 16, 128)
    assert torch.equal(z, inp.main[..., :128].reshape(2, 16, 128))
    _common.compare(got, want, "nolog")


@pytest.mark.parametrize("runner", RUNNERS)
def test_every_mode_at_small_size(cuda, runner):
    mod = importlib.import_module(f"tpufeat_torch.experiments.{runner}")
    sizes = GEOMETRIES["hop160" if runner in ("nopad_kernel",
                                              "repack_kernel")
                       else "phase4"][1]
    inp = mod.inputs(cuda, **sizes)
    for dft, mel, tail in mod.MODES.values():
        _check(inp, dft, mel, tail)


def test_full_script_shape(cuda):
    """phase_anatomy's every mode at the script's own shape (B=128, 3072
    frames, TR=256)."""
    from tpufeat_torch.experiments import phase_anatomy
    inp = phase_anatomy.inputs(cuda)
    for mode, (dft, mel, tail) in phase_anatomy.MODES.items():
        got = anatomy.anatomy_features(inp.main, inp.bnd, inp.consts, dft,
                                       mel, tail)
        want = anatomy.anatomy_features_reference(inp.main, inp.bnd,
                                                  inp.consts, dft, mel, tail)
        torch.cuda.synchronize()
        assert got.shape == (128, 3072, 128)
        if _common.lossy(mel, tail):
            tol = _common.flip_tolerance(inp, dft, want, tail)
            _common.compare(got, want, tail, lossy_tol=tol)
        elif tail in ("nolog", "dftonly"):
            _common.compare(got, want, tail)
        else:   # the float64 mask at this size: the twin's m, on the card
            m = anatomy.anatomy_features_reference(
                inp.main, inp.bnd, inp.consts, dft, mel, "nolog")
            _common.compare(got, want, tail, m)
        del got, want


def test_tile_crosses_the_blocks_last_row(cuda):
    """TR = 160 rows: the kernel's second 128-row tile of each block ends
    inside it (rows 128-159, TR not a multiple of the tile), and its last
    rows read the block's bnd rows. Changing bnd changes exactly the rows that read it, in the
    kernel and in the twin."""
    inp = _inputs("phase4_k1", cuda)
    base = anatomy.anatomy_features(inp.main, inp.bnd, inp.consts)
    bnd = inp.bnd.clone()
    bnd[:, :, 0] += 1.0                 # only row TR of ext (shift 1)
    moved = anatomy.anatomy_features(inp.main, bnd, inp.consts)
    twin = anatomy.anatomy_features_reference(inp.main, bnd, inp.consts)
    torch.cuda.synchronize()
    _common.compare(moved, twin, "sqlog", cases.pre_log_f64(
        inp.main, bnd, inp.consts, "bf16x3", "bf16x3"))
    B, F, _ = base.shape
    changed = (base != moved).any(dim=2).reshape(B, -1, 160, 4)
    # phases 2 and 3 of each block's last row read bnd row 0 (shift 1)
    want = torch.zeros_like(changed)
    want[:, :, 159, 2:] = True
    assert torch.equal(changed, want)


def test_wrapper_raises_on_bad_input(cuda):
    inp = _inputs("phase4", cuda)
    f = anatomy.anatomy_features
    with pytest.raises(TypeError, match="float32"):
        f(inp.main.double(), inp.bnd, inp.consts)
    with pytest.raises(ValueError, match="does not fit"):
        f(inp.main, inp.bnd[:, :, :7].contiguous(), inp.consts)
    with pytest.raises(ValueError, match="contiguous"):
        f(inp.main.transpose(0, 1), inp.bnd, inp.consts)
    with pytest.raises(ValueError, match="constants on"):
        f(inp.main, inp.bnd, _inputs("phase4", "cpu").consts)
    with pytest.raises(ValueError, match="bnd on"):
        f(inp.main, inp.bnd.cpu(), inp.consts)
    with pytest.raises(ValueError, match="precisions"):
        f(inp.main, inp.bnd, inp.consts, "tf32")
    shifted = torch.empty(inp.main.numel() + 1, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        f(shifted.view(inp.main.shape), inp.bnd, inp.consts)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_one_utterance_fewer_items_than_sms(cuda, prec):
    """B = 1 at the script's frame count: 4 phases x 768 rows in tiles of
    128 (24 work items), fewer than the card's SMs, so the persistent
    grid is one CTA an item."""
    from tpufeat_torch.experiments import phase_anatomy
    inp = phase_anatomy.inputs(cuda, B=1, F=3072, TR=256)
    assert inp.main.shape[1] // 128 * 4 < torch.cuda.get_device_properties(
        cuda).multi_processor_count
    _check(inp, prec, prec, "sqlog")


@pytest.mark.parametrize("mode", ["full", "bf16x1", "dftonly"])
def test_two_launches_are_bit_identical(cuda, mode):
    from tpufeat_torch.experiments import phase_anatomy
    inp = phase_anatomy.inputs(cuda, B=8)
    spec = phase_anatomy.MODES[mode]
    first = _common.call(inp, spec)()
    second = _common.call(inp, spec)()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_a_row_does_not_depend_on_its_place(cuda):
    """The same utterance alone and as the last of a batch: its rows land
    on other CTAs and items, and keep their bits."""
    inp = _inputs("phase4_k1", cuda)
    whole = anatomy.anatomy_features(inp.main, inp.bnd, inp.consts)
    last = anatomy.anatomy_features(inp.main[-1:].contiguous(),
                                    inp.bnd[-1:].contiguous(), inp.consts)
    torch.cuda.synchronize()
    assert torch.equal(whole[-1:], last)


@pytest.mark.parametrize("dft,mel", [("bf16x1", "bf16x1"),
                                     ("bf16x3", "bf16x3"),
                                     ("bf16x6", "bf16x6"),
                                     ("bf16x3", None)])
def test_resources(cuda, dft, mel):
    """One CTA of 384 threads fits an SM, with the registers setmaxnreg
    moves (40 for the producer, 232 for each consumer: 168 a thread at
    launch, which the kernel's launch checks), and at most a few words of
    local memory a thread."""
    smem, blocks, regs, local = anatomy.resources(dft, mel)
    assert blocks == 1 and 160_000 < smem <= 232_448
    assert regs >= 168 and local <= 64
