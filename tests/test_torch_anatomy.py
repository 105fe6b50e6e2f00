"""The anatomy family's plain twin (``tpufeat_torch.kernels.anatomy``)
against the eight TPU scripts of ``benchmarks/experiments/`` run in Pallas
interpret mode on the CPU, and the port's default device.

Each script is loaded by parsing it and running its imports, assignments
and defs up to its timing section (``def cks``), with its sizes cut down
(B=2; TF/TR=8; F to match) and ``pallas_call`` set to ``interpret=True``.
The twin then runs on the script's own ``main``, ``bnd`` and matrices.

Tolerances (``tpufeat_torch.experiments._common``): pre-log outputs
within 1e-5 scaled by max(1, |ref|.max()); log outputs within 1e-3 abs
where the float64 |m| is at least 1e-2 of the call's max. The TPU's HIGH
precision is ported as bf16x3, while interpret mode computes it in f32;
those modes are held within 1e-4 on |m| recovered from the log, scaled by
its max, and the mel products of one or two bf16 passes within a one-flip
bound (see that module).
"""

import ast
import functools
import importlib
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from tpufeat_torch import features, streaming
from tpufeat_torch.config import MFCC13_HTK
from tpufeat_torch.experiments import RUNNERS, _common
from tpufeat_torch.kernels import anatomy

import _anatomy_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP160 = ("nopad_kernel", "repack_kernel")
SMALL = {name: dict(B=2, F=16, TF=8) if name in HOP160
         else dict(B=2, F=64, TR=8) for name in RUNNERS}
HIGH = {("phase_anatomy4", "allhigh"), ("phase_anatomy4", "melhigh")}


def _runner(name):
    return importlib.import_module(f"tpufeat_torch.experiments.{name}")


def _touches_sys_path(node):
    """Whether a statement reads or changes ``sys.path``."""
    return any(isinstance(n, ast.Attribute) and n.attr == "path"
               and isinstance(n.value, ast.Name) and n.value.id == "sys"
               for n in ast.walk(node))


@functools.lru_cache(maxsize=None)
def _script(name):
    """The script's namespace at the small sizes, Pallas in interpret mode.
    The script's own ``sys.path`` lines are skipped (jax, numpy and pallas
    are imported already), and ``sys.path`` is left as it was."""
    path = os.path.join(REPO, "benchmarks", "experiments", name + ".py")
    with open(path) as f:
        tree = ast.parse(f.read())
    sizes = SMALL[name]
    ns = {"__name__": f"anatomy_script_{name}"}
    real = pallas.pallas_call
    saved = list(sys.path)
    pallas.pallas_call = functools.partial(real, interpret=True)
    try:
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name == "cks":
                break
            if _touches_sys_path(node):
                continue
            exec(compile(ast.Module([node], []), path, "exec"), ns)
            for k, v in sizes.items():      # the cut sizes, after each line
                if k in ns:
                    ns[k] = v
    finally:
        pallas.pallas_call = real
        sys.path[:] = saved
    return ns


def _interpret(fn):
    real = pallas.pallas_call
    pallas.pallas_call = functools.partial(real, interpret=True)
    try:
        return fn()
    finally:
        pallas.pallas_call = real


def _script_out(name, mode, bnd=None):
    """The script's kernel output for ``mode`` (on ``bnd`` if given)."""
    ns = _script(name)
    bnd = ns["bnd"] if bnd is None else bnd
    if "make" not in ns:
        return np.asarray(ns["fn"](ns["main"], bnd, *ns["args"][2:]))
    made = _interpret(lambda: ns["make"](mode))
    call, flat = made if isinstance(made, tuple) else (made, ns["flat"])
    return np.asarray(_interpret(lambda: jax.jit(call)(ns["main"], bnd,
                                                       *flat)))


def _script_matrices(name):
    """(terms, fb) of the script's own matrices, for constants_from_numpy."""
    ns = _script(name)
    if name in HOP160:
        return _runner(name).terms(ns["d0"], ns["d1"], ns["d2"]), ns["fb"]
    if name == "phase_anatomy5":
        pairs = [(tuple(m[0][2:]), tuple(m[1][2:]) if len(m) > 1 else None)
                 for m in ns["DMATS"]]
        return _common.phase_terms(pairs), (ns["FBH"], ns["FBL"])
    c = ns["consts"]
    return (_common.phase_terms([(c[2 * p], c[2 * p + 1])
                                 for p in range(4)]), c[8])


def _port_inputs(name):
    ns = _script(name)
    main = torch.from_numpy(np.array(ns["main"]))
    bnd = torch.from_numpy(np.array(ns["bnd"]))
    return _common.Inputs(main, bnd, anatomy.constants_from_numpy(
        *_script_matrices(name), "cpu"))


def _mask_prec(prec):
    """The precision of the float64 mask's products: six passes are f32
    within about 1e-6, so their mask is the f32 matrices'."""
    return "f32" if prec == "bf16x6" else prec


CASES = [(name, mode) for name in RUNNERS for mode in _runner(name).MODES]


@pytest.mark.parametrize("name,mode", CASES,
                         ids=[f"{n}-{m}" for n, m in CASES])
def test_twin_matches_the_tpu_script(name, mode):
    dft, mel, tail = _runner(name).MODES[mode]
    inp = _port_inputs(name)
    main, bnd, consts = inp
    got = anatomy.anatomy_features(main, bnd, consts, dft, mel, tail)
    want = torch.from_numpy(_script_out(name, mode))
    tol = None
    if (name, mode) in HIGH:
        tol = _common.TOL_HIGH
    elif _common.lossy(mel, tail):
        tol = _common.flip_tolerance(inp, dft, want, tail)
    m64 = None if tol or tail in ("nolog", "dftonly") else \
        cases.pre_log_f64(main, bnd, consts, *map(_mask_prec, (dft, mel)))
    _, err, masked = _common.compare(got, want, tail, m64, tol,
                                     f"{name} {mode}")
    print(f"{name} {mode}: error {err:.3e}, {masked} entries masked")


@pytest.mark.parametrize("name", ["phase_anatomy", "nopad_kernel"])
def test_bnd_reaches_only_each_blocks_last_rows(name):
    """bnd feeds the rows whose shifted terms run past the block: the last
    row's phases 2 and 3 in the phase layout (shift 1), the last two rows
    in the hop-160 layout (shifts 1 and 2)."""
    mode = next(iter(_runner(name).MODES))
    dft, mel, tail = _runner(name).MODES[mode]
    main, bnd, consts = _port_inputs(name)
    moved = bnd + 1.0
    port = [anatomy.anatomy_features(main, b, consts, dft, mel, tail).numpy()
            for b in (bnd, moved)]
    jax_ = [_script_out(name, mode, b) for b in (bnd.numpy(), moved.numpy())]
    B, R, _ = main.shape
    nblk = bnd.shape[1]
    TR = R // nblk
    want = np.zeros((B, nblk, TR, port[0].shape[1] // R), bool)
    if name in HOP160:
        want[:, :, TR - 2:] = True
    else:
        want[:, :, TR - 1, 2:] = True
    for a, b in (port, jax_):
        changed = (a != b).any(axis=2).reshape(want.shape)
        np.testing.assert_array_equal(changed, want)


@pytest.mark.parametrize("name", RUNNERS)
def test_runner_inputs_equal_the_scripts_arrays(name):
    """The runner draws the script's arrays in the script's order, and its
    bf16 split of them is the script's, bit for bit."""
    inp = _runner(name).inputs("cpu", **SMALL[name])
    main, bnd, consts = _port_inputs(name)
    assert torch.equal(inp.main, main) and torch.equal(inp.bnd, bnd)
    assert inp.consts.table == consts.table
    for field in anatomy.Constants._fields[1:]:
        mine, theirs = getattr(inp.consts, field), getattr(consts, field)
        if theirs is not None:      # the scripts carry f32 only in K5g
            if field.endswith("_blocks"):   # the script's pieces only
                mine = mine[:, :theirs.shape[1]]
            assert torch.equal(mine.view(torch.int16) if mine.dtype ==
                               torch.bfloat16 else mine,
                               theirs.view(torch.int16) if theirs.dtype ==
                               torch.bfloat16 else theirs), field
    assert inp.consts.d_f32 is not None and inp.consts.fb_f32 is not None
    assert inp.consts.d_lo2 is not None and inp.consts.fb_lo2 is not None
    assert inp.consts.d_blocks.shape[1] == inp.consts.fb_blocks.shape[1] == 3


@pytest.mark.parametrize("name", ["nopad_kernel", "phase_anatomy5"])
def test_loading_a_script_leaves_sys_path_alone(name):
    """Each script puts an absolute path at the front of ``sys.path``; the
    loader skips that line and restores ``sys.path``, so modules imported
    later in the process come from this checkout."""
    before = list(sys.path)
    ns = _script.__wrapped__(name)
    assert sys.path == before
    assert "main" in ns and "bnd" in ns


def test_every_runner_maps_every_mode_of_its_script():
    for name in RUNNERS:
        src = open(os.path.join(REPO, "benchmarks", "experiments",
                                name + ".py")).read()
        for mode, (dft, mel, tail) in _runner(name).MODES.items():
            assert name in HOP160 or name == "phase_kernel" \
                or f'"{mode}"' in src, (name, mode)
            assert dft in anatomy.PRECISIONS and tail in anatomy.TAILS
            assert tail == "dftonly" or mel in anatomy.PRECISIONS
        for alias, target in _runner(name).SAME.items():
            assert alias in _runner(name).MODES
            assert target.split()[-1] in {m for n in RUNNERS
                                          for m in _runner(n).MODES}


def test_runner_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _runner("phase_anatomy").main() == 1


def test_wrapper_raises_on_bad_input():
    main, bnd, consts = _port_inputs("phase_anatomy")
    f = anatomy.anatomy_features
    with pytest.raises(TypeError, match="float32"):
        f(main.double(), bnd, consts)
    with pytest.raises(ValueError, match="does not fit"):
        f(main, bnd[:, :, :7].contiguous(), consts)
    with pytest.raises(ValueError, match="contiguous"):
        f(main.transpose(0, 1), bnd, consts)
    with pytest.raises(ValueError, match="no anatomy kernel"):
        f(main.to("meta"), bnd.to("meta"), consts)
    with pytest.raises(ValueError, match="tails"):
        f(main, bnd, consts, tail="log2")
    bf16_only = _port_inputs("phase_anatomy5")[2]
    with pytest.raises(ValueError, match="d_lo2"):
        f(main, bnd, bf16_only, "bf16x6", "bf16x6")
    with pytest.raises(ValueError, match="fb_lo2"):
        f(main, bnd, bf16_only, "bf16x3", "bf16x6")
    with pytest.raises(ValueError, match="precisions"):
        f(main, bnd, bf16_only, "f32", "f32")
    assert anatomy.launches == 0      # the twin never counts a launch


def test_split_rounds_to_nearest_even():
    x = torch.tensor([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -3.14159265])
    hi, lo = anatomy.split_bf16(x)
    assert hi.tolist() == [1.0, 1.0 + 2 ** -6, -3.140625]
    assert bool(((hi.float() + lo.float() - x).abs()
                 <= x.abs() * 2 ** -16).all())


# ---------------------------------------------------------------------------
# The card is the default device
# ---------------------------------------------------------------------------

def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "extract": lambda x: features.extract(x, cfg=MFCC13_HTK),
    "frames": lambda x: features.frames(x),
    "spectrogram": lambda x: features.spectrogram(x),
    "mel_spectrogram": lambda x: features.mel_spectrogram(x),
    "logmel": lambda x: features.logmel(x),
    "mfcc": lambda x: features.mfcc(x),
    "init_state": lambda x: streaming.init_state(2),
    "extract_scan": lambda x: streaming.extract_scan(x, chunk_len=1600),
    "StreamingFrontend": lambda x: streaming.StreamingFrontend(),
    "state_from_numpy": lambda x: streaming.state_from_numpy(
        (np.zeros((1, 399), np.float32), np.zeros(1, np.int32),
         np.zeros(1, np.float32))),
    "runner_inputs": lambda x: _runner("phase_anatomy").inputs(
        B=1, F=32, TR=8),
}


def _signal():
    return (np.random.default_rng(3).standard_normal(4800) * 0.1
            ).astype(np.float32)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(monkeypatch, entry):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[entry](_signal())


@pytest.mark.parametrize("entry", ["extract", "logmel", "extract_scan",
                                   "init_state", "StreamingFrontend",
                                   "state_from_numpy"])
def test_cpu_computes_when_asked(monkeypatch, entry):
    _no_card(monkeypatch)
    x = _signal()
    out = {
        "extract": lambda: features.extract(x, device="cpu").features,
        "logmel": lambda: features.logmel(x, device="cpu")[0],
        "extract_scan": lambda: streaming.extract_scan(x, chunk_len=1600,
                                                       device="cpu"),
        "init_state": lambda: streaming.init_state(2, device="cpu").buf,
        "StreamingFrontend": lambda: streaming.StreamingFrontend(
            device="cpu").process(x)[0],
        "state_from_numpy": lambda: streaming.state_from_numpy(
            streaming.init_state(1, device="cpu"), device="cpu").buf,
    }[entry]()
    assert out.device.type == "cpu" and bool(torch.isfinite(out).all())


def test_default_is_the_card_when_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert features.default_device() == torch.device("cuda")
    assert features.default_device("cpu") == torch.device("cpu")


def test_tensor_input_needs_no_device(monkeypatch):
    _no_card(monkeypatch)
    x = torch.from_numpy(_signal())
    assert features.extract(x).features.device == x.device
    assert streaming.extract_scan(x, chunk_len=1600).device == x.device
