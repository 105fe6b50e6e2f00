"""The port's online config-3 pipeline and its parts against
``tpufeat.streaming``, against the port's offline operators, and against
itself across chunk plans and checkpoints.

Mirrors the cases of ``tests/_streaming_pipeline_cases.py`` that apply
(i-vectors are refused until their ROADMAP.md item; the pitch and
resampler cases are ``tests/test_torch_streaming_pipeline_rate_pitch.py``),
``tests/test_sliding_cmvn.py``'s streaming cases and
``tests/test_online_cmvn.py``'s ``TestStreamingTwin``. The reference's
``StreamingPipeline`` runs in a process of its own
(``tests/_jax_pipeline_oracle.py``); its parts run here.

Tolerances, relative to max(1, |want|.max()):
- the pipeline's base columns against the port's ``extract_scan``:
  bitwise, on every plan (the same static step; on the CPU the plain path's
  products round a row alike whatever the step's row count here);
- its delta columns against the port's offline ``deltas`` of those rows:
  <= 1e-6 (the same elementwise arithmetic, in windows of other shapes);
- its rows against the reference's pipeline fed the same chunks, and the
  parts against the reference's parts chunk by chunk: <= 1e-4, the port's
  ``extract``-vs-``tpufeat`` tolerance (the base features differ by f32
  sums in another order, and CMVN moves them no further);
- with sliding CMVN, against the port's offline ``extract`` of the same
  config: <= 1e-5 (f32 summation order of the window sums);
- a resumed pipeline against the uninterrupted one: bitwise.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpufeat import data as jdata
from tpufeat import features as jfeat
from tpufeat import streaming as jstream

import _jax_pipeline_oracle as oracle
import tpufeat_torch
from tpufeat_torch import data, features, streaming
from tpufeat_torch.config import KALDI39, MFCC13_HTK

KALDI39_NOCMVN = dataclasses.replace(KALDI39, cmvn="none")
TOL_JAX = 1e-4


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if got.size == 0:
        return 0.0
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _run(pipe, x, plan, stop=None):
    """Feed ``x`` in the plan's chunks (the first ``stop`` of them, else
    all and then flush); the emitted rows, concatenated."""
    outs, pos = [], 0
    for c in plan[:stop]:
        outs.append(pipe.process(x[:, pos: pos + c]))
        pos += c
    if stop is None:
        assert pos == x.shape[1]
        outs.append(pipe.flush())
    return torch.cat(outs, dim=1)


def _cfg(change):
    return dataclasses.replace(KALDI39, **change)


def _pipeline(change, options, batch=oracle.B):
    kw = {}
    if options.get("online_cmvn"):
        spk = data.CmvnStats(39)
        spk.accumulate(oracle.prior_frames())
        kw["online_cmvn"] = streaming.OnlineCmvn(
            39, batch_size=batch, speaker_stats=spk, device="cpu",
            **oracle.ONLINE_CMVN)
    if options.get("transform"):
        kw["transform"] = oracle.transform()
    return streaming.StreamingPipeline(_cfg(change), batch, device="cpu",
                                       **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference pipeline's rows for every oracle case, computed once
    in a process of its own."""
    out = str(tmp_path_factory.mktemp("oracle") / "rows.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, oracle.__file__, out], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as rows:
        return dict(rows), out + ".state.npz"


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(oracle.CASES))
def test_rows_match_tpufeat_pipeline(case, reference):
    change, plan, options = oracle.CASES[case]
    got = _run(_pipeline(change, options), oracle.signal(),
               oracle.PLANS[plan])
    assert _scaled(got, reference[0][case]) <= TOL_JAX


@pytest.mark.parametrize("plan", sorted(oracle.PLANS))
def test_base_columns_are_extract_scan(plan):
    """Base columns bit for bit, delta columns the offline deltas of those
    rows, over every plan (one of one-frame steps)."""
    x = oracle.signal()
    got = _run(streaming.StreamingPipeline(KALDI39_NOCMVN, oracle.B,
                                           device="cpu"),
               x, oracle.PLANS[plan])
    base_cfg = dataclasses.replace(KALDI39, deltas=False, cmvn="none")
    base = streaming.extract_scan(x, base_cfg, chunk_len=1600, device="cpu")
    torch.testing.assert_close(got[..., :13], base, rtol=0, atol=0)
    nf = torch.full((oracle.B,), base.shape[1])
    d1 = features.deltas(base, nf)
    d2 = features.deltas(d1, nf)
    assert _scaled(got, torch.cat([base, d1, d2], dim=-1)) <= 1e-6


@pytest.mark.parametrize("plan", sorted(oracle.PLANS))
@pytest.mark.parametrize("cmvn", ["sliding", "sliding-meanvar"])
def test_sliding_rows_match_offline_extract(cmvn, plan):
    change = dict(oracle.SLIDING, cmvn=cmvn)
    x = oracle.signal()
    got = _run(_pipeline(change, {}), x, oracle.PLANS[plan])
    want = features.extract(x, cfg=_cfg(change), device="cpu").features
    assert _scaled(got, want) <= 1e-5


@pytest.mark.parametrize("order", [1, 3])
def test_delta_order_matches_offline_extract(order):
    cfg = dataclasses.replace(KALDI39_NOCMVN, delta_order=order)
    x = oracle.signal()
    got = _run(streaming.StreamingPipeline(cfg, oracle.B, device="cpu"), x,
               oracle.PLANS["ragged"])
    want = features.extract(x, cfg=cfg, device="cpu").features
    assert got.shape[-1] == 13 * (1 + order)
    assert _scaled(got, want) <= 1e-5


def test_online_cmvn_rows_match_offline_composition():
    x = oracle.signal()
    got = _run(_pipeline({"cmvn": "none"}, {"online_cmvn": True}), x,
               oracle.PLANS["ragged"])
    base = features.extract(x, cfg=KALDI39_NOCMVN, device="cpu").features
    spk = data.CmvnStats(39)
    spk.accumulate(oracle.prior_frames())
    want = features.online_cmvn(base, speaker_stats=spk,
                                **oracle.ONLINE_CMVN)
    assert _scaled(got, want) <= 1e-5


def test_transform_matches_offline_apply():
    x = oracle.signal()
    pipe = _pipeline({"cmvn": "none"}, {"transform": True})
    assert pipe.out_dim == 20
    got = _run(pipe, x, oracle.PLANS["ragged"])
    base = features.extract(x, cfg=KALDI39_NOCMVN, device="cpu").features
    w = torch.from_numpy(oracle.transform())
    assert _scaled(got, base @ w[:, :39].T + w[:, 39]) <= 1e-5


@pytest.mark.parametrize("case", ["kaldi39/ragged", "sliding/one_frame",
                                  "online_cmvn/ragged", "order3/ragged"])
def test_resume_from_saved_state(case, tmp_path):
    """state() -> save_state -> load_state -> set_state, then the rest of
    the plan: the same rows as the uninterrupted run."""
    change, plan, options = oracle.CASES[case]
    plan = oracle.PLANS[plan]
    x = oracle.signal()
    want = _run(_pipeline(change, options), x, plan)
    first = _pipeline(change, options)
    head = _run(first, x, plan, stop=3)
    path = str(tmp_path / "pipe.npz")
    streaming.save_state(path, first.state())
    second = _pipeline(change, options)
    second.set_state(streaming.load_state(path, second.state()))
    pos = sum(plan[:3])
    tail = _run(second, x[:, pos:], plan[3:])
    torch.testing.assert_close(torch.cat([head, tail], dim=1), want,
                               rtol=0, atol=0)


def test_resume_from_a_state_tpufeat_saved(reference):
    """The reference's pipeline state, saved mid-stream, loads into the
    port's pipeline, which finishes the stream as the reference did."""
    rows, state = reference
    change, plan, _ = oracle.CASES[oracle.RESUME_CASE]
    plan = oracle.PLANS[plan]
    pos = int(rows["resume/at"])
    pipe = _pipeline(change, {})
    pipe.set_state(streaming.load_state(state, pipe.state()))
    tail = _run(pipe, oracle.signal()[:, pos:], plan[oracle.RESUME_AT:])
    want = rows[oracle.RESUME_CASE]
    assert _scaled(tail, want[:, want.shape[1] - tail.shape[1]:]) <= TOL_JAX


def test_row_count_and_lookahead():
    """Each process() lags by 2 * delta_window rows once flowing; flush()
    drains exactly those."""
    x = oracle.signal()[:1]
    pipe = streaming.StreamingPipeline(KALDI39_NOCMVN, device="cpu")
    emitted = sum(pipe.process(x[:, p: p + 3200]).shape[1]
                  for p in range(0, 9600, 3200))
    total = MFCC13_HTK.num_frames(9600)
    assert emitted == total - 4
    tail = pipe.flush()
    assert tail.shape == (1, 4, 39)


def test_stream_shorter_than_the_lookahead():
    x = oracle.signal()[:1, :400 + 2 * 160]            # 3 frames
    pipe = streaming.StreamingPipeline(KALDI39_NOCMVN, device="cpu")
    got = torch.cat([pipe.process(x), pipe.flush()], dim=1)
    want = features.extract(x, cfg=KALDI39_NOCMVN, device="cpu").features
    assert _scaled(got, want) <= 1e-5


def test_short_sliding_stream_flush_is_transformed():
    """A stream shorter than cmvn_min_window emits every row at flush, and
    those rows are transformed too."""
    change = dict(oracle.SLIDING, cmvn_window=120, cmvn_min_window=100)
    x = oracle.signal()
    pipe = _pipeline(change, {"transform": True})
    got = _run(pipe, x, oracle.PLANS["ragged"])
    assert got.shape == (oracle.B, 58, 20)
    base = features.extract(x, cfg=_cfg(change), device="cpu").features
    w = torch.from_numpy(oracle.transform())
    assert _scaled(got, base @ w[:, :39].T + w[:, 39]) <= 1e-5


def test_zero_row_chunk_keeps_the_width():
    pipe = _pipeline({"cmvn": "none"}, {"transform": True}, batch=1)
    assert pipe.process(np.zeros((1, 100), np.float32)).shape == (1, 0, 20)


def test_reset_restores_a_fresh_pipeline():
    x = oracle.signal()
    pipe = _pipeline({"cmvn": "none"}, {"transform": True,
                                         "online_cmvn": True})
    first = _run(pipe, x, oracle.PLANS["steady"])
    pipe.reset()
    assert pipe.out_dim == 20
    torch.testing.assert_close(_run(pipe, x, oracle.PLANS["steady"]), first,
                               rtol=0, atol=0)


@pytest.mark.parametrize("change,options,warmup", [
    ({}, {}, 8), (oracle.SLIDING, {}, 8 + 30),
    ({"cmvn": "none"}, {"online_cmvn": True}, 8 + 120)],
    ids=["running", "sliding", "online"])
def test_reset_rows_keeps_the_other_rows(change, options, warmup):
    """Recycling row 0 leaves row 1's bits; row 0 restarts as a stream that
    carried silence, and its rows past ``warmup_rows`` are finite."""
    x = oracle.signal()
    plan = oracle.PLANS["steady"]
    want = _run(_pipeline(change, options), x, plan)
    pipe = _pipeline(change, options)
    assert pipe.warmup_rows == warmup
    head = _run(pipe, x, plan, stop=2)
    pipe.reset_rows([0])
    tail = _run(pipe, x[:, 3200:], plan[2:])
    got = torch.cat([head, tail], dim=1)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert bool(torch.isfinite(got).all())
    assert not torch.equal(got[0], want[0])


def test_same_input_rate_is_the_pipeline():
    x = oracle.signal()
    a = streaming.StreamingPipeline(KALDI39_NOCMVN, oracle.B,
                                    input_rate=16000, device="cpu")
    b = streaming.StreamingPipeline(KALDI39_NOCMVN, oracle.B, device="cpu")
    torch.testing.assert_close(_run(a, x, oracle.PLANS["steady"]),
                               _run(b, x, oracle.PLANS["steady"]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("option", [dict(ivector=object())],
                         ids=["ivector"])
def test_unported_options_raise(option):
    """ivector= is ported (tests/test_torch_streaming_pipeline_ivector.py):
    what it refuses now is an object that is no IvectorExtractor."""
    with pytest.raises(TypeError, match="IvectorExtractor"):
        streaming.StreamingPipeline(KALDI39, device="cpu", **option)


@pytest.mark.parametrize("make,match", [
    (lambda: streaming.StreamingPipeline(MFCC13_HTK, device="cpu"),
     "deltas"),
    (lambda: streaming.StreamingPipeline(
        KALDI39, online_cmvn=streaming.OnlineCmvn(39, device="cpu"),
        device="cpu"), "cmvn"),
    (lambda: streaming.StreamingPipeline(
        KALDI39_NOCMVN, online_cmvn=streaming.OnlineCmvn(13, device="cpu"),
        device="cpu"), "dim"),
    (lambda: streaming.StreamingPipeline(
        KALDI39_NOCMVN, transform=np.zeros((20, 7)), device="cpu"),
     "transform"),
    (lambda: streaming.StreamingPipeline(
        _cfg(dict(oracle.SLIDING, cmvn_center=True)), device="cpu"),
     "causal"),
    (lambda: streaming.StreamingPipeline(KALDI39_NOCMVN, device="cpu")
     .set_state(streaming.StreamingPipeline(
         dataclasses.replace(KALDI39_NOCMVN, delta_order=3),
         device="cpu").state()), "delta_order mismatch"),
], ids=["no_deltas", "cfg_cmvn", "cmvn_dim", "transform_shape",
        "centred_sliding", "state_order"])
def test_rejects(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tpufeat_torch.StreamingPipeline(KALDI39)


# ---------------------------------------------------------------------------
# the parts, chunk by chunk against the reference's
# ---------------------------------------------------------------------------

def _rows(B, T, D=13, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, D)) * 3
            + rng.standard_normal(D) * 5).astype(np.float32)


ROW_PLANS = {"uniform": [10] * 8, "ragged": [1, 7, 45, 2, 25],
             "one_row": [1] * 40}


@pytest.mark.parametrize("plan", sorted(ROW_PLANS))
@pytest.mark.parametrize("window", [1, 2])
def test_streaming_deltas_match_tpufeat(window, plan):
    sizes = ROW_PLANS[plan]
    f = _rows(2, sum(sizes), seed=window)
    ours = streaming.StreamingDeltas(13, window, 2, device="cpu")
    theirs = jstream.StreamingDeltas(13, window, 2)
    pos, outs = 0, []
    for c in sizes:
        got = ours.process(torch.from_numpy(f[:, pos: pos + c]))
        assert _scaled(got, theirs.process(f[:, pos: pos + c])) <= 1e-6
        outs.append(got)
        pos += c
    assert _scaled(ours.flush(), theirs.flush()) <= 1e-6
    outs.append(ours.flush())
    nf = torch.full((2,), f.shape[1])
    assert _scaled(torch.cat(outs, dim=1),
                   features.deltas(torch.from_numpy(f), nf, window)) <= 1e-6


@pytest.mark.parametrize("norm_vars", [False, True])
def test_streaming_cmvn_matches_tpufeat(norm_vars):
    f = _rows(2, 45, seed=3)
    mask = np.ones((2, 45), bool)
    mask[1, 30:] = False
    ours = streaming.init_cmvn(2, 13, device="cpu")
    theirs = jstream.init_cmvn(2, 13)
    for lo, hi in ((0, 5), (5, 6), (6, 45)):
        ours, got = streaming.streaming_cmvn(
            ours, torch.from_numpy(f[:, lo:hi]),
            torch.from_numpy(mask[:, lo:hi]), norm_vars)
        theirs, want = jstream.streaming_cmvn(theirs, f[:, lo:hi],
                                              mask[:, lo:hi], norm_vars)
        m = mask[:, lo:hi]
        assert _scaled(got.numpy()[m], np.asarray(want)[m]) <= 1e-5
    for a, b in zip(ours, theirs):
        assert _scaled(a, b) <= 1e-5


@pytest.mark.parametrize("plan", sorted(ROW_PLANS))
@pytest.mark.parametrize("norm_vars", [False, True])
def test_streaming_sliding_cmvn_matches_tpufeat(norm_vars, plan):
    sizes = ROW_PLANS[plan]
    f = _rows(1, sum(sizes), seed=4)
    kw = dict(window=24, min_window=9, norm_vars=norm_vars)
    ours = streaming.StreamingSlidingCMVN(13, 1, device="cpu", **kw)
    theirs = jstream.StreamingSlidingCMVN(13, 1, **kw)
    pos, outs = 0, []
    for c in sizes:
        got = ours.process(torch.from_numpy(f[:, pos: pos + c]))
        assert _scaled(got, theirs.process(f[:, pos: pos + c])) <= 1e-5
        outs.append(got)
        pos += c
    outs.append(ours.flush())
    want = features.sliding_cmvn(torch.from_numpy(f), None, center=False,
                                 **kw)
    assert _scaled(torch.cat(outs, dim=1), want) <= 1e-5


def test_short_sliding_stream_drains_at_flush():
    f = _rows(1, 25, seed=5)
    ours = streaming.StreamingSlidingCMVN(13, 1, 150, 40, device="cpu")
    theirs = jstream.StreamingSlidingCMVN(13, 1, 150, 40)
    assert ours.process(torch.from_numpy(f[:, :10])).shape[1] == 0
    assert ours.process(torch.from_numpy(f[:, 10:])).shape[1] == 0
    theirs.process(f[:, :10])
    theirs.process(f[:, 10:])
    assert _scaled(ours.flush(), theirs.flush()) <= 1e-5


def _jprior(seed, count):
    st = jdata.CmvnStats(13)
    st.accumulate(_rows(1, count, seed=seed)[0])
    return st


def _tprior(seed, count):
    st = data.CmvnStats(13)
    st.accumulate(_rows(1, count, seed=seed)[0])
    return st


@pytest.mark.parametrize("plan", sorted(ROW_PLANS))
@pytest.mark.parametrize("norm_vars", [False, True])
def test_online_cmvn_stream_matches_tpufeat(norm_vars, plan):
    sizes = ROW_PLANS[plan]
    f = _rows(2, sum(sizes), seed=6)
    kw = dict(window=30, speaker_frames=20, global_frames=15,
              norm_vars=norm_vars)
    ours = streaming.OnlineCmvn(13, 2, speaker_stats=_tprior(7, 40),
                                global_stats=_tprior(8, 300), device="cpu",
                                **kw)
    theirs = jstream.OnlineCmvn(13, 2, speaker_stats=_jprior(7, 40),
                                global_stats=_jprior(8, 300), **kw)
    pos, outs = 0, []
    for c in sizes:
        got = ours.process(torch.from_numpy(f[:, pos: pos + c]))
        assert _scaled(got, theirs.process(f[:, pos: pos + c])) <= 1e-5
        outs.append(got)
        pos += c
    want = features.online_cmvn(torch.from_numpy(f),
                                speaker_stats=_tprior(7, 40),
                                global_stats=_tprior(8, 300), **kw)
    assert _scaled(torch.cat(outs, dim=1), want) <= 1e-5


def test_online_cmvn_freeze_and_reset_rows_match_tpufeat():
    f = _rows(2, 60, seed=9)
    kw = dict(window=25, norm_vars=True)
    ours = streaming.OnlineCmvn(13, 2, speaker_stats=_tprior(10, 50),
                                device="cpu", **kw)
    theirs = jstream.OnlineCmvn(13, 2, speaker_stats=_jprior(10, 50), **kw)
    for lo, hi in ((0, 20), (20, 35)):
        ours.process(torch.from_numpy(f[:, lo:hi]))
        theirs.process(f[:, lo:hi])
    ours.reset_rows([1])
    theirs.reset_rows([1])
    got = ours.process(torch.from_numpy(f[:, 35:45]))
    assert _scaled(got, theirs.process(f[:, 35:45])) <= 1e-5
    ours.freeze()
    theirs.freeze()
    got = ours.process(torch.from_numpy(f[:, 45:]))
    assert _scaled(got, theirs.process(f[:, 45:])) <= 1e-5
    with pytest.raises(ValueError, match="prior"):
        streaming.OnlineCmvn(13, device="cpu").freeze()


@pytest.mark.parametrize("kind", ["sliding", "online"])
def test_part_state_roundtrip(kind, tmp_path):
    f = _rows(1, 80, seed=11)

    def make():
        if kind == "sliding":
            return streaming.StreamingSlidingCMVN(13, 1, 30, 10,
                                                  device="cpu")
        return streaming.OnlineCmvn(13, 1, 30, device="cpu")
    a = make()
    a.process(torch.from_numpy(f[:, :45]))
    path = str(tmp_path / "part.npz")
    streaming.save_state(path, a.state())
    b = make()
    b.set_state(streaming.load_state(path, b.state()))
    torch.testing.assert_close(b.process(torch.from_numpy(f[:, 45:])),
                               a.process(torch.from_numpy(f[:, 45:])),
                               rtol=0, atol=0)
