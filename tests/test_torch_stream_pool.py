"""The port's ``StreamPool`` and ``PoolRows`` against
``tpufeat.streaming.StreamPool``, and the recycle contracts on their own.

The cases of ``tests/test_stream_pool.py``: lease, recycle, trim,
errors, the pool over a bare front-end, ``process_batch`` against the
dict path, the tick's mapping and block, the recycled slot against the
zeros-prefix oracle, and the pool over a pipeline with i-vectors
(``TestPoolWithIvector``). The reference's pool runs in a process of its
own (``tests/_jax_pool_oracle.py``) through one script of attaches,
detaches and ticks over ``StreamingPipeline(KALDI39)`` without CMVN, with
sliding CMVN, with i-vectors (an extractor the reference trains, carried
across) and over ``StreamingFrontend(MFCC13_HTK)``.

Tolerances, relative to max(1, |want|.max()):
- the port's tick rows against the reference's on the same ticks: the same
  slots, the same trims, values <= 1e-4 (the pipeline tolerance of
  ``tests/test_torch_streaming_pipeline.py``);
- a recycled slot after ``warmup_rows`` against a pipeline of the same
  batch fed zeros before the attach, and the other slots against a
  pipeline that never recycled: bitwise (the zeroing is a per-row
  ``where``, and every step computes each row alone).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _jax_pool_oracle as oracle
from tpufeat_torch import streaming
from tpufeat_torch.config import KALDI39, MFCC13_HTK, speaker_from_reference

KALDI39_NOCMVN = dataclasses.replace(KALDI39, cmvn="none")
SLIDING = dataclasses.replace(KALDI39, **oracle.SLIDING)
TOL_JAX = 1e-4


def _sig(b, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)) * 0.1).astype(np.float32)


def _pipe(cfg, b):
    return streaming.StreamingPipeline(cfg, batch_size=b, device="cpu")


def _extractor(reference):
    """The reference's extractor, carried across."""
    return speaker_from_reference(
        {k[len("model/"):]: v for k, v in reference.items()
         if k.startswith("model/")})


def _wrapper(name, reference):
    kind, change = oracle.WRAPPERS[name]
    if kind == "frontend":
        return streaming.StreamingFrontend(MFCC13_HTK, oracle.CAP,
                                           device="cpu")
    return streaming.StreamingPipeline(
        dataclasses.replace(KALDI39, **change), batch_size=oracle.CAP,
        ivector=_extractor(reference) if kind == "ivector" else None,
        device="cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference pool's attaches and tick rows for every wrapper,
    computed once in a process of its own."""
    out = str(tmp_path_factory.mktemp("pool") / "pool.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, oracle.__file__, out], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as rows:
        return dict(rows)


@pytest.mark.parametrize("name", sorted(oracle.WRAPPERS))
def test_ticks_match_tpufeat_pool(name, reference):
    """The same slots and rows as the reference's pool, tick by tick. One
    departure: a slot leased while the sliding CMVN still holds back its
    first min_window frames (ticks 3 and 9 with window 600) drops those
    rows too, so there the port returns the tail of the reference's rows
    (the rows it leaves out are not yet exact in the reference)."""
    got = oracle.drive(streaming.StreamPool(_wrapper(name, reference)),
                       oracle.signal())
    want = {k[len(name) + 1:]: v for k, v in reference.items()
            if k.startswith(name + "/")}
    assert sorted(got) == sorted(want)
    shorter = 0
    last = f"tick/{oracle.TICKS - 1}/"
    for key, rows in got.items():
        if key.startswith("attach/"):
            np.testing.assert_array_equal(rows, want[key])
            continue
        ref = want[key]
        if rows.shape != ref.shape:
            assert name == "sliding600" and not key.startswith(last), key
            assert rows.shape[0] < ref.shape[0], key
            ref = ref[ref.shape[0] - rows.shape[0]:]
            shorter += 1
        if rows.size:
            scale = max(1.0, np.abs(ref).max())
            assert np.abs(rows - ref).max() / scale <= TOL_JAX, key
    assert bool(shorter) == (name == "sliding600")


def test_lease_recycle_and_trim():
    b = 3
    pipe = _pipe(KALDI39_NOCMVN, b)
    pool = streaming.StreamPool(pipe)
    assert pool.capacity == 3 and pool.free_slots == 3
    s0, s1 = pool.attach(), pool.attach()
    assert sorted([s0, s1]) == pool.active
    x = _sig(b, 9600, 50)
    out1 = pool.process({s0: x[s0, :4800], s1: x[s1, :4800]})
    out2 = pool.process({s0: x[s0, 4800:], s1: x[s1, 4800:]})
    # the first warmup_rows are dropped once, then every row comes
    n1 = MFCC13_HTK.num_frames(4800) - 4     # the pipeline's delta lag
    assert out1[s0].shape[0] == max(0, n1 - pipe.warmup_rows)
    assert out2[s0].shape[0] == out2[s1].shape[0]
    pool.detach(s1)
    assert pool.free_slots == 2
    s2 = pool.attach()
    assert s2 == s1                          # last in, first out
    out3 = pool.process({s0: x[s0, :4800], s2: x[s2, :4800]})
    assert out3[s2].shape[0] == max(0, out3[s0].shape[0] - pipe.warmup_rows)


def test_pool_errors():
    pool = streaming.StreamPool(_pipe(KALDI39_NOCMVN, 1))
    slot = pool.attach()
    with pytest.raises(RuntimeError, match="full"):
        pool.attach()
    with pytest.raises(KeyError, match="not attached"):
        pool.process({slot + 1: np.zeros(1600, np.float32)})
    with pytest.raises(KeyError, match="not attached"):
        pool.detach(slot + 1)
    with pytest.raises(ValueError, match="at least one"):
        pool.process({})
    with pytest.raises(ValueError, match="one chunk clock"):
        pool2 = streaming.StreamPool(_pipe(KALDI39_NOCMVN, 2))
        a, b = pool2.attach(), pool2.attach()
        pool2.process({a: np.zeros(1600), b: np.zeros(800)})
    with pytest.raises(ValueError, match="capacity"):
        pool.process_batch(np.zeros((2, 1600), np.float32))
    pool.detach(slot)


def test_pool_over_frontend():
    """No deltas: warmup 0, every row returned."""
    pool = streaming.StreamPool(streaming.StreamingFrontend(
        MFCC13_HTK, batch_size=2, device="cpu"))
    assert pool.warmup == 0
    s = pool.attach()
    out = pool.process({s: _sig(2, 4800, 51)[s]})
    assert out[s].shape == (MFCC13_HTK.num_frames(4800),
                            MFCC13_HTK.feature_dim)


def test_process_batch_matches_dict_path():
    """The caller-assembled block gives the dict path's bits, over every
    attached slot."""
    b = 3
    pool = streaming.StreamPool(_pipe(KALDI39_NOCMVN, b))
    pool_b = streaming.StreamPool(_pipe(KALDI39_NOCMVN, b))
    s0, s1 = pool.attach(), pool.attach()
    assert (pool_b.attach(), pool_b.attach()) == (s0, s1)
    x = _sig(b, 9600, 55)
    x[2] = 0.0                                # slot 2 unleased
    for lo, hi in ((0, 4800), (4800, 9600)):
        want = pool.process({s0: x[s0, lo:hi], s1: x[s1, lo:hi]})
        got = pool_b.process_batch(torch.from_numpy(x[:, lo:hi]))
        assert sorted(got) == sorted(want)
        for s in want:
            torch.testing.assert_close(got[s], want[s], rtol=0, atol=0)


def test_poolrows_mapping_and_block():
    """The tick is a mapping over one batched tensor: rows[slot] is a view
    of it, block() the tensor and the tick's own trims (a later tick does
    not change them)."""
    b = 3
    pipe = _pipe(KALDI39_NOCMVN, b)
    pool = streaming.StreamPool(pipe)
    s0, s1 = pool.attach(), pool.attach()
    x = _sig(b, 9600, 56)
    rows1 = pool.process({s0: x[s0, :4800], s1: x[s1, :4800]})
    assert isinstance(rows1, streaming.PoolRows)
    assert sorted(rows1) == sorted([s0, s1]) and len(rows1) == 2
    assert s0 in rows1 and 99 not in rows1
    out, skips = rows1.block()
    assert out.shape[0] == b and sorted(skips) == sorted([s0, s1])
    assert rows1[s0].data_ptr() == out[s0, skips[s0]:].data_ptr()
    rows2 = pool.process({s0: x[s0, 4800:], s1: x[s1, 4800:]})
    for s in rows1:
        torch.testing.assert_close(rows1[s], out[s, skips[s]:], rtol=0,
                                   atol=0)
    assert skips[s0] == pipe.warmup_rows
    o2, sk2 = rows2.block()
    assert sk2[s0] == 0                       # the warmup went in tick 1
    torch.testing.assert_close(rows2[s0], o2[s0], rtol=0, atol=0)


@pytest.mark.parametrize("cfg,at", [(KALDI39_NOCMVN, 2), (SLIDING, 2),
                                    (SLIDING, 1)],
                         ids=["nocmvn", "sliding", "sliding_startup"])
def test_recycled_slot_matches_zeros_prefix_oracle(cfg, at):
    """A slot detached and leased again gives, after warmup_rows, the rows
    of a stream that carried zeros up to the attach and the new caller's
    audio after it; the slot that stayed attached keeps every bit.

    With sliding CMVN a step normalizes its rows with sums over its whole
    ring, so the rows past warmup_rows that share a step with rows before
    it (the tick that crosses the boundary) are exact only to f32 rounding
    (<= 1e-6 scaled); every later tick is bitwise. A slot recycled while
    the sliding CMVN still holds back its first min_window rows (tick 1
    here) also drops those rows, which predate the attach."""
    b, c, ticks = 2, 1600, 14
    x = _sig(b, ticks * c, 52)
    xz = x.copy()                     # the oracle's input: zeros before
    xz[1, :at * c] = 0.0              # slot 1's attach
    pool = streaming.StreamPool(_pipe(cfg, b))
    oracle_pipe = _pipe(cfg, b)
    assert (pool.attach(), pool.attach()) == (0, 1)
    crossed = 0
    for k in range(ticks):
        if k == at:
            pool.detach(1)
            assert pool.attach() == 1
        rows = pool.process_batch(x[:, k * c:(k + 1) * c])
        want = oracle_pipe.process(xz[:, k * c:(k + 1) * c])
        for s in rows:
            n = rows[s].shape[0]
            if s == 1 and k < at or n == 0:
                continue
            if n < want.shape[1] and s == 1 and cfg.cmvn != "none":
                crossed += 1
                scale = max(1.0, want[s].abs().max().item())
                err = (rows[s] - want[s, -n:]).abs().max().item()
                assert err / scale <= 1e-6
            else:
                torch.testing.assert_close(rows[s], want[s, -n:], rtol=0,
                                           atol=0)
    assert crossed == (cfg.cmvn != "none")


def test_saved_state_loads_into_pooled_pipeline(tmp_path):
    """A pipeline state saved by save_state loads into a pipeline behind a
    pool, which then ticks on bit for bit."""
    b, c = 2, 1600
    x = _sig(b, 6 * c, 57)
    src = _pipe(SLIDING, b)
    for k in range(3):
        src.process(x[:, k * c:(k + 1) * c])
    path = str(tmp_path / "pipe.npz")
    streaming.save_state(path, src.state())
    pipe = _pipe(SLIDING, b)
    pool = streaming.StreamPool(pipe, warmup=0)
    slots = [pool.attach(), pool.attach()]   # fresh rows, then the state
    pipe.set_state(streaming.load_state(path, pipe.state()))
    for k in range(3, 6):
        block = x[:, k * c:(k + 1) * c]
        rows = pool.process({s: block[s] for s in slots})
        want = src.process(block)
        for s in slots:
            torch.testing.assert_close(rows[s], want[s], rtol=0, atol=0)


def test_pipeline_resets_wait_for_the_next_step():
    """A pipeline's reset_rows is made at its next process, flush or
    state, for all rows reset since in one pass; set_state drops it."""
    pipe = _pipe(SLIDING, 3)
    x = _sig(3, 4800, 58)
    pipe.process(x[:, :3200])
    ring = pipe._scmvn.carry.clone()
    pipe.reset_rows([0])
    pipe.reset_rows([2])
    assert torch.equal(pipe._scmvn.carry, ring)     # not made yet
    s = pipe.state()
    assert not s["frontend"].buf[[0, 2]].any()
    assert s["frontend"].buf[1].any()
    assert not pipe._scmvn.carry[[0, 2]].any()
    assert torch.equal(pipe._scmvn.carry[1], ring[1])
    saved = pipe.state()
    pipe.reset_rows([1])
    pipe.set_state(saved)                           # drops the reset
    assert pipe.state()["frontend"].buf[1].any()


class TestPoolWithIvector:
    """``tests/test_stream_pool.py::TestPoolWithIvector``: the pool over a
    pipeline with i-vectors leases and recycles like any other, and a
    recycled slot's i-vector columns restart at the prior. The spectral
    columns follow the zeros-prefix oracle; the i-vector stage restarts
    its adaptation instead (a zeros-prefix stream has adapted to silence),
    so the oracle's stage is reset after its zero tick. 1e-5: the oracle
    has one row, the pool three (the CPU's BLAS may round another row
    count otherwise)."""

    def test_pool_over_ivector_pipeline(self, reference):
        ext = _extractor(reference)
        b, K = 3, ext.ivector_dim
        pipe = streaming.StreamingPipeline(KALDI39_NOCMVN, batch_size=b,
                                           ivector=ext, device="cpu")
        assert pipe.warmup_rows == _pipe(KALDI39_NOCMVN, b).warmup_rows
        pool = streaming.StreamPool(pipe)
        s0 = pool.attach()
        x = _sig(b, 9600, 71)
        out, _ = pool.process({s0: x[s0, :4800]}).block()
        assert out.shape == (b, out.shape[1], 39 + K)
        pool.detach(s0)
        s1 = pool.attach()
        assert s1 == s0
        rows2 = pool.process({s1: x[s1, :4800]})
        fresh = streaming.StreamingPipeline(KALDI39_NOCMVN, batch_size=1,
                                            ivector=ext, device="cpu")
        fresh.process(np.zeros((1, 4800), np.float32))
        fresh._ivector.reset()
        fresh._iv_fifo = fresh._iv_fifo * 0.0
        want = fresh.process(x[None, s1, :4800])[0]
        got = rows2[s1]
        skip = pipe.warmup_rows
        torch.testing.assert_close(got, want[skip:][: got.shape[0]],
                                   rtol=0, atol=1e-5)
