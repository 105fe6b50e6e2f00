"""``StreamingPipeline(ivector=)`` of the port against
``tpufeat.streaming.StreamingPipeline(ivector=)``, against the port's own
offline composition, and on its own contracts, on the CPU.

The reference's pipeline runs in a process of its own
(``tests/_jax_speaker_oracle.py``, about 20 s), which also trains the
extractor (G=4, K=4 on KALDI39 base rows); the port's pipeline uses the
same extractor, carried across by ``config.speaker_from_reference``. The
cases of ``tests/_streaming_pipeline_cases.py::TestIvectorComposition``.

Tolerances, relative to max(1, |want|.max()):
- the port's rows against the reference's: 1e-4 (the pipeline tolerance
  of ``tests/test_torch_streaming_pipeline.py``; the i-vector columns are
  the reference's stream tolerance, 1e-4, too);
- the i-vector columns against ``ivector_features`` of the base rows of
  the port's offline ``extract``: 1e-4;
- the spectral and pitch columns against the same pipeline without
  ``ivector=``, the i-vector columns of a pitch pipeline against those of
  one without pitch, checkpoint and reset: bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _jax_speaker_oracle as oracle
from tpufeat_torch import features, ivector, streaming
from tpufeat_torch.config import KALDI39, speaker_from_reference

NOCMVN = dataclasses.replace(KALDI39, cmvn="none")
BASE = dataclasses.replace(KALDI39, deltas=False, cmvn="none")
TOL = 1e-4


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _run(pipe, x, plan, flush=True):
    outs, pos = [], 0
    for c in plan:
        outs.append(pipe.process(x[:, pos: pos + c]))
        pos += c
    if flush:
        outs.append(pipe.flush())
    return torch.cat(outs, dim=1)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("speaker") / "pipeline.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, oracle.__file__, out], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as rows:
        got = dict(rows)
    got["_out"] = out
    return got


@pytest.fixture(scope="module")
def ext(reference):
    return speaker_from_reference({f: reference[f"model/{f}"]
                                   for f in oracle.MODEL_FIELDS})


def _case(name, ext, **extra):
    sig, change, opts, plan, save_at = oracle.CASES[name]
    x = sig()
    pipe = streaming.StreamingPipeline(
        dataclasses.replace(KALDI39, **change), batch_size=x.shape[0],
        ivector=ext, device="cpu", **dict(opts, **extra))
    return x, pipe, plan, save_at


@pytest.mark.parametrize("name", sorted(oracle.CASES))
def test_rows_match_tpufeat_pipeline(name, reference, ext):
    x, pipe, plan, _ = _case(name, ext)
    got = _run(pipe, x, plan)
    assert _scaled(got, reference[name]) <= TOL
    assert got.shape[-1] == pipe.out_dim


@pytest.mark.parametrize("name", ["sliding_period7"])
def test_resume_from_a_state_tpufeat_saved(name, reference, ext):
    x, pipe, plan, at = _case(name, ext)
    path = oracle.state_path(reference["_out"], name)
    pipe.set_state(streaming.load_state(path, pipe.state()))
    start = sum(plan[:at])
    tail = _run(pipe, x[:, start:], plan[at:])
    _, head, _, _ = _case(name, ext)
    n_head = _run(head, x, plan[:at], flush=False).shape[1]
    assert _scaled(tail, reference[name][:, n_head:]) <= TOL


def test_matches_offline_composition(ext):
    """Kaldi online2's composition: the i-vector columns are
    ``ivector_features`` of the base rows; the spectral columns are the
    pipeline's without ``ivector=``, bit for bit."""
    x = oracle.noise(2, 16000, 91)
    plan = [4800, 1600, 3200, 6400]
    pipe = streaming.StreamingPipeline(NOCMVN, batch_size=2, ivector=ext,
                                       ivector_period=10, device="cpu")
    assert pipe.out_dim == 39 + ext.ivector_dim
    got = _run(pipe, x, plan)
    plain = _run(streaming.StreamingPipeline(NOCMVN, batch_size=2,
                                             device="cpu"), x, plan)
    assert torch.equal(got[..., :39], plain)
    base = features.extract(x, cfg=BASE, device="cpu").features
    want = ivector.ivector_features(ext, base, period=10, device="cpu")
    assert got.shape[1] == base.shape[1]
    assert _scaled(got[..., 39:], want) <= TOL


def test_with_pitch_truncates_ivector_identically(ext):
    x = oracle.voiced(1, 16000, 92)
    pipe = streaming.StreamingPipeline(NOCMVN, batch_size=1, pitch=True,
                                       ivector=ext, device="cpu")
    assert pipe.out_dim == 39 + 3 + ext.ivector_dim
    out = _run(pipe, x, [8000, 8000])
    no_iv = _run(streaming.StreamingPipeline(NOCMVN, batch_size=1,
                                             pitch=True, device="cpu"),
                 x, [8000, 8000])
    assert torch.equal(out[..., :42], no_iv)
    full = _run(streaming.StreamingPipeline(NOCMVN, batch_size=1,
                                            ivector=ext, device="cpu"),
                x, [8000, 8000])
    n = out.shape[1]
    assert n <= full.shape[1]        # the pitch window decides fewer rows
    assert torch.equal(out[..., -ext.ivector_dim:],
                       full[:, :n, -ext.ivector_dim:])


def test_checkpoint_resume(ext, tmp_path):
    x = oracle.noise(1, 16000, 93)

    def mk():
        return streaming.StreamingPipeline(NOCMVN, batch_size=1, pitch=True,
                                           ivector=ext, device="cpu")
    a = mk()
    a.process(x[:, :9600])
    p = str(tmp_path / "ivpipe_state.npz")
    streaming.save_state(p, a.state())
    c = mk()
    c.set_state(streaming.load_state(p, c.state()))
    assert torch.equal(_run(a, x[:, 9600:], [6400]),
                       _run(c, x[:, 9600:], [6400]))
    with pytest.raises(ValueError, match="ivector"):
        streaming.StreamingPipeline(NOCMVN, batch_size=1, pitch=True,
                                    device="cpu").set_state(c.state())


def test_reset_rows_keeps_other_rows(ext):
    x = oracle.noise(2, 12800, 94)
    pipe = streaming.StreamingPipeline(NOCMVN, batch_size=2, ivector=ext,
                                       device="cpu")
    ref = streaming.StreamingPipeline(NOCMVN, batch_size=2, ivector=ext,
                                      device="cpu")
    o1, r1 = pipe.process(x[:, :6400]), ref.process(x[:, :6400])
    pipe.reset_rows([1])
    o2, r2 = pipe.process(x[:, 6400:]), ref.process(x[:, 6400:])
    assert torch.equal(o1[0], r1[0]) and torch.equal(o2[0], r2[0])
    # the recycled slot restarts its i-vector at the prior, on its own grid
    assert int(pipe._ivector.n_seen[1]) == 40
    assert not torch.equal(o2[1], r2[1])


def test_reset_restores_fresh(ext):
    x = oracle.noise(1, 9600, 95)
    pipe = streaming.StreamingPipeline(NOCMVN, batch_size=1, ivector=ext,
                                       ivector_period=7, device="cpu")
    first = _run(pipe, x, [4800, 4800])
    pipe.reset()
    assert torch.equal(_run(pipe, x, [4800, 4800]), first)
    assert pipe.out_dim == 39 + ext.ivector_dim
    assert pipe._ivector.period == 7


def test_flush_raises_after_a_failed_solve(ext):
    pipe = streaming.StreamingPipeline(NOCMVN, batch_size=1, ivector=ext,
                                       device="cpu")
    pipe.process(oracle.noise(1, 3200, 96))
    pipe._ivector._bad[0] = True
    with pytest.raises(torch.linalg.LinAlgError, match="positive"):
        pipe.flush()


def test_ivector_checks(ext):
    with pytest.raises(TypeError, match="IvectorExtractor"):
        streaming.StreamingPipeline(KALDI39, ivector=object(),
                                    device="cpu")
    other = ivector.IvectorExtractor(
        ivector.DiagUbm(np.ones(1), np.zeros((1, 7)), np.ones((1, 7))),
        np.zeros((1, 7, 2)))
    with pytest.raises(ValueError, match="base feature dim 13"):
        streaming.StreamingPipeline(KALDI39, ivector=other, device="cpu")
