"""The port's ``StreamingPipeline`` with ``input_rate=`` (a resampler ahead
of the front-end) and ``pitch=`` (Kaldi pitch rows joined after the
spectral ones), and ``StreamPool`` over such a pipeline: against the
port's offline ``resample -> extract`` and ``pitch_features``, against
``tpufeat.streaming.StreamingPipeline`` fed the same chunks (in a process
of its own, ``tests/_jax_pitch_oracle.py`` group "pipeline", about 25 s),
and against itself across checkpoints and slot recycling. Mirrors
``TestInputRate``, ``TestStreamingPipelinePitch``,
``TestSlidingCmvnPitchComposition`` and ``TestPitchResetRows`` of
``tests/_streaming_pipeline_cases.py``.

Tolerances, relative to max(1, |want|.max()) where not said otherwise:
- the 39 spectral columns at ``input_rate=48000`` against the same
  pipeline fed ``resample()`` of the whole stream: bitwise (the streaming
  resampler gives the offline bits, and the step is the same);
- against the offline ``extract`` of the resampled signal: 1e-5, the
  reference's (f32 sums of the plain path in other shapes);
- with full lookahead, the spectral columns against the offline
  ``extract`` 1e-5 (1e-4 with sliding CMVN, the reference's), the pitch
  columns against ``pitch_features`` 2e-5 abs (the reference's);
- at K=15, POV and delta-log-pitch against ``pitch_features`` 2e-5 abs;
- against the reference's pipeline: the spectral columns 1e-4 (the
  port's ``extract``-vs-``tpufeat`` tolerance), the pitch columns 1e-5
  abs (the same decisions; f32 products in other orders);
- resumed against uninterrupted, untouched pool slots, and recycled pool
  slots against a pipeline fed zeros before the lease and reset alike:
  bitwise.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _jax_pitch_oracle as oracle
from tpufeat_torch import features, pitch as pm, resampling, streaming
from tpufeat_torch.config import KALDI39

KALDI39_NOCMVN = dataclasses.replace(KALDI39, cmvn="none")


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if got.size == 0:
        return 0.0
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _run(pipe, x, plan, flush=True):
    outs, pos = [], 0
    for c in plan:
        outs.append(pipe.process(x[:, pos: pos + c]))
        pos += c
    if flush:
        assert pos == x.shape[1]
        outs.append(pipe.flush())
    return torch.cat(outs, dim=1).numpy()


def _pipe(cfg, b, **kw):
    return streaming.StreamingPipeline(cfg, b, device="cpu", **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("oracle") / "pipeline.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, oracle.__file__, out, "pipeline"],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as d:
        got = {k: d[k] for k in d.files}
    got["_out"] = out
    return got


def _oracle_pipe(case):
    sig, change, opts, plan, _ = oracle.PIPE[case]
    x = sig()
    return x, _pipe(dataclasses.replace(KALDI39, **change), x.shape[0],
                    **opts), plan


class TestInputRate:
    def test_48k_ingest_matches_offline(self):
        x48 = oracle.noise(2, 96000, 91)
        plan = [4800, 333, 14400, 48000, 28467]
        x16 = resampling.resample(x48, 48000, 16000, device="cpu").numpy()
        got = _run(_pipe(KALDI39_NOCMVN, 2, input_rate=48000), x48, plan)
        # the same pipeline fed the offline-resampled signal: the bits
        fed16 = _run(_pipe(KALDI39_NOCMVN, 2), x16, [1600] * 20
                     + [x16.shape[1] - 32000])
        np.testing.assert_array_equal(got, fed16)
        want = features.extract(x16, cfg=KALDI39_NOCMVN,
                                device="cpu").features.numpy()
        assert _scaled(got, want) <= 1e-5

    def test_checkpoint_resume_with_resampler(self, tmp_path):
        x48 = oracle.noise(1, 48000, 92)
        a = _pipe(KALDI39_NOCMVN, 1, input_rate=48000)
        a.process(x48[:, :20000])
        path = str(tmp_path / "s.npz")
        streaming.save_state(path, a.state())
        b = _pipe(KALDI39_NOCMVN, 1, input_rate=48000)
        b.set_state(streaming.load_state(path, a.state()))
        ya = _run(a, x48[:, 20000:], [28000])
        yb = _run(b, x48[:, 20000:], [28000])
        np.testing.assert_array_equal(ya, yb)

    def test_input_rate_checkpoint_mismatch_rejected(self):
        a = _pipe(KALDI39_NOCMVN, 1, input_rate=48000)
        b = _pipe(KALDI39_NOCMVN, 1)
        with pytest.raises(ValueError, match="input_rate mismatch"):
            b.set_state(a.state())
        with pytest.raises(ValueError, match="input_rate mismatch"):
            a.set_state(b.state())

    def test_same_rate_is_passthrough(self):
        x = oracle.noise(1, 16000, 93)
        np.testing.assert_array_equal(
            _run(_pipe(KALDI39_NOCMVN, 1, input_rate=16000), x,
                 [1600] * 10),
            _run(_pipe(KALDI39_NOCMVN, 1), x, [1600] * 10))


class TestPitch:
    @pytest.mark.parametrize("cfg,tol", [
        (KALDI39_NOCMVN, 1e-5),
        (dataclasses.replace(KALDI39, **oracle.SLIDING), 1e-4)],
        ids=["nocmvn", "sliding"])
    def test_full_lookahead_matches_offline_composition(self, cfg, tol):
        """Lookahead >= the frames: every column equals the offline
        extract + pitch_features, truncated to the pitch frames."""
        b, n = 2, 8000
        x = oracle.voiced(b, n, 97)
        base = dataclasses.replace(cfg, deltas=False, cmvn="none")
        pcfg = pm.config_for(base, ballast=0.0)
        Fp = pcfg.num_frames(n)
        pipe = _pipe(cfg, b, pitch=pcfg, pitch_lookahead=Fp + 4)
        assert pipe.out_dim == 42
        got = _run(pipe, x, [n // 5] * 5)
        main = features.extract(x, cfg=cfg, device="cpu").features.numpy()
        pf, _ = pm.pitch_features(x, cfg=pcfg, device="cpu")
        assert got.shape == (b, Fp, 42)
        assert _scaled(got[..., :39], main[:, :Fp]) <= tol
        np.testing.assert_allclose(got[..., 39:], pf[:, :Fp].numpy(),
                                   rtol=0, atol=2e-5)

    def test_realistic_lookahead_shape_and_grid(self):
        b, n = 1, 20000
        x = oracle.voiced(b, n, 98)
        pcfg = pm.config_for(KALDI39_NOCMVN, ballast=0.0)
        Fp = pcfg.num_frames(n)
        got = _run(_pipe(KALDI39_NOCMVN, b, pitch=pcfg, pitch_lookahead=15),
                   x, [1600] * 12 + [800])
        assert got.shape == (b, Fp, 42)
        w = pm.pitch_features(x, cfg=pcfg, device="cpu")[0][:, :Fp].numpy()
        np.testing.assert_allclose(got[..., 39], w[..., 0], rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(got[..., 41], w[..., 2], rtol=0,
                                   atol=2e-5)

    def test_pitch_checkpoint_resume(self, tmp_path):
        b = 2
        x = oracle.voiced(b, 32000, 99)
        plan = [6400, 9600, 6400, 9600]
        want = _run(_pipe(KALDI39_NOCMVN, b, pitch=True), x, plan)
        p1 = _pipe(KALDI39_NOCMVN, b, pitch=True)
        first = _run(p1, x[:, :16000], plan[:2], flush=False)
        path = str(tmp_path / "pipe_pitch.npz")
        streaming.save_state(path, p1.state())
        p2 = _pipe(KALDI39_NOCMVN, b, pitch=True)
        p2.set_state(streaming.load_state(path, p2.state()))
        rest = _run(p2, x[:, 16000:], plan[2:])
        np.testing.assert_array_equal(np.concatenate([first, rest], 1),
                                      want)

    def test_reset_preserves_pitch_and_rate(self):
        pipe = _pipe(KALDI39_NOCMVN, 1, pitch=True, input_rate=48000)
        x = oracle.voiced(1, 24000, 100, sr=48000)
        first = _run(pipe, x, [12000, 12000])
        pipe.reset()
        assert pipe.out_dim == 42
        np.testing.assert_array_equal(_run(pipe, x, [12000, 12000]), first)

    def test_transform_then_pitch(self):
        """The transform applies to the spectral rows; pitch appends after
        it, untransformed."""
        rng = np.random.default_rng(5)
        t = rng.standard_normal((20, 39)).astype(np.float32)
        x = oracle.voiced(1, 8000, 3)
        a = _run(_pipe(KALDI39_NOCMVN, 1, pitch=True, transform=t), x,
                 [1600] * 5)
        b = _run(_pipe(KALDI39_NOCMVN, 1, pitch=True), x, [1600] * 5)
        assert a.shape[-1] == 23
        np.testing.assert_array_equal(a[..., 20:], b[..., 39:])
        np.testing.assert_allclose(a[..., :20], b[..., :39] @ t.T,
                                   rtol=1e-5, atol=1e-4)

    def test_pitch_pipeline_reset_rows(self):
        def run(pipe, x, plan, reset_at=None):
            outs, pos = [], 0
            for i, c in enumerate(plan):
                outs.append(pipe.process(x[:, pos: pos + c]))
                pos += c
                if i == reset_at:
                    pipe.reset_rows([0])
            return torch.cat(outs, dim=1).numpy()

        b = 2
        x = oracle.voiced(b, 16000, 60)
        plan = [4000] * 4
        ref = run(_pipe(KALDI39_NOCMVN, b, pitch=True), x, plan)
        pipe = _pipe(KALDI39_NOCMVN, b, pitch=True)
        assert pipe.warmup_rows == 8 + 2 * (15 + 2 * 2)
        got = run(pipe, x, plan, reset_at=1)
        np.testing.assert_array_equal(got[1], ref[1])
        assert got.shape[-1] == 42 and np.isfinite(got).all()
        assert not np.array_equal(got[0], ref[0])


class TestAgainstTpufeat:
    @pytest.mark.parametrize("case", sorted(oracle.PIPE))
    def test_rows_match_tpufeat_pipeline(self, case, reference):
        x, pipe, plan = _oracle_pipe(case)
        got = _run(pipe, x, plan)
        want = reference[case]
        assert got.shape == want.shape
        assert _scaled(got[..., :39], want[..., :39]) <= 1e-4
        np.testing.assert_allclose(got[..., 39:], want[..., 39:], rtol=0,
                                   atol=1e-5)

    def test_resume_from_a_state_tpufeat_saved(self, reference):
        """The reference's pipeline state (front-end, deltas, sliding CMVN,
        resampler, pitch tracker, FIFOs) loads into the port, which then
        gives the reference's remaining rows."""
        case = "rate48_pitch/sliding"
        x, pipe, plan = _oracle_pipe(case)
        at = oracle.PIPE[case][4]
        _, head_pipe, _ = _oracle_pipe(case)
        head = _run(head_pipe, x, plan[:at], flush=False)
        path = oracle.state_path(reference["_out"], case)
        pipe.set_state(streaming.load_state(path, pipe.state()))
        pos = int(reference[f"{case}/at"])
        tail = _run(pipe, x[:, pos:], plan[at:])
        want = reference[case][:, head.shape[1]:]
        assert _scaled(tail[..., :39], want[..., :39]) <= 1e-4
        np.testing.assert_allclose(tail[..., 39:], want[..., 39:], rtol=0,
                                   atol=1e-5)


def test_pool_over_a_rate_pitch_pipeline():
    """StreamPool over StreamingPipeline(input_rate=48000, pitch=True):
    slots recycled every tick. Untouched slots equal a pipeline that saw
    no recycling, bit for bit; recycled ones equal a pipeline fed zeros
    up to each lease and reset at the same ticks (so nothing of a slot's
    previous stream reaches the next), bit for bit, on every row."""
    S, ticks, churn, C = 6, 8, 2, 4800
    cfg = dataclasses.replace(KALDI39, **oracle.SLIDING)
    x = oracle.voiced(S, ticks * C, 61, sr=48000)

    def leased(k):
        return [((k - 1) * churn + j) % (S // 2) for j in range(churn)] \
            if 0 < k < ticks else []

    last = np.zeros(S, np.int64)
    for k in range(ticks):
        last[leased(k)] = k
    pool = streaming.StreamPool(_pipe(cfg, S, pitch=True, input_rate=48000))
    for _ in range(S):
        pool.attach()
    plain = _pipe(cfg, S, pitch=True, input_rate=48000)
    oracle_pipe = _pipe(cfg, S, pitch=True, input_rate=48000)
    untouched = last == 0
    checked = 0
    for k in range(ticks):
        block = x[:, k * C:(k + 1) * C]
        for s in leased(k):
            pool.detach(s)
        for _ in leased(k):
            pool.attach()
        out, skips = pool.process_batch(block).block()
        want = plain.process(block)
        oracle_pipe.reset_rows(leased(k))
        zeroed = np.where((last > k)[:, None], 0.0, block).astype(np.float32)
        zwant = oracle_pipe.process(zeroed)
        assert out.shape == want.shape == zwant.shape
        if out.shape[1] == 0:
            continue
        torch.testing.assert_close(out[untouched], want[untouched], rtol=0,
                                   atol=0)
        mine = ~untouched & (last <= k)
        torch.testing.assert_close(out[mine], zwant[mine], rtol=0, atol=0)
        checked += int(mine.sum())
        assert bool(torch.isfinite(out).all())
    assert checked > 0
