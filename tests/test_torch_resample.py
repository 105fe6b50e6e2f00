"""The port's polyphase resampler (``tpufeat_torch/resampling.py``) against
scipy's ``resample_poly`` (the float64 oracle), against
``tpufeat.resampling`` on the same input, and against itself across chunk
plans. Mirrors ``tests/test_resample.py`` and the int16 case of
``tests/test_round2_fixes.py``; the reference's ``StreamingResampler``
runs in a process of its own (``tests/_jax_pitch_oracle.py``, group
"resampler", about 5 s).

Tolerances:
- against scipy: 2e-5 relative to max(1, |want|.max()), the reference's;
- against ``tpufeat.resampling.resample``: 1e-6 scaled (both float32, the
  same taps summed in another order);
- the streaming resampler against ``resample(whole)``: bit for bit on
  every rate pair and every chunk plan. The reference holds its 44.1 kHz
  family to 3e-7 abs and 4e-6 rel, its matmul's order varying with the
  row count; the port's fixed tap order makes that family exact too;
- ``block=256`` against the base path: 1e-6 scaled (BLAS sums);
- a resampler resumed from the reference's state against the reference's
  output: 3e-7 abs, 4e-6 rel, the reference's own 44.1 kHz bound (the
  carry is the same samples; the sums run in another order).
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.signal
import torch
from hypothesis import given, settings, strategies as st

from tpufeat import resampling as jresampling

import _jax_pitch_oracle as oracle
from conftest import make_signal
from tpufeat_torch import features, resampling
from tpufeat_torch.config import MFCC13_HTK

RATES = [(8000, 16000), (16000, 8000), (48000, 16000), (44100, 16000),
         (22050, 16000), (16000, 22050)]


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _resample(x, sr_in, sr_out, **kw):
    return resampling.resample(x, sr_in, sr_out, device="cpu", **kw).numpy()


def _stream(x, sr_in, sr_out, plan):
    """Feed ``x`` [B, n] in the plan's chunks (the last one takes the
    rest) and flush; the outputs concatenated."""
    sr = resampling.StreamingResampler(sr_in, sr_out, x.shape[0],
                                       device="cpu")
    outs, i = [], 0
    for step in plan:
        step = min(step, x.shape[1] - i)
        outs.append(sr.process(x[:, i:i + step]))
        i += step
        if i == x.shape[1]:
            break
    outs.append(sr.flush())
    return torch.cat(outs, dim=1).numpy()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's StreamingResampler outputs and mid-stream states."""
    out = str(tmp_path_factory.mktemp("oracle") / "resampler.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, oracle.__file__, out, "resampler"],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


class TestResample:
    @pytest.mark.parametrize("sr_in,sr_out", RATES)
    def test_matches_scipy(self, sr_in, sr_out):
        n = sr_in // 2 + 137
        sig = make_signal(n, seed=sr_in % 97)
        got = _resample(sig, sr_in, sr_out)
        g = math.gcd(sr_in, sr_out)
        want = scipy.signal.resample_poly(sig.astype(np.float64),
                                          sr_out // g, sr_in // g)
        assert _scaled(got, want) < 2e-5

    @pytest.mark.parametrize("sr_in,sr_out", RATES)
    def test_matches_tpufeat(self, sr_in, sr_out):
        sig = make_signal(sr_in // 3 + 11, seed=sr_in % 53)
        want = np.asarray(jresampling.resample(sig, sr_in, sr_out))
        assert _scaled(_resample(sig, sr_in, sr_out), want) <= 1e-6

    def test_batched(self):
        sigs = np.stack([make_signal(8000, seed=1),
                         make_signal(8000, seed=2)])
        got = _resample(sigs, 8000, 16000)
        assert got.shape == (2, 16000)
        for b in range(2):
            want = scipy.signal.resample_poly(sigs[b].astype(np.float64),
                                              2, 1)
            assert np.abs(got[b] - want).max() < 2e-5
            np.testing.assert_array_equal(got[b],
                                          _resample(sigs[b], 8000, 16000))

    def test_identity(self):
        sig = make_signal(1000)
        np.testing.assert_array_equal(_resample(sig, 16000, 16000), sig)

    def test_tone_preserved(self):
        t = np.arange(48000) / 48000.0
        sig = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
        got = _resample(sig, 48000, 16000)
        want = np.sin(2 * np.pi * 440.0 * np.arange(len(got)) / 16000.0)
        assert np.abs(got[200:-200] - want[200:-200]).max() < 1e-3

    def test_output_length_formula(self):
        for n in (1, 7, 160, 16000, 44100):
            assert resampling.output_length(n, 2, 1) == 2 * n
            assert resampling.output_length(n, 160, 441) == \
                -(-n * 160 // 441)

    def test_pathological_rates_rejected(self):
        with pytest.raises(ValueError, match="intermediate"):
            resampling.resample(np.zeros(100, np.float32), 44101, 16000,
                                device="cpu")

    def test_end_to_end_features(self):
        sig16 = resampling.resample(make_signal(8000, seed=9), 8000, 16000,
                                    device="cpu")
        res = features.extract(sig16, cfg=MFCC13_HTK)
        assert res.features.shape == (MFCC13_HTK.num_frames(16000), 13)
        assert bool(torch.isfinite(res.features).all())

    def test_int16_scaled(self):
        sig = make_signal(4000, seed=95)
        pcm = np.clip(np.round(sig * 32768), -32768, 32767).astype(np.int16)
        a = _resample(pcm, 8000, 16000)
        b = _resample(pcm.astype(np.float32) / 32768.0, 8000, 16000)
        np.testing.assert_array_equal(a, b)
        assert np.abs(a).max() < 1.5

    def test_matrices_are_the_references(self):
        for p, q in ((1, 3), (160, 441), (1, 8)):
            H, c0 = resampling.resample_matrix(p, q)
            jH, jc0 = jresampling.resample_matrix(p, q)
            np.testing.assert_array_equal(H, jH)
            assert c0 == jc0
        np.testing.assert_array_equal(
            resampling.resample_matrix_blocked(1, 8, 4)[0],
            jresampling.resample_matrix_blocked(1, 8, 4)[0])

    @pytest.mark.parametrize("sr_in,sr_out", [(16000, 2000),
                                              (48000, 16000)])
    def test_blocked_equals_base_to_roundoff(self, sr_in, sr_out):
        x = np.random.default_rng(4).standard_normal(
            (3, sr_in // 3 + 5)).astype(np.float32)
        got = _resample(x, sr_in, sr_out, block=256)
        assert _scaled(got, _resample(x, sr_in, sr_out)) <= 1e-6
        want = np.asarray(jresampling.resample(x, sr_in, sr_out, block=256))
        assert _scaled(got, want) <= 1e-6

    def test_no_frames_tensor(self, monkeypatch):
        """The base path never frames the input (no Tensor.unfold)."""
        def refuse(*a, **kw):
            raise AssertionError("resample framed its input")
        monkeypatch.setattr(torch.Tensor, "unfold", refuse)
        x = np.random.default_rng(5).standard_normal((2, 48000)).astype(
            np.float32)
        assert _resample(x, 48000, 16000).shape == (2, 16000)

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device"):
            resampling.resample(np.zeros(100, np.float32), 48000, 16000)
        with pytest.raises(RuntimeError, match="device"):
            resampling.StreamingResampler(48000, 16000)


class TestStreamingResampler:
    @pytest.mark.parametrize("sr_in,sr_out", RATES)
    def test_exact_vs_offline(self, sr_in, sr_out):
        n = sr_in // 2 + 137
        sig = make_signal(n, seed=sr_in % 89)[None]
        want = _resample(sig, sr_in, sr_out)
        got = _stream(sig, sr_in, sr_out, [160, 1, 1601, 7, n])
        np.testing.assert_array_equal(got, want)

    def test_chunk_plan_invariance_batched(self):
        x = np.random.default_rng(5).standard_normal((3, 24000)).astype(
            np.float32)
        np.testing.assert_array_equal(
            _stream(x, 48000, 16000, [1536] * 16),
            _resample(x, 48000, 16000))

    def test_state_roundtrip(self):
        sig = make_signal(9000, seed=3)[None]
        a = resampling.StreamingResampler(44100, 16000, device="cpu")
        a.process(sig[:, :4000])
        b = resampling.StreamingResampler(44100, 16000, device="cpu")
        b.set_state(a.state())
        ya = torch.cat([a.process(sig[:, 4000:]), a.flush()], dim=1)
        yb = torch.cat([b.process(sig[:, 4000:]), b.flush()], dim=1)
        torch.testing.assert_close(ya, yb, rtol=0, atol=0)

    @pytest.mark.parametrize("case", sorted(oracle.RESAMPLER))
    def test_matches_tpufeat_streaming(self, case, reference):
        (sr_in, sr_out), sig, plan, _ = oracle.RESAMPLER[case]
        x = sig()
        got = _stream(x, sr_in, sr_out, plan)
        np.testing.assert_allclose(got, reference[f"resampler/{case}"],
                                   atol=3e-7, rtol=4e-6)

    @pytest.mark.parametrize("case", sorted(oracle.RESAMPLER))
    def test_resume_from_a_state_tpufeat_saved(self, case, reference):
        (sr_in, sr_out), sig, plan, at = oracle.RESAMPLER[case]
        x = sig()
        prefix = f"resampler/{case}/state/"
        state = {k[len(prefix):]: v for k, v in reference.items()
                 if k.startswith(prefix)}
        r = resampling.StreamingResampler(sr_in, sr_out, x.shape[0],
                                          device="cpu")
        r.set_state(state)
        pos = int(reference[f"resampler/{case}/at"])
        tail = torch.cat([r.process(x[:, pos:]), r.flush()], dim=1).numpy()
        want = reference[f"resampler/{case}"]
        np.testing.assert_allclose(tail, want[:, want.shape[1]
                                              - tail.shape[1]:],
                                   atol=3e-7, rtol=4e-6)

    def test_reset_rows_leaves_the_other_rows(self):
        """Untouched rows keep their bits; the reset row is a stream that
        carried zeros up to the reset (the zeros-prefix history)."""
        x = np.random.default_rng(7).standard_normal((3, 9216)).astype(
            np.float32)
        a = resampling.StreamingResampler(48000, 16000, 3, device="cpu")
        b = resampling.StreamingResampler(48000, 16000, 3, device="cpu")
        outs_a, outs_b, start = [], [], 0
        for k in range(6):
            c = x[:, k * 1536:(k + 1) * 1536]
            if k == 3:
                b.reset_rows([1])
                start = sum(o.shape[1] for o in outs_b)
            outs_a.append(a.process(c))
            outs_b.append(b.process(c))
        ya, yb = torch.cat(outs_a, 1), torch.cat(outs_b, 1)
        torch.testing.assert_close(yb[[0, 2]], ya[[0, 2]], rtol=0, atol=0)
        z = x[1:2].copy()
        z[:, :3 * 1536] = 0.0
        want = _stream(z, 48000, 16000, [1536] * 6)[0, :yb.shape[1]]
        np.testing.assert_array_equal(yb[1, start:].numpy(), want[start:])

    def test_passthrough_and_validation(self):
        sr = resampling.StreamingResampler(16000, 16000, device="cpu")
        x = make_signal(1000, seed=1)[None]
        np.testing.assert_array_equal(sr.process(x).numpy(), x)
        assert tuple(sr.flush().shape) == (1, 0)
        with pytest.raises(ValueError):
            resampling.StreamingResampler(44100, 44101, device="cpu")
        sr2 = resampling.StreamingResampler(48000, 16000, batch_size=2,
                                            device="cpu")
        with pytest.raises(ValueError):
            sr2.process(np.zeros((3, 100), np.float32))

    def test_empty_stream_flush(self):
        sr = resampling.StreamingResampler(48000, 16000, device="cpu")
        assert tuple(sr.flush().shape) == (1, 0)
        sr.reset()
        out = torch.cat([sr.process(np.zeros((1, 30), np.float32)),
                         sr.flush()], dim=1)
        assert tuple(out.shape) == (1, resampling.output_length(30, 1, 3))
        assert not bool(out.any())


class TestStreamingResamplerProperties:
    @given(data=st.data(),
           pair=st.sampled_from([(8000, 16000), (48000, 16000),
                                 (16000, 8000), (22050, 16000),
                                 (44100, 16000)]),
           n=st.integers(min_value=1, max_value=6000))
    @settings(max_examples=15, deadline=None)
    def test_any_chunk_plan_matches_offline(self, data, pair, n):
        sr_in, sr_out = pair
        sig = np.random.default_rng(n).standard_normal((1, n)).astype(
            np.float32)
        plan, i = [], 0
        while i < n:
            step = data.draw(st.integers(1, n - i))
            plan.append(step)
            i += step
        np.testing.assert_array_equal(_stream(sig, sr_in, sr_out, plan),
                                      _resample(sig, sr_in, sr_out))
