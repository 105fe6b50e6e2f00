"""The port's multi-channel front-end (``tpufeat_torch/beamform.py``):
GCC-PHAT delays and steered delay-and-sum against the float64 goldens
(``tpufeat_torch.reference.cpu``, copies of the reference's), against
``tpufeat.beamform`` on the same input, and on synthetic geometry.
Mirrors ``tests/test_beamform.py``.

Tolerances: delays against the golden and against the reference 1e-5 abs
(integer peaks and a parabolic fraction of f32 correlations); the
beamformed signal against the golden 1e-4 abs (the reference's) and
against the reference 1e-5 abs; geometry checks the reference's own
bounds.
"""

import numpy as np
import pytest
import torch

from tpufeat import beamform as jbf

from tpufeat_torch import beamform as bf
from tpufeat_torch import extract, io
from tpufeat_torch.config import MFCC13_HTK
from tpufeat_torch.reference import cpu as golden


def _frac_shift(sig, d, n):
    """Delay ``sig`` by ``d`` samples (fractional ok) -> the first n."""
    p = 1
    while p < len(sig):
        p *= 2
    X = np.fft.rfft(sig, n=p)
    k = np.arange(p // 2 + 1)
    return np.fft.irfft(X * np.exp(-2j * np.pi * k * d / p), n=p)[:n]


def _array(delays, n=8000, noise=0.05, seed=0):
    r = np.random.default_rng(seed)
    clean = r.standard_normal(n + 256)
    x = np.stack([_frac_shift(clean, d, n) + noise * r.standard_normal(n)
                  for d in delays])
    return x.astype(np.float32), clean


def gcc(x, **kw):
    return bf.gcc_phat(x, device="cpu", **kw).numpy()


def das(x, **kw):
    y, d = bf.delay_and_sum(x, device="cpu", **kw)
    return y.numpy(), d.numpy()


class TestGccPhat:
    def test_recovers_integer_and_fractional_delays(self):
        delays = [0.0, 3.0, -5.0, 7.5, -2.25]
        d = gcc(_array(delays)[0], max_delay=32)
        np.testing.assert_allclose(d, delays, atol=0.3)
        assert d[0] == 0.0

    def test_matches_golden(self):
        x, _ = _array([0.0, 4.0, -6.0])
        for sub in (True, False):
            np.testing.assert_allclose(
                gcc(x, max_delay=24, subsample=sub),
                golden.gcc_phat(x, 24, subsample=sub), atol=1e-5)

    @pytest.mark.parametrize("sub", [True, False])
    def test_matches_tpufeat(self, sub):
        xa, _ = _array([0.0, 4.0, -6.0, 2.5], seed=10)
        xb, _ = _array([0.0, -3.0, 1.0, 9.25], seed=11)
        x = np.stack([xa, xb])
        lens = np.array([8000, 6000])
        np.testing.assert_allclose(
            gcc(x, max_delay=16, subsample=sub, lengths=lens, ref=1),
            np.asarray(jbf.gcc_phat(x, max_delay=16, subsample=sub,
                                    lengths=lens, ref=1)), atol=1e-5)

    def test_no_subsample_is_integer(self):
        d = gcc(_array([0.0, 7.5])[0], max_delay=16, subsample=False)
        np.testing.assert_array_equal(d, np.round(d))
        assert abs(d[1] - 7.5) <= 0.5

    def test_ref_channel(self):
        d = gcc(_array([0.0, 3.0, -5.0])[0], max_delay=16, ref=1)
        assert d[1] == 0.0
        np.testing.assert_allclose(d, [-3.0, 0.0, -8.0], atol=0.3)

    def test_batched_matches_single(self):
        xa, _ = _array([0.0, 4.0], seed=1)
        xb, _ = _array([0.0, -9.0], seed=2)
        d = gcc(np.stack([xa, xb]), max_delay=16)
        np.testing.assert_allclose(d[0], gcc(xa, max_delay=16), atol=1e-6)
        np.testing.assert_allclose(d[1], gcc(xb, max_delay=16), atol=1e-6)

    def test_lengths_mask(self):
        xa, _ = _array([0.0, 4.0], n=6000, seed=3)
        pad = np.concatenate([xa, 9.0 * np.ones((2, 2000), np.float32)],
                             axis=1)
        d = gcc(pad[None], max_delay=16, lengths=np.array([6000]))[0]
        np.testing.assert_allclose(d, gcc(xa, max_delay=16), atol=0.05)

    def test_validation(self):
        x, _ = _array([0.0, 1.0])
        with pytest.raises(ValueError, match="channels"):
            gcc(x[:1])
        with pytest.raises(ValueError, match="max_delay"):
            gcc(x, max_delay=0)
        with pytest.raises(ValueError, match="ref"):
            gcc(x, max_delay=8, ref=5)
        with pytest.raises(ValueError, match="expected"):
            gcc(np.zeros((2, 2, 2, 2), np.float32))


class TestSteerAndSum:
    def test_steer_inverts_known_shift(self):
        x, clean = _array([0.0, 6.0], noise=0.0)
        y = bf.steer(x, np.array([0.0, 6.0]), device="cpu").numpy()
        ref = _frac_shift(clean, 0.0, x.shape[1])
        np.testing.assert_allclose(y[1, 100:-100], ref[100:-100], atol=1e-3)

    def test_steer_matches_tpufeat(self):
        x, _ = _array([0.0, 2.5, -4.0], seed=12)
        d = np.array([0.0, 2.5, -4.25], np.float32)
        np.testing.assert_allclose(
            bf.steer(x, d, device="cpu").numpy(), np.asarray(jbf.steer(x, d)),
            atol=1e-5)
        with pytest.raises(ValueError, match="inconsistent"):
            bf.steer(x, d[:2], device="cpu")

    def test_delay_and_sum_vs_golden(self):
        x, _ = _array([0.0, 3.0, -5.0, 7.5])
        y, d = das(x, max_delay=32)
        np.testing.assert_allclose(y, golden.delay_and_sum(x, 32), atol=1e-4)
        assert y.shape == (x.shape[1],) and d.shape == (4,)

    def test_delay_and_sum_matches_tpufeat(self):
        xa, _ = _array([0.0, 3.0, -5.0], seed=13)
        xb, _ = _array([0.0, -2.0, 6.5], seed=14)
        x = np.stack([xa, xb])
        w = np.array([[1.0, 2.0, 1.0], [0.5, 0.5, 3.0]], np.float32)
        y, d = das(x, max_delay=16, weights=w)
        jy, jd = jbf.delay_and_sum(x, max_delay=16, weights=w)
        np.testing.assert_allclose(d, np.asarray(jd), atol=1e-5)
        np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5)

    def test_snr_improves_over_naive_mean(self):
        x, clean = _array([0.0, 3.0, -5.0, 7.5], noise=0.05, seed=4)
        y, _ = das(x, max_delay=32)
        ref = _frac_shift(clean, 0.0, x.shape[1])
        assert np.linalg.norm(y - ref) < 0.2 * np.linalg.norm(
            x.mean(axis=0) - ref)

    def test_weights(self):
        x, _ = _array([0.0, 2.0], noise=0.0, seed=5)
        y1, _ = das(x, max_delay=8, weights=np.array([1.0, 0.0]))
        np.testing.assert_allclose(y1, x[0], atol=1e-5)
        with pytest.raises(ValueError, match="weights"):
            das(x, max_delay=8, weights=np.ones(3))
        with pytest.raises(ValueError, match="sum"):
            das(x, max_delay=8, weights=np.array([0.0, 0.0]))

    def test_batched(self):
        xa, _ = _array([0.0, 4.0], seed=6)
        xb, _ = _array([0.0, -7.0], seed=7)
        y, d = das(np.stack([xa, xb]), max_delay=16)
        np.testing.assert_allclose(y[0], das(xa, max_delay=16)[0],
                                   atol=1e-5)
        assert d.shape == (2, 2)

    def test_feeds_extract(self):
        x, _ = _array([0.0, 3.0], n=16000, seed=8)
        y, _ = bf.delay_and_sum(x, max_delay=16, device="cpu")
        feats = extract(y, cfg=MFCC13_HTK).features
        assert tuple(feats.shape) == (98, 13)
        assert bool(torch.isfinite(feats).all())


class TestMultiChannelIO:
    def test_read_wav_all_channels(self, tmp_path):
        stereo = (0.1 * np.random.default_rng(9).standard_normal(
            (2, 4000))).astype(np.float32)
        p = str(tmp_path / "st.wav")
        io.write_wav(p, stereo.T, 16000)
        x, rate = io.read_wav(p, channel="all")
        assert rate == 16000 and x.shape == (2, 4000)
        np.testing.assert_array_equal(x[0], io.read_wav(p, channel=0)[0])
        np.testing.assert_allclose(x.mean(axis=0), io.read_wav(p)[0],
                                   atol=1e-7)
        d = gcc(x, max_delay=8)
        assert d.shape == (2,) and d[0] == 0.0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device"):
        bf.gcc_phat(np.zeros((2, 100), np.float32), max_delay=8)
