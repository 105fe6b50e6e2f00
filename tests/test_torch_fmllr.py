"""The port's fMLLR estimation (``tpufeat_torch.fmllr``) against
``tpufeat.fmllr`` and the float64 golden, on the CPU.

Tolerances: the statistics against the golden loop at
``tests/test_fmllr.py``'s (beta 1e-3 relative, K and G 1e-4 relative to
their largest entry: fp32 sums over the frames); the estimation is the
reference's float64 numpy, so on the same statistics the transforms are
equal to 1e-10; the whole chain (statistics, then estimation) against the
reference's within 1e-4. The VTLN warp search returns the reference's
warp and its per-warp scores within 1e-3.
"""

import dataclasses

import numpy as np
import pytest

from tpufeat import fmllr as jfm
from tpufeat import ivector as jiv

from tpufeat_torch import fmllr as fm
from tpufeat_torch.config import MFCC13_HTK, speaker_from_reference
from tpufeat_torch.data import apply_transform
from tpufeat_torch.reference import cpu as golden

CPU = "cpu"


def _ubm_samples(ubm, n, seed=1):
    r = np.random.default_rng(seed)
    comp = r.choice(ubm.num_gauss, size=n, p=ubm.weights)
    return (ubm.means[comp] + r.standard_normal((n, ubm.dim))
            * np.sqrt(ubm.vars[comp])).astype(np.float32)


@pytest.fixture(scope="module")
def jubm():
    r = np.random.default_rng(0)
    centers = r.standard_normal((4, 5)) * 2.0
    frames = np.concatenate([c + r.standard_normal((300, 5))
                             for c in centers]).astype(np.float32)
    return jiv.train_diag_ubm(frames, 4, iters=2, final_iters=4, seed=0)


@pytest.fixture(scope="module")
def ubm(jubm):
    return speaker_from_reference(dict(weights=jubm.weights,
                                       means=jubm.means, vars=jubm.vars))


def _close_stats(got, want):
    (b1, K1, G1), (b2, K2, G2) = got, want
    assert abs(b1 - b2) <= 1e-3 * abs(b2)
    np.testing.assert_allclose(K1, K2, atol=1e-4 * np.abs(K2).max())
    np.testing.assert_allclose(G1, G2, atol=1e-4 * np.abs(G2).max())


class TestStats:
    @pytest.mark.parametrize("min_post", [0.0, 0.05])
    def test_vs_golden_and_reference(self, ubm, jubm, min_post):
        x = _ubm_samples(ubm, 80, seed=2)
        got = fm.fmllr_stats(ubm, x, min_post=min_post, device=CPU)
        _close_stats(got, golden.fmllr_stats(x, ubm.weights, ubm.means,
                                             ubm.vars, min_post))
        _close_stats(got, jfm.fmllr_stats(jubm, x, min_post=min_post))

    def test_masked_batch_equals_concat(self, ubm):
        a, b = _ubm_samples(ubm, 50, 3), _ubm_samples(ubm, 30, 4)
        batch = np.zeros((2, 50, ubm.dim), np.float32)
        batch[0], batch[1, :30] = a, b
        _close_stats(fm.fmllr_stats(ubm, batch, np.array([50, 30]),
                                    device=CPU),
                     fm.fmllr_stats(ubm, np.concatenate([a, b]), device=CPU))

    def test_per_row_matches_reference(self, ubm, jubm):
        batch = np.stack([_ubm_samples(ubm, 40, s) for s in (5, 6, 7)])
        lengths = np.array([40, 25, 33])
        got = fm.fmllr_stats(ubm, batch, lengths, per_row=True, device=CPU)
        want = jfm.fmllr_stats(jubm, batch, lengths, per_row=True)
        for i in range(3):
            _close_stats([g[i] for g in got], [w[i] for w in want])

    def test_validates(self, ubm):
        with pytest.raises(ValueError, match="UBM dim"):
            fm.fmllr_stats(ubm, np.zeros((10, ubm.dim + 1)), device=CPU)
        with pytest.raises(ValueError, match="mask"):
            fm.fmllr_stats(ubm, np.zeros((2, 10, ubm.dim)),
                           np.ones((2, 9)), device=CPU)


class TestEstimation:
    def test_same_stats_same_transform(self, ubm):
        x = _ubm_samples(ubm, 600, seed=8)
        A = np.diag([1.3, 0.8, 1.1, 0.9, 1.2])
        y = (x @ A.T + 0.4).astype(np.float32)
        beta, K, G = fm.fmllr_stats(ubm, y, device=CPU)
        np.testing.assert_allclose(
            fm.estimate_fmllr(beta, K, G, min_count=100),
            jfm.estimate_fmllr(beta, K, G, min_count=100), atol=1e-10)
        W = fm.estimate_fmllr(beta, K, G, min_count=100)
        assert fm.fmllr_objective(beta, K, G, W) == \
            jfm.fmllr_objective(beta, K, G, W)

    def test_chain_matches_reference(self, ubm, jubm):
        y = (_ubm_samples(ubm, 700, seed=9) * 1.2 - 0.3).astype(np.float32)
        np.testing.assert_allclose(
            fm.est_fmllr(ubm, y, min_count=100, device=CPU),
            jfm.est_fmllr(jubm, y, min_count=100), atol=1e-4)

    def test_recovers_affine_distortion(self, ubm):
        x = _ubm_samples(ubm, 3000, seed=10)
        r = np.random.default_rng(11)
        A = np.eye(ubm.dim) + 0.15 * r.standard_normal((ubm.dim, ubm.dim))
        bias = 0.5 * r.standard_normal(ubm.dim)
        y = (x @ A.T + bias).astype(np.float32)
        W = fm.est_fmllr(ubm, y, min_count=100, device=CPU)
        back = apply_transform(y, W).numpy()
        assert np.abs(back - x).mean() < 0.25 * np.abs(y - x).mean()

    def test_identity_below_min_count(self, ubm):
        W = fm.est_fmllr(ubm, _ubm_samples(ubm, 20), min_count=500,
                         device=CPU)
        np.testing.assert_array_equal(
            W, np.concatenate([np.eye(ubm.dim), np.zeros((ubm.dim, 1))], 1))

    def test_validates(self):
        with pytest.raises(ValueError, match="shapes"):
            fm.estimate_fmllr(10.0, np.zeros((3, 3)), np.zeros((3, 4, 4)))
        with pytest.raises(ValueError, match="iters"):
            fm.estimate_fmllr(10.0, np.zeros((3, 4)), np.zeros((3, 4, 4)),
                              iters=0)


class TestVtlnWarp:
    def test_matches_reference(self):
        r = np.random.default_rng(0)
        audio = (r.standard_normal(12000) * 0.2).astype(np.float32)
        from tpufeat import features as jfeatures
        from tpufeat.config import MFCC13_HTK as JMFCC13
        feats = np.asarray(jfeatures.extract(audio, cfg=JMFCC13).features)
        jubm = jiv.train_diag_ubm(feats, 2, iters=1, final_iters=2, seed=0)
        ubm = speaker_from_reference(dict(
            weights=jubm.weights, means=jubm.means, vars=jubm.vars))
        warps = [0.9, 1.0, 1.1]
        best, scores = fm.estimate_vtln_warp(ubm, audio, warps=warps,
                                             device=CPU)
        jbest, jscores = jfm.estimate_vtln_warp(jubm, audio, warps=warps)
        assert best == jbest
        np.testing.assert_allclose([scores[w] for w in warps],
                                   [jscores[w] for w in warps], atol=1e-3)

    def test_validates_dim(self, ubm):
        with pytest.raises(ValueError, match="feature_dim"):
            fm.estimate_vtln_warp(
                ubm, np.zeros(8000, np.float32),
                cfg=dataclasses.replace(MFCC13_HTK, n_mfcc=7), device=CPU)
