"""The port's i-vector stack (``tpufeat_torch.ivector``) against
``tpufeat.ivector`` and the float64 goldens, on the CPU.

The cases of ``tests/test_ivector.py``, fed the same seeded numpy inputs
through both packages. Models trained by the reference are carried across
by ``config.speaker_from_reference`` so that each function is held on the
same parameters.

Tolerances (the reference's own, ``tests/test_ivector.py``):
- ``log_likes`` atol 2e-4 / rtol 1e-5 and posteriors 1e-5 against the
  golden; the stats' counts 1e-3 and first-order 1e-2 / rtol 1e-4, and
  the estimate 1e-4;
- ``ivector_features`` 1e-4 against the golden and against the
  reference; the stream 1e-4 against ``ivector_features`` for every
  plan; batch rows 1e-5; reset rows 1e-6;
- the causality frames, the state round trip and the initial draws:
  exact;
- training with the same seed: the port's EM objectives within 1e-3
  relative of the reference's (f32 statistics summed in another order),
  the UBM's average log-likelihood within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from tpufeat import ivector as jiv
from tpufeat import streaming as jstreaming
from tpufeat.reference import cpu as jgolden

from tpufeat_torch import ivector as iv
from tpufeat_torch import streaming
from tpufeat_torch.config import speaker_from_reference
from tpufeat_torch.reference import cpu as golden

CPU = "cpu"


def _clustered_frames(n_per=200, n_clusters=3, dim=13, seed=0):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((n_clusters, dim)) * 3.0
    return np.concatenate(
        [c + r.standard_normal((n_per, dim)) for c in centers]
    ).astype(np.float32)


def _utts(n, length, seed):
    r = np.random.default_rng(seed)
    x = _clustered_frames()
    return [x[r.integers(0, len(x), length)] for _ in range(n)]


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def jax_models():
    ubm = jiv.train_diag_ubm(_clustered_frames(), 8, iters=3,
                             final_iters=6, seed=0)
    ext = jiv.train_ivector_extractor(ubm, _utts(6, 150, 1),
                                      ivector_dim=8, iters=3, seed=1)
    return ubm, ext


@pytest.fixture(scope="module")
def extractor(jax_models):
    _, ext = jax_models
    return speaker_from_reference(dict(
        weights=ext.ubm.weights, means=ext.ubm.means, vars=ext.ubm.vars,
        M=ext.M))


@pytest.fixture(scope="module")
def ubm(extractor):
    return extractor.ubm


class TestDiagUbm:
    def test_log_likes_vs_golden_and_reference(self, ubm, jax_models):
        x = _clustered_frames(n_per=30, seed=5)
        got = _np(ubm.log_likes(x, device=CPU))
        want = golden.diag_gmm_log_likes(x, ubm.weights, ubm.means,
                                         ubm.vars)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jax_models[0].log_likes(x)),
                                   atol=2e-4, rtol=1e-5)

    @pytest.mark.parametrize("min_post", [0.0, 0.025])
    def test_posteriors_vs_golden(self, ubm, min_post):
        x = _clustered_frames(n_per=30, seed=6)
        got = _np(ubm.posteriors(x, min_post=min_post, device=CPU))
        want = golden.gmm_posteriors(x, ubm.weights, ubm.means, ubm.vars,
                                     min_post)
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)

    def test_min_post_prunes(self, ubm):
        p = _np(ubm.posteriors(_clustered_frames(n_per=30, seed=7),
                               min_post=0.1, device=CPU))
        assert ((p == 0.0) | (p >= 0.05)).all()

    def test_training_matches_reference(self, jax_models):
        x = _clustered_frames()
        mine = iv.train_diag_ubm(x, 8, iters=3, final_iters=6, seed=0,
                                 device=CPU)
        ref = jax_models[0]
        a = iv.avg_log_like(mine, x, device=CPU)
        b = float(jiv.avg_log_like(ref, x))
        assert abs(a - b) <= 1e-4 * abs(b), (a, b)
        np.testing.assert_allclose(mine.weights.sum(), 1.0, atol=1e-9)
        np.testing.assert_allclose(mine.means, ref.means, atol=1e-3)

    def test_training_recovers_clusters(self):
        r = np.random.default_rng(3)
        centers = np.array([[-6.0, 0.0], [0.0, 6.0], [6.0, 0.0]])
        x = np.concatenate(
            [c + 0.5 * r.standard_normal((300, 2)) for c in centers]
        ).astype(np.float32)
        ubm = iv.train_diag_ubm(x, 8, iters=5, final_iters=10, seed=0,
                                device=CPU)
        d = np.linalg.norm(ubm.means[None] - centers[:, None], axis=2)
        assert d.min(axis=1).max() < 1.0

    def test_em_monotone(self):
        x = _clustered_frames(n_per=120, seed=9)
        lls = [iv.avg_log_like(iv.train_diag_ubm(
            x, 4, iters=2, final_iters=final, seed=0, device=CPU), x,
            device=CPU) for final in (1, 4, 8)]
        assert lls[0] <= lls[1] + 1e-4 and lls[1] <= lls[2] + 1e-4

    def test_npz_both_ways(self, ubm, jax_models, tmp_path):
        p = str(tmp_path / "ubm.npz")
        ubm.save(p)
        back = jiv.DiagUbm.load(p)
        np.testing.assert_array_equal(back.means, ubm.means)
        jax_models[0].save(p)
        mine = iv.DiagUbm.load(p)
        np.testing.assert_array_equal(mine.vars, jax_models[0].vars)

    def test_rejects_bad_params(self):
        with pytest.raises(ValueError):
            iv.DiagUbm(np.array([0.7, 0.7]), np.zeros((2, 3)),
                       np.ones((2, 3)))
        with pytest.raises(ValueError):
            iv.DiagUbm(np.array([0.5, 0.5]), np.zeros((2, 3)),
                       np.zeros((2, 3)))
        with pytest.raises(ValueError):
            iv.train_diag_ubm(np.zeros((10, 3), np.float32), 2, device=CPU)

    def test_default_device_is_the_card(self, ubm):
        if torch.cuda.is_available():
            pytest.skip("the rule for a host without a card")
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            ubm.log_likes(np.zeros((3, ubm.dim), np.float32))


class TestExtractor:
    def test_stats_and_estimate_vs_golden(self, ubm, extractor):
        x = _clustered_frames(n_per=40, seed=11)
        n, f = extractor.stats(x, device=CPU)
        got = _np(extractor.estimate(n, f))
        n_g, f_g = golden.ivector_stats(x, ubm.weights, ubm.means,
                                        ubm.vars)
        np.testing.assert_allclose(_np(n), n_g, atol=1e-3)
        np.testing.assert_allclose(_np(f), f_g, atol=1e-2, rtol=1e-4)
        want = golden.ivector_estimate(n_g, f_g, extractor.M, ubm.vars)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_utterance_ivector_vs_reference(self, extractor, jax_models):
        x = _clustered_frames(n_per=40, seed=11)
        got = _np(iv.utterance_ivector(extractor, x, device=CPU))
        want = np.asarray(jiv.utterance_ivector(jax_models[1], x))
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)

    def test_zero_stats_gives_prior_mean(self, extractor):
        g = extractor.ubm.num_gauss
        w = extractor.estimate(torch.zeros(g),
                               torch.zeros(g, extractor.ubm.dim))
        assert torch.equal(w, torch.zeros(extractor.ivector_dim))

    def test_mask_invariance(self, extractor):
        x = _clustered_frames(n_per=20, seed=12)[None]     # [1, 60, D]
        xpad = np.concatenate(
            [x, 99.0 * np.ones((1, 17, x.shape[2]), np.float32)], axis=1)
        mask = (np.arange(77)[None, :] < 60).astype(np.float32)
        w = _np(iv.utterance_ivector(extractor, x, device=CPU))
        wpad = _np(iv.utterance_ivector(extractor, xpad, mask, device=CPU))
        np.testing.assert_allclose(w, wpad, atol=2e-4, rtol=1e-3)

    def test_non_spd_precision_raises(self, extractor):
        g = extractor.ubm.num_gauss
        with pytest.raises(torch.linalg.LinAlgError, match="positive"):
            extractor.estimate(torch.full((g,), -1e6),
                               torch.zeros(g, extractor.ubm.dim))

    def test_initial_draws_bit_equal(self, ubm):
        """iters=0 returns the seeded initial M: numpy's generator in both
        packages, so the bits agree."""
        utts = _utts(2, 50, 4)
        mine = iv.train_ivector_extractor(ubm, utts, ivector_dim=5,
                                          iters=0, seed=9, device=CPU)
        ref = jiv.train_ivector_extractor(
            jiv.DiagUbm(ubm.weights, ubm.means, ubm.vars), utts,
            ivector_dim=5, iters=0, seed=9)
        np.testing.assert_array_equal(mine.M, ref.M)

    def test_em_objective_matches_reference(self, ubm, jax_models):
        utts = _utts(5, 100, 2)
        _, mine = iv.train_ivector_extractor(
            ubm, utts, ivector_dim=6, iters=4, seed=3,
            return_objective=True, device=CPU)
        _, ref = jiv.train_ivector_extractor(
            jax_models[0], utts, ivector_dim=6, iters=4, seed=3,
            return_objective=True)
        np.testing.assert_allclose(mine, ref, rtol=1e-3)
        assert mine[-1] >= mine[1] - 1e-3     # monotone after the init

    def test_recovers_latent_direction(self, ubm):
        r = np.random.default_rng(4)
        G, D, K = ubm.num_gauss, ubm.dim, 4
        M_true = r.standard_normal((G, D, K)) * np.sqrt(ubm.vars)[:, :, None]

        def sample_utt(w, T=300):
            g = r.choice(G, size=T, p=ubm.weights)
            return (ubm.means[g] + M_true[g] @ w
                    + np.sqrt(ubm.vars[g]) * r.standard_normal((T, D))
                    ).astype(np.float32)

        ws = [r.standard_normal(K) for _ in range(4)]
        utts = [sample_utt(w) for w in ws for _ in range(3)]
        ext = iv.train_ivector_extractor(ubm, utts, ivector_dim=K,
                                         iters=6, seed=5, device=CPU)
        ivs = np.stack([_np(iv.utterance_ivector(ext, u, device=CPU))
                        for u in utts])
        lab = np.repeat(np.arange(4), 3)
        d = np.linalg.norm(ivs[:, None] - ivs[None, :], axis=2)
        same = d[lab[:, None] == lab[None, :]]
        diff = d[lab[:, None] != lab[None, :]]
        assert np.median(same) < 0.5 * np.median(diff)

    def test_npz_both_ways(self, extractor, jax_models, tmp_path):
        p = str(tmp_path / "ext.npz")
        extractor.save(p)
        back = jiv.IvectorExtractor.load(p)
        np.testing.assert_array_equal(back.M, extractor.M)
        jax_models[1].save(p)
        mine = iv.IvectorExtractor.load(p)
        np.testing.assert_array_equal(mine.M, jax_models[1].M)
        np.testing.assert_array_equal(mine.ubm.means, jax_models[1].ubm.means)

    def test_rejects_shape_mismatch(self, ubm):
        with pytest.raises(ValueError):
            iv.IvectorExtractor(ubm, np.zeros((2, 2, 4)))


class TestIvectorFeatures:
    def test_vs_golden_and_reference(self, ubm, extractor, jax_models):
        x = _clustered_frames(n_per=25, seed=13)           # 75 frames
        got = _np(iv.ivector_features(extractor, x, period=10, device=CPU))
        want = golden.ivector_features(x, ubm.weights, ubm.means,
                                       ubm.vars, extractor.M, period=10)
        np.testing.assert_allclose(got, want, atol=1e-4)
        ref = np.asarray(jiv.ivector_features(jax_models[1], x, period=10))
        np.testing.assert_allclose(got, ref, atol=1e-4)

    def test_golden_copy_is_the_reference(self, ubm, extractor):
        x = _clustered_frames(n_per=10, seed=13)
        np.testing.assert_array_equal(
            golden.ivector_features(x, ubm.weights, ubm.means, ubm.vars,
                                    extractor.M, period=7),
            jgolden.ivector_features(x, ubm.weights, ubm.means, ubm.vars,
                                     extractor.M, period=7))

    def test_causality_and_grid(self, extractor):
        x = _clustered_frames(n_per=20, seed=14)           # 60 frames
        out = _np(iv.ivector_features(extractor, x, period=10, device=CPU))
        np.testing.assert_array_equal(out[:10], 0.0)       # prior first
        for m in range(6):                                 # constant blocks
            blk = out[m * 10: (m + 1) * 10]
            np.testing.assert_array_equal(blk, blk[0:1].repeat(len(blk), 0))
        # changing FUTURE frames never changes the past
        x2 = x.copy()
        x2[35:] += 5.0
        out2 = _np(iv.ivector_features(extractor, x2, period=10,
                                       device=CPU))
        np.testing.assert_array_equal(out[:40], out2[:40])

    def test_batched_matches_single(self, extractor):
        a = _clustered_frames(n_per=15, seed=15)           # 45
        b = _clustered_frames(n_per=11, seed=16)[:33]      # 33
        batch = np.zeros((2, 45, a.shape[1]), np.float32)
        batch[0], batch[1, :33] = a, b
        out = _np(iv.ivector_features(extractor, batch,
                                      lengths=np.array([45, 33]),
                                      device=CPU))
        np.testing.assert_allclose(
            out[0], _np(iv.ivector_features(extractor, a, device=CPU)),
            atol=2e-5)
        np.testing.assert_allclose(
            out[1, :33], _np(iv.ivector_features(extractor, b, device=CPU)),
            atol=2e-5)

    def test_max_count_damps(self, ubm, extractor):
        x = _clustered_frames(n_per=40, seed=17)
        got = _np(iv.ivector_features(extractor, x, period=10,
                                      max_count=1.5, device=CPU))
        want = golden.ivector_features(x, ubm.weights, ubm.means,
                                       ubm.vars, extractor.M, period=10,
                                       max_count=1.5)
        np.testing.assert_allclose(got, want, atol=1e-4)
        free = _np(iv.ivector_features(extractor, x, period=10, device=CPU))
        assert np.abs(got[-1]).max() < np.abs(free[-1]).max() + 1e-6

    def test_chunked_products_are_the_same(self, extractor, monkeypatch):
        """Row chunks of the first-order products and of the solves give
        the one-chunk result to f32 rounding."""
        x = _clustered_frames(n_per=30, seed=23)
        whole = _np(iv.ivector_features(extractor, x, device=CPU))
        monkeypatch.setattr(iv, "CHUNK_BYTES", 1)          # a row a chunk
        np.testing.assert_allclose(
            _np(iv.ivector_features(extractor, x, device=CPU)), whole,
            atol=1e-5)

    def test_rejects_bad_period(self, extractor):
        with pytest.raises(ValueError):
            iv.ivector_features(extractor, np.zeros((5, extractor.ubm.dim),
                                                    np.float32),
                                period=0, device=CPU)


class TestStreamingIvector:
    PLANS = ([10, 10, 10, 10], [7, 13, 1, 19], [40], [3] * 13 + [1],
             [25, 15])

    @pytest.mark.parametrize("plan", PLANS)
    def test_matches_offline_any_plan(self, extractor, plan):
        x = _clustered_frames(n_per=14, seed=18)[: sum(plan)]
        want = _np(iv.ivector_features(extractor, x, period=10,
                                       device=CPU))
        st = iv.StreamingIvector(extractor, period=10, device=CPU)
        outs, i = [], 0
        for c in plan:
            outs.append(_np(st.process(x[None, i: i + c])))
            i += c
        got = np.concatenate(outs, axis=1)[0]
        np.testing.assert_allclose(got, want[: len(got)], atol=1e-4)

    def test_matches_reference_stream(self, extractor, jax_models):
        x = _clustered_frames(n_per=14, seed=18)[:40]
        mine = iv.StreamingIvector(extractor, period=7, max_count=2.0,
                                   device=CPU)
        ref = jiv.StreamingIvector(jax_models[1], period=7, max_count=2.0)
        for a, b in ((0, 11), (11, 12), (12, 40)):
            np.testing.assert_allclose(_np(mine.process(x[None, a:b])),
                                       np.asarray(ref.process(x[None, a:b])),
                                       atol=1e-4)

    def test_batch_rows_independent(self, extractor):
        a = _clustered_frames(n_per=12, seed=19)[:36]
        b = _clustered_frames(n_per=12, seed=20)[:36]
        st = iv.StreamingIvector(extractor, batch_size=2, device=CPU)
        got = _np(st.process(np.stack([a, b])))
        sa = iv.StreamingIvector(extractor, device=CPU)
        np.testing.assert_allclose(got[0], _np(sa.process(a[None]))[0],
                                   atol=1e-5)

    def test_reset_rows_restarts(self, extractor):
        x = _clustered_frames(n_per=12, seed=21)[:36]
        st = iv.StreamingIvector(extractor, batch_size=2, device=CPU)
        st.process(np.stack([x, x * 0.5]))
        st.reset_rows([1])
        out = _np(st.process(np.stack([x, x])))
        fresh = iv.StreamingIvector(extractor, device=CPU)
        np.testing.assert_allclose(out[1], _np(fresh.process(x[None]))[0],
                                   atol=1e-6)
        cont = iv.StreamingIvector(extractor, device=CPU)
        cont.process(x[None])
        np.testing.assert_allclose(out[0], _np(cont.process(x[None]))[0],
                                   atol=1e-6)

    def test_state_roundtrip(self, extractor, tmp_path):
        x = _clustered_frames(n_per=12, seed=22)[:36]
        st = iv.StreamingIvector(extractor, device=CPU)
        st.process(x[None, :17])
        path = str(tmp_path / "iv_state.npz")
        streaming.save_state(path, st.state())
        st2 = iv.StreamingIvector(extractor, device=CPU)
        st2.set_state(streaming.load_state(path, st2.state()))
        assert torch.equal(st2.process(x[None, 17:]),
                           st.process(x[None, 17:]))

    def test_resume_from_a_state_tpufeat_saved(self, extractor, jax_models,
                                               tmp_path):
        x = _clustered_frames(n_per=12, seed=22)[:36]
        ref = jiv.StreamingIvector(jax_models[1])
        ref.process(x[None, :17])
        path = str(tmp_path / "jax_iv_state.npz")
        jstreaming.save_state(path, ref.state())
        mine = iv.StreamingIvector(extractor, device=CPU)
        mine.set_state(streaming.load_state(path, mine.state()))
        assert int(mine.n_seen[0]) == 17
        np.testing.assert_allclose(_np(mine.process(x[None, 17:])),
                                   np.asarray(ref.process(x[None, 17:])),
                                   atol=1e-4)

    def test_check_raises_after_a_failed_step(self, extractor):
        st = iv.StreamingIvector(extractor, batch_size=2, device=CPU)
        st.check()
        st.process(np.zeros((2, 3, extractor.ubm.dim), np.float32))
        st._bad[1] = True
        with pytest.raises(torch.linalg.LinAlgError):
            st.check()
        st.reset_rows([1])
        st.check()

    def test_empty_chunk(self, extractor):
        st = iv.StreamingIvector(extractor, device=CPU)
        out = st.process(np.zeros((1, 0, extractor.ubm.dim), np.float32))
        assert out.shape == (1, 0, extractor.ivector_dim)

    def test_rejects_wrong_batch(self, extractor):
        st = iv.StreamingIvector(extractor, batch_size=2, device=CPU)
        with pytest.raises(ValueError):
            st.process(np.zeros((3, 4, extractor.ubm.dim), np.float32))


def test_speaker_from_reference_rejects_unknown_fields():
    with pytest.raises(ValueError, match="speaker model"):
        speaker_from_reference({"weights": np.ones(1), "M": np.ones(1)})
