"""The port's PLDA backend (``tpufeat_torch.plda``) against ``tpufeat.plda``
and the float64 goldens, on the CPU.

Training, the transform, smoothing and adaptation are float64 numpy in
both packages: the port's model equals the reference's to float64
rounding (rtol 1e-9). Scoring runs in fp32 on the device: against the
golden loop at ``tests/test_plda.py``'s atol 5e-3 / rtol 1e-4, and the
float64 host twin at atol 1e-9 / rtol 1e-12. The Kaldi ``<Plda>`` bytes
are equal; the npz files and the Kaldi bytes load in either package; the
trials CLI gives the reference's scores within 1e-4.
"""

import numpy as np
import pytest
import torch

from tpufeat import feats_io as jfeats_io
from tpufeat import plda as jpl

from tpufeat_torch import plda as pl
from tpufeat_torch.config import speaker_from_reference
from tpufeat_torch.reference import cpu as golden

CPU = "cpu"


def _synthetic(seed=0, n_spk=60, n_per=8, dim=12, between_scale=2.0,
               within_scale=1.0):
    """``tests/test_plda.py``'s draws from the two-covariance model."""
    r = np.random.default_rng(seed)
    qb = np.linalg.qr(r.standard_normal((dim, dim)))[0]
    qw = np.linalg.qr(r.standard_normal((dim, dim)))[0]
    eb = between_scale * np.geomspace(1.0, 0.05, dim)
    ew = within_scale * np.geomspace(1.0, 0.3, dim)
    Lb = qb * np.sqrt(eb)
    Lw = qw * np.sqrt(ew)
    mean = r.standard_normal(dim) * 3.0
    spk = r.standard_normal((n_spk, dim)) @ Lb.T
    x = (mean + np.repeat(spk, n_per, axis=0)
         + r.standard_normal((n_spk * n_per, dim)) @ Lw.T)
    return x, np.repeat(np.arange(n_spk), n_per)


def _same_model(a, b, rtol=1e-9):
    for name in ("mean", "transform", "psi"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                   rtol=rtol, atol=1e-12)


@pytest.fixture(scope="module")
def trained():
    x, ids = _synthetic()
    return pl.train_plda(x, ids, iters=8), jpl.train_plda(x, ids, iters=8), \
        x, ids


class TestUtilities:
    def test_length_normalize(self):
        x = np.random.default_rng(0).standard_normal((5, 16))
        for scale in (True, False):
            np.testing.assert_array_equal(
                pl.length_normalize(x, scale_to_sqrt_dim=scale),
                jpl.length_normalize(x, scale_to_sqrt_dim=scale))
        assert (pl.length_normalize(np.zeros((2, 4))) == 0).all()

    def test_ivector_mean(self):
        x = np.random.default_rng(1).standard_normal((7, 3))
        ids = ["a", "b", "a", "c", "b", "a", "c"]
        mine, ref = pl.ivector_mean(x, ids), jpl.ivector_mean(x, ids)
        np.testing.assert_array_equal(mine[0], ref[0])
        np.testing.assert_array_equal(mine[1], ref[1])
        assert mine[2] == ref[2]
        with pytest.raises(ValueError):
            pl.ivector_mean(np.zeros((3, 4)), ["a", "b"])


class TestTraining:
    def test_matches_reference(self, trained):
        mine, ref, *_ = trained
        _same_model(mine, ref)

    def test_objectives_match_reference(self):
        x, ids = _synthetic(seed=3, n_spk=30, n_per=5)
        _, mine = pl.train_plda(x, ids, iters=6, return_objective=True)
        _, ref = jpl.train_plda(x, ids, iters=6, return_objective=True)
        np.testing.assert_allclose(mine, ref, rtol=1e-9)
        assert (np.diff(mine) >= -1e-6 * np.abs(mine[:-1])).all()

    def test_diagonalizes(self, trained):
        model = trained[0]
        Ainv = np.linalg.inv(model.transform)
        np.testing.assert_allclose(
            model.transform @ (Ainv @ Ainv.T) @ model.transform.T,
            np.eye(model.dim), atol=1e-8)

    def test_validation(self):
        x = np.zeros((4, 3))
        with pytest.raises(ValueError, match="2 speakers"):
            pl.train_plda(x, [0, 0, 0, 0])
        with pytest.raises(ValueError, match="labels"):
            pl.train_plda(x, [0, 1])
        with pytest.raises(ValueError, match="iters"):
            pl.train_plda(x, [0, 0, 1, 1], iters=0)
        with pytest.raises(ValueError, match="shapes"):
            pl.Plda(np.zeros(3), np.zeros((3, 2)), np.zeros(3))
        with pytest.raises(ValueError, match="non-negative"):
            pl.Plda(np.zeros(2), np.eye(2), np.array([1.0, -0.5]))


class TestScoring:
    @pytest.mark.parametrize("normalize_length", [True, False])
    def test_vs_golden_and_reference(self, trained, normalize_length):
        model, ref = trained[:2]
        r = np.random.default_rng(11)
        enroll = r.standard_normal((7, model.dim)) * 2.0
        test = r.standard_normal((9, model.dim)) * 2.0
        n = np.array([1, 2, 3, 5, 10, 1, 4])
        got = model.score(enroll, test, n_enroll=n,
                          normalize_length=normalize_length,
                          device=CPU).numpy()
        want = golden.plda_log_likelihood_ratio(
            model.mean, model.transform, model.psi, enroll, n, test,
            normalize_length=normalize_length)
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-4)
        np.testing.assert_allclose(
            got, np.asarray(ref.score(enroll, test, n_enroll=n,
                                      normalize_length=normalize_length)),
            atol=5e-3, rtol=1e-4)

    def test_score_host_vs_golden(self, trained):
        model = trained[0]
        r = np.random.default_rng(13)
        enroll = r.standard_normal((6, model.dim)) * 2.0
        test = r.standard_normal((11, model.dim)) * 2.0
        n = np.array([1, 2, 3, 5, 8, 13])
        for nl in (True, False):
            got = model.score_host(enroll, test, n_enroll=n,
                                   normalize_length=nl)
            want = golden.plda_log_likelihood_ratio(
                model.mean, model.transform, model.psi, enroll, n, test,
                normalize_length=nl)
            np.testing.assert_allclose(got, want, atol=1e-9, rtol=1e-12)
        with pytest.raises(ValueError, match="n_enroll"):
            model.score_host(enroll, test, n_enroll=0)

    def test_separates_speakers(self, trained):
        model = trained[0]
        x, ids = _synthetic(seed=99, n_spk=20, n_per=6)
        means, counts, spks = pl.ivector_mean(x[::2], ids[::2])
        scores = model.score(means, x[1::2], n_enroll=counts,
                             device=CPU).numpy()
        lab = np.asarray(spks)[:, None] == ids[1::2][None, :]
        auc = (scores[lab][:, None] > scores[~lab][None, :]).mean()
        assert auc > 0.8, auc

    def test_validates(self, trained):
        model = trained[0]
        with pytest.raises(ValueError, match="n_enroll"):
            model.log_likelihood_ratio(np.zeros((2, model.dim)),
                                       np.zeros((2, model.dim)),
                                       n_enroll=0, device=CPU)
        with pytest.raises(ValueError, match="want"):
            model.log_likelihood_ratio(np.zeros((2, 3)),
                                       np.zeros((2, model.dim + 1)),
                                       device=CPU)

    def test_products_keep_fp32(self, trained, monkeypatch):
        """The scores do not move with the caller's TF32 setting."""
        model = trained[0]
        r = np.random.default_rng(14)
        e, t = r.standard_normal((4, model.dim)), r.standard_normal(
            (5, model.dim))
        base = model.score(e, t, device=CPU)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        assert torch.equal(model.score(e, t, device=CPU), base)


class TestModelEdits:
    def test_smoothing_matches_reference(self, trained):
        model, ref = trained[:2]
        _same_model(model.smooth_within_class_covariance(0.1),
                    ref.smooth_within_class_covariance(0.1))
        with pytest.raises(ValueError):
            model.smooth_within_class_covariance(-0.1)

    def test_adapt_matches_reference(self, trained):
        model, ref, x = trained[:3]
        shifted = x[:200] * 1.3 + 0.5
        _same_model(model.adapt(shifted), ref.adapt(shifted), rtol=1e-8)
        with pytest.raises(ValueError, match=">= 2"):
            model.adapt(np.zeros((1, model.dim)))


class TestPersistence:
    def test_kaldi_bytes_equal_and_load_both_ways(self, trained, tmp_path):
        model = trained[0]
        ref = jpl.Plda(model.mean, model.transform, model.psi)
        data = model.to_kaldi_bytes()
        assert data == ref.to_kaldi_bytes()
        _same_model(jpl.Plda.from_kaldi_bytes(data), model, rtol=0)
        _same_model(pl.Plda.from_kaldi_bytes(ref.to_kaldi_bytes()), model,
                    rtol=0)
        p = str(tmp_path / "plda.kaldi")
        model.save_kaldi(p)
        _same_model(pl.Plda.load_auto(p), model, rtol=0)

    def test_npz_both_ways(self, trained, tmp_path):
        model, ref = trained[:2]
        p = str(tmp_path / "plda")
        model.save(p)
        _same_model(jpl.Plda.load(p), model, rtol=0)
        ref.save(p)
        _same_model(pl.Plda.load_auto(p), ref, rtol=0)

    def test_speaker_from_reference(self, trained):
        ref = trained[1]
        _same_model(speaker_from_reference(dict(
            mean=ref.mean, transform=ref.transform, psi=ref.psi)), ref,
            rtol=0)

    def test_kaldi_rejects_garbage(self):
        with pytest.raises(ValueError):
            pl.Plda.from_kaldi_bytes(b"\0B<NotPlda> ")
        with pytest.raises(ValueError):
            pl.Plda.from_kaldi_bytes(b"\0B<Plda> DV \x04"
                                     + b"\xff\xff\xff\x7f")


class TestScoringCli:
    def _files(self, trained, tmp_path):
        model, _, x, ids = trained
        means, counts, spks = pl.ivector_mean(x[:30], ids[:30])
        enroll = str(tmp_path / "spk.ark")
        test = str(tmp_path / "utt.ark")
        jfeats_io.write_kaldi_vec_ark(
            enroll, {f"spk{s}": means[i].astype(np.float32)
                     for i, s in enumerate(spks)})
        jfeats_io.write_kaldi_vec_ark(
            test, {f"utt{j}": x[30 + j].astype(np.float32)
                   for j in range(6)})
        trials = tmp_path / "trials"
        trials.write_text("spk0 utt0\nspk0 utt3\nspk1 utt1\nspk2 utt5\n")
        nutts = tmp_path / "num_utts"
        nutts.write_text("".join(f"spk{s} {int(counts[i])}\n"
                                 for i, s in enumerate(spks)))
        plda = str(tmp_path / "plda.npz")
        model.save(plda)
        return [str(trials), "--plda", plda, "--enroll", enroll,
                "--test", test, "--num-utts", str(nutts)]

    def test_trials_match_reference(self, trained, tmp_path):
        args = self._files(trained, tmp_path)
        mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
        assert pl.main([args[0], mine] + args[1:] + ["--device", CPU]) == 0
        assert jpl.main([args[0], ref] + args[1:]) == 0
        a = [ln.split() for ln in open(mine).read().strip().split("\n")]
        b = [ln.split() for ln in open(ref).read().strip().split("\n")]
        assert [x[:2] for x in a] == [x[:2] for x in b] and len(a) == 4
        np.testing.assert_allclose([float(x[2]) for x in a],
                                   [float(x[2]) for x in b], atol=1e-4)

    def test_cli_validates(self, trained, tmp_path):
        args = self._files(trained, tmp_path)
        bad = tmp_path / "bad"
        bad.write_text("spkX utt1\n")
        with pytest.raises(ValueError, match="speaker"):
            pl.main([str(bad), "-"] + args[1:] + ["--device", CPU])
        bad.write_text("spk0\n")
        with pytest.raises(ValueError, match="want"):
            pl.main([str(bad), "-"] + args[1:] + ["--device", CPU])
        bad.write_text("\n")
        out = str(tmp_path / "empty")
        assert pl.main([str(bad), out] + args[1:] + ["--device", CPU]) == 0
        assert open(out).read() == ""
