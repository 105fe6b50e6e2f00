"""The port's diarization (``tpufeat_torch.diarization``) against
``tpufeat.diarization``, on the CPU, on ``tests/test_diarize.py``'s
fixture (a UBM, an extractor and a PLDA trained by the reference on a
12-speaker synthetic population, carried across by
``config.speaker_from_reference``).

Tolerances:
- segment i-vectors against the per-window ``utterance_ivector`` and
  against the reference's: atol 2e-4 / rtol 1e-4 (3e-4 bucketed), the
  reference's own; the streaming diarizer's window i-vectors against the
  offline segments: 5e-4;
- the grid, the clustering of one affinity, the RTTM text: equal;
- labels on the reference's fixtures (``diarize``, ``refine_labels``,
  ``two_stage_cluster``, ``diarize_long``, the streaming diarizer and the
  CLI): equal to the reference's.

The ``two_stage_cluster`` guard is the port's: with fewer than 4 blocks
it clusters single-stage, where the reference runs the two stages.
"""

import json

import numpy as np
import pytest

from tpufeat import diarization as jdz
from tpufeat import ivector as jiv
from tpufeat import plda as jpl

from tpufeat_torch import diarization as dz
from tpufeat_torch import ivector as iv
from tpufeat_torch.config import speaker_from_reference

CPU = "cpu"


def _speakers_fixture(seed=0, dim=8, n_spk=12):
    """``tests/test_diarize.py``'s fixture: the reference's models and the
    port's copies of them, and the draw function."""
    r = np.random.default_rng(seed)
    offs = r.standard_normal((n_spk, dim)) * 3.0

    def draw(spk, n, s):
        rr = np.random.default_rng(s)
        return (offs[spk] + rr.standard_normal((n, dim))).astype(np.float32)

    frames = np.concatenate([draw(s, 200, 100 + s) for s in range(n_spk)])
    ubm = jiv.train_diag_ubm(frames, 8, iters=2, final_iters=3, seed=0)
    utts = [draw(s, 150, 200 + 10 * s + u) for s in range(n_spk)
            for u in range(6)]
    ids = [s for s in range(n_spk) for _ in range(6)]
    jext = jiv.train_ivector_extractor(ubm, utts, ivector_dim=8, iters=4,
                                       seed=1)
    ivs = np.stack([np.asarray(jiv.utterance_ivector(jext, u), np.float64)
                    for u in utts])
    jmodel = jpl.train_plda(ivs, ids, iters=6)
    ext = speaker_from_reference(dict(
        weights=jext.ubm.weights, means=jext.ubm.means, vars=jext.ubm.vars,
        M=jext.M))
    model = speaker_from_reference(dict(
        mean=jmodel.mean, transform=jmodel.transform, psi=jmodel.psi))
    return ext, model, jext, jmodel, draw


@pytest.fixture(scope="module")
def spk():
    return _speakers_fixture()


def _alternating(draw, plan, seed0=700):
    feats = np.concatenate([draw(s, n, seed0 + i)
                            for i, (s, n) in enumerate(plan)])
    return feats, np.concatenate([np.full(n, s) for s, n in plan])


def _purity(labels, truth):
    ok = 0
    for lab in set(labels[labels >= 0]):
        _, counts = np.unique(truth[labels == lab], return_counts=True)
        ok += counts.max()
    return ok / len(truth)


@pytest.mark.parametrize("args", [
    (300, 150, 75, 25), (310, 150, 75, 25), (310, 150, 75, 100),
    (40, 150, 75, 25), (10, 150, 75, 25), (1000, 100, 50, 25)])
def test_sliding_windows_match_reference(args):
    T, window, period, min_window = args
    np.testing.assert_array_equal(
        dz.sliding_windows(T, window=window, period=period,
                           min_window=min_window),
        jdz.sliding_windows(T, window=window, period=period,
                            min_window=min_window))


def test_sliding_windows_validate():
    with pytest.raises(ValueError, match="multiple"):
        dz.sliding_windows(100, window=100, period=33)
    with pytest.raises(ValueError, match=">= 1"):
        dz.sliding_windows(0)


class TestSegmentIvectors:
    @pytest.mark.parametrize("T", [363, 287, 100, 40])
    def test_per_window_oracle_and_reference(self, spk, T):
        ext, _, jext, _, draw = spk
        feats = np.concatenate([draw(0, 200, 1), draw(1, 163, 2)])[:T]
        got, spans = dz.segment_ivectors(ext, feats, window=100, period=50,
                                         min_post=0.0, device=CPU)
        got = got.numpy()
        want, jspans = jdz.segment_ivectors(jext, feats, window=100,
                                            period=50, min_post=0.0)
        np.testing.assert_array_equal(spans, jspans)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-4,
                                   rtol=1e-4)
        for i, (s, e) in enumerate(spans):
            one = iv.utterance_ivector(ext, feats[s:e], device=CPU).numpy()
            np.testing.assert_allclose(got[i], one, atol=2e-4, rtol=1e-4)

    def test_mask_gates_frames(self, spk):
        ext, _, _, _, draw = spk
        feats = draw(0, 200, 4)
        mask = np.ones(200, np.float32)
        mask[100:] = 0.0
        got, spans = dz.segment_ivectors(ext, feats, window=100, period=50,
                                         min_post=0.0, mask=mask,
                                         device=CPU)
        silent = [i for i, (s, e) in enumerate(spans) if s >= 100]
        assert silent
        np.testing.assert_allclose(got.numpy()[silent], 0.0, atol=1e-6)

    @pytest.mark.parametrize("T", [287, 463, 600])
    def test_bucketed_match_reference(self, spk, T):
        ext, _, jext, _, draw = spk
        feats = draw(0, T, 800 + T)
        got, spans = dz.segment_ivectors(ext, feats, window=100, period=50,
                                         min_post=0.0, bucket_frames=True,
                                         device=CPU)
        want, jspans = jdz.segment_ivectors(jext, feats, window=100,
                                            period=50, min_post=0.0,
                                            bucket_frames=True)
        np.testing.assert_array_equal(spans, jspans)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=3e-4, rtol=1e-4)

    def test_validates(self, spk):
        ext, _, _, _, draw = spk
        with pytest.raises(ValueError, match="features"):
            dz.segment_ivectors(ext, np.zeros((10, ext.ubm.dim + 1)),
                                device=CPU)
        with pytest.raises(ValueError, match="mask"):
            dz.segment_ivectors(ext, draw(0, 100, 5), mask=np.ones(99),
                                device=CPU)


class TestClustering:
    def test_same_clusters_as_reference(self):
        r = np.random.default_rng(0)
        aff = r.standard_normal((20, 20))
        aff = aff + aff.T
        for kw in (dict(num_speakers=3), dict(threshold=0.0),
                   dict(threshold=1.0)):
            np.testing.assert_array_equal(dz.cluster_affinity(aff, **kw),
                                          jdz.cluster_affinity(aff, **kw))
        with pytest.raises(ValueError, match="square"):
            dz.cluster_affinity(np.zeros((2, 3)))

    @pytest.mark.parametrize("host", [False, True])
    def test_affinity_matches_reference(self, spk, host):
        ext, model, _, jmodel, draw = spk
        ivecs, _ = dz.segment_ivectors(ext, draw(3, 600, 6), device=CPU)
        got = dz.plda_affinity(model, ivecs, host=host, device=CPU)
        want = jdz.plda_affinity(jmodel, ivecs.numpy(), host=host)
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-4)
        assert got.dtype == np.float32 and (got == got.T).all()


class TestDiarize:
    CASES = {
        "two_known": ([(0, 300), (1, 300), (0, 300), (1, 300)],
                      dict(num_speakers=2)),
        "three_threshold": ([(0, 300), (1, 300), (2, 300), (0, 300),
                             (2, 300)], dict(threshold=0.0)),
        "refine": ([(0, 300), (1, 300)], dict(num_speakers=2,
                                              refine_iters=2)),
        "bucketed": ([(0, 300), (1, 300)], dict(num_speakers=2,
                                                bucket_frames=True)),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_labels_match_reference(self, spk, case):
        ext, model, jext, jmodel, draw = spk
        plan, kw = self.CASES[case]
        feats, truth = _alternating(draw, plan)
        labels, segments = dz.diarize(ext, model, feats, window=150,
                                      period=75, device=CPU, **kw)
        jlabels, jsegments = jdz.diarize(jext, jmodel, feats, window=150,
                                         period=75, **kw)
        np.testing.assert_array_equal(labels, jlabels)
        assert segments == jsegments
        assert _purity(labels, truth) > 0.8

    def test_vad_mask_labels_silence(self, spk):
        ext, model, jext, jmodel, draw = spk
        feats, _ = _alternating(draw, [(0, 300), (1, 300)])
        mask = np.ones(600, np.float32)
        mask[280:320] = 0.0
        labels, segments = dz.diarize(ext, model, feats, num_speakers=2,
                                      mask=mask, device=CPU)
        assert (labels[280:320] == -1).all()
        jlabels, _ = jdz.diarize(jext, jmodel, feats, num_speakers=2,
                                 mask=mask)
        np.testing.assert_array_equal(labels, jlabels)

    def test_refine_labels_fixes_planted_errors(self, spk):
        ext, model, _, jmodel, draw = spk
        feats = np.concatenate([draw(0, 600, 990), draw(1, 600, 991)])
        ivecs, _ = dz.segment_ivectors(ext, feats, device=CPU)
        clean = dz.cluster_affinity(dz.plda_affinity(model, ivecs,
                                                     device=CPU),
                                    num_speakers=2)
        noisy = clean.copy()
        flip = np.random.default_rng(0).choice(len(noisy), 2,
                                               replace=False)
        noisy[flip] = 1 - noisy[flip]
        fixed = dz.refine_labels(model, ivecs, noisy, iters=3)
        np.testing.assert_array_equal(
            fixed, jdz.refine_labels(jmodel, ivecs.numpy(), noisy, iters=3))
        assert max((fixed == clean).mean(), (fixed != clean).mean()) == 1.0
        with pytest.raises(ValueError):
            dz.refine_labels(model, ivecs, noisy, iters=-1)


class TestLongForm:
    def _ivecs(self, spk):
        ext, _, _, _, draw = spk
        plan = [(s % 3, 225) for s in range(12)]     # 3 speakers, 2700 fr
        feats, truth = _alternating(draw, plan, seed0=900)
        ivecs, _ = dz.segment_ivectors(ext, feats, device=CPU)
        return feats, truth, ivecs.numpy().astype(np.float64)

    def test_two_stage_matches_reference_with_many_blocks(self, spk):
        _, model, _, jmodel, _ = spk
        _, _, ivecs = self._ivecs(spk)
        assert -(-len(ivecs) // 8) >= dz.MIN_BLOCKS
        np.testing.assert_array_equal(
            dz.two_stage_cluster(model, ivecs, block=8, num_speakers=3,
                                 device=CPU),
            jdz.two_stage_cluster(jmodel, ivecs, block=8, num_speakers=3))

    @pytest.mark.parametrize("block", [12, 16, 24])
    def test_few_blocks_cluster_single_stage(self, spk, block):
        """The guard: 2-3 blocks give single-stage diarize's labels."""
        ext, model, _, _, _ = spk
        feats, _, ivecs = self._ivecs(spk)
        assert 2 <= -(-len(ivecs) // block) < dz.MIN_BLOCKS
        two = dz.two_stage_cluster(model, ivecs, block=block,
                                   num_speakers=3, device=CPU)
        single = dz.cluster_affinity(
            dz.plda_affinity(model, ivecs, device=CPU), num_speakers=3)
        np.testing.assert_array_equal(two, single)
        labels, _ = dz.diarize(ext, model, feats, num_speakers=3,
                               device=CPU)
        spans = dz.sliding_windows(len(feats))
        frame_two = two[dz._nearest_sorted(spans.mean(axis=1),
                                           np.arange(len(feats)))]
        np.testing.assert_array_equal(frame_two, labels)

    def test_diarize_long_matches_reference(self, spk):
        ext, model, jext, jmodel, _ = spk
        feats, truth, _ = self._ivecs(spk)
        labels, segments = dz.diarize_long(ext, model, feats,
                                           num_speakers=3, block=8,
                                           device=CPU)
        jlabels, jsegments = jdz.diarize_long(jext, jmodel, feats,
                                              num_speakers=3, block=8)
        np.testing.assert_array_equal(labels, jlabels)
        assert segments == jsegments and _purity(labels, truth) > 0.75

    def test_validation(self, spk):
        _, model, _, _, _ = spk
        with pytest.raises(ValueError, match="block"):
            dz.two_stage_cluster(model, np.zeros((4, model.dim)), block=1)
        feats, _, ivecs = self._ivecs(spk)
        one = np.repeat(ivecs[:1], 40, axis=0)
        with pytest.raises(ValueError, match="fragments"):
            dz.two_stage_cluster(model, one, block=8, num_speakers=10)


def generator_world(n_spk=8, G=16, K=10, D=13, P=32):
    """``benchmarks/experiments/diarize_long_bench.py``'s world, reduced:
    32 acoustic states shared by every speaker in a 13-dim space plus a
    small per-speaker shift of every state, the UBM, extractor and PLDA
    trained by the reference's EM as the generator trains them (fewer
    speakers, G and K cut from 24, 512 and 100), and the port's copies;
    the recording draws 6 of the speakers in 3-15 s turns."""
    r = np.random.default_rng(0)
    phones = r.standard_normal((P, D)) * 4.0
    offs = r.standard_normal((n_spk, D)) * 1.0

    def draw(spk, n, s):
        rr = np.random.default_rng(s)
        z = rr.integers(0, P, n)
        return (phones[z] + offs[spk]
                + 0.8 * rr.standard_normal((n, D))).astype(np.float32)

    frames = np.concatenate([draw(s, 1000, 100 + s) for s in range(n_spk)])
    ubm = jiv.train_diag_ubm(frames, G, iters=2, final_iters=3, seed=0)
    utts = [draw(s, 150, 200 + 10 * s + u) for s in range(n_spk)
            for u in range(12)]
    ids = [s for s in range(n_spk) for _ in range(12)]
    jext = jiv.train_ivector_extractor(ubm, utts, ivector_dim=K, iters=3,
                                       seed=1)
    ivs = np.stack([np.asarray(jiv.utterance_ivector(jext, u), np.float64)
                    for u in utts])
    jmodel = jpl.train_plda(ivs, ids, iters=5)
    ext = speaker_from_reference(dict(
        weights=jext.ubm.weights, means=jext.ubm.means, vars=jext.ubm.vars,
        M=jext.M))
    model = speaker_from_reference(dict(
        mean=jmodel.mean, transform=jmodel.transform, psi=jmodel.psi))
    return ext, model, jext, jmodel, draw


def generator_recording(draw, frames, speakers=6, seed=7):
    """The generator's recording: turns of 300-1500 frames, each by one of
    the first ``speakers`` speakers (seeded) -> (feats, truth)."""
    rr = np.random.default_rng(seed)
    parts, truth, t, i = [], [], 0, 0
    while t < frames:
        s = int(rr.integers(0, speakers))
        n = min(int(rr.integers(300, 1500)), frames - t)
        parts.append(draw(s, n, 5000 + i))
        truth.append(np.full(n, s))
        t, i = t + n, i + 1
    return np.concatenate(parts), np.concatenate(truth)


class TestGeneratorWorld:
    """``diarize_long`` on the reference's seeded long-form world (ROADMAP
    queue 3, item 2): the port's labels are the reference's, with enough
    windows for ``two_stage_cluster``'s two stages."""

    def test_diarize_long_matches_reference(self):
        ext, model, jext, jmodel, draw = generator_world()
        feats, truth = generator_recording(draw, 15000)
        block = 16
        n_windows = len(dz.sliding_windows(len(feats)))
        assert -(-n_windows // block) >= dz.MIN_BLOCKS
        labels, segments = dz.diarize_long(ext, model, feats,
                                           num_speakers=6, block=block,
                                           device=CPU)
        jlabels, jsegments = jdz.diarize_long(jext, jmodel, feats,
                                              num_speakers=6, block=block)
        np.testing.assert_array_equal(labels, jlabels)
        assert segments == jsegments
        assert _purity(labels, truth) > 0.5


class TestStreamingDiarizer:
    @staticmethod
    def _run(sd, feats, plan):
        labs, pos = [], 0
        for c in plan:
            out, start = sd.process(feats[pos: pos + c])
            assert start == sum(len(x) for x in labs)
            labs.append(out)
            pos += c
        out, start = sd.flush()
        assert start == sum(len(x) for x in labs)
        labs.append(out)
        got = np.concatenate(labs)
        assert got.shape == (feats.shape[0],)
        return got

    def test_labels_match_reference(self, spk):
        ext, model, jext, jmodel, draw = spk
        rr = np.random.default_rng(4)
        parts = [draw(int(rr.integers(0, 6)), int(rr.integers(150, 500)),
                     7000 + i) for i in range(10)]
        feats = np.concatenate(parts)
        plan = [500] * (len(feats) // 500) + [len(feats) % 500]
        mine = dz.StreamingDiarizer(ext, model, max_speakers=6, device=CPU)
        ref = jdz.StreamingDiarizer(jext, jmodel, max_speakers=6)
        np.testing.assert_array_equal(self._run(mine, feats, plan),
                                      self._run(ref, feats, plan))
        assert mine.num_speakers == ref.num_speakers

    def test_chunk_plan_invariant(self, spk):
        ext, model, _, _, draw = spk
        feats = np.concatenate([draw(0, 300, 930), draw(2, 300, 931)])
        outs = [self._run(dz.StreamingDiarizer(ext, model, device=CPU),
                          feats, plan)
                for plan in ([600], [75] * 8, [37, 113, 225, 150, 75],
                             [1] * 10 + [590])]
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])

    def test_window_ivectors_match_offline_segments(self, spk):
        ext, model, _, _, draw = spk
        feats = np.concatenate([draw(0, 400, 970), draw(1, 350, 971)])
        sd = dz.StreamingDiarizer(ext, model, device=CPU)
        pos = 0
        for c in [130, 260, 80, 280]:
            sd.process(feats[pos: pos + c])
            pos += c
        ivs, spans = dz.segment_ivectors(ext, feats, device=CPU)
        full = (spans[:, 1] - spans[:, 0]) == 150
        np.testing.assert_allclose(np.stack(sd._wivs),
                                   ivs.numpy().astype(np.float64)[full],
                                   rtol=0, atol=5e-4)

    def test_lifecycle(self, spk):
        ext, model, _, _, draw = spk
        sd = dz.StreamingDiarizer(ext, model, window=150, period=75,
                                  device=CPU)
        sd.process(draw(0, 160, 983))
        a, _ = sd.flush()
        assert abs(sd._centers[-1] - 117.5) < 1e-9, sd._centers
        b, start = sd.flush()
        assert b.size == 0 and start == 160
        with pytest.raises(RuntimeError, match="flushed"):
            sd.process(draw(0, 10, 981))
        sd.reset()
        out, start = sd.process(draw(1, 40, 950))
        assert out.size == 0
        out, start = sd.flush()
        assert start == 0 and out.shape == (40,) and (out == out[0]).all()
        with pytest.raises(ValueError, match="multiple"):
            dz.StreamingDiarizer(ext, model, window=100, period=33,
                                 device=CPU)
        with pytest.raises(ValueError, match="expected"):
            dz.StreamingDiarizer(ext, model, device=CPU).process(
                np.zeros((5, ext.ubm.dim + 2)))


class TestRttmAndCli:
    def test_write_rttm_matches_reference(self, tmp_path):
        segs = [(0, 100, 0), (100, 250, 1), (250, 263, 0)]
        dz.write_rttm(str(tmp_path / "a"), "rec1", segs)
        jdz.write_rttm(str(tmp_path / "b"), "rec1", segs)
        assert open(tmp_path / "a").read() == open(tmp_path / "b").read()

    @pytest.fixture(scope="class")
    def models(self, tmp_path_factory):
        """A throwaway 13-dim stack trained by the reference on a WAV's own
        features, saved as npz (``tests/test_diarize.py``'s CLI case)."""
        from tpufeat import features as jfeatures
        from tpufeat import io as jio
        from tpufeat.config import MFCC13_HTK
        d = tmp_path_factory.mktemp("cli")
        rng = np.random.default_rng(0)
        wav = str(d / "rec.wav")
        jio.write_wav(wav, (rng.standard_normal(48000) * 0.1).astype(
            np.float32), 16000)
        x, _ = jio.read_wav(wav)
        feats = np.asarray(jfeatures.extract(x, cfg=MFCC13_HTK).features)
        ubm = jiv.train_diag_ubm(feats, 2, iters=1, final_iters=2, seed=0)
        ext = jiv.train_ivector_extractor(ubm, [feats[:150], feats[150:]],
                                          ivector_dim=4, iters=2, seed=0)
        r = np.random.default_rng(1)
        ivs = np.concatenate([r.standard_normal((8, 4)) + off
                              for off in (-2.0, 2.0)])
        model = jpl.train_plda(ivs, [0] * 8 + [1] * 8, iters=3)
        ext.save(str(d / "ext.npz"))
        model.save(str(d / "plda.npz"))
        model.save_kaldi(str(d / "plda.kaldi"))
        return d, wav

    @pytest.mark.parametrize("extra", [[], ["--vad-db", "40"],
                                       ["--long", "--block", "4"]],
                             ids=["plain", "vad", "long"])
    def test_cli_matches_reference(self, models, tmp_path, capsys, extra):
        d, wav = models
        common = ["--extractor", str(d / "ext.npz"), "--plda",
                  str(d / "plda.kaldi"), "--num-speakers", "2"] + extra
        mine, ref = str(tmp_path / "mine.rttm"), str(tmp_path / "ref.rttm")
        assert dz.main([wav, mine] + common + ["--device", CPU]) == 0
        info = json.loads(capsys.readouterr().err.strip().split("\n")[-1])
        assert info["recording"] == "rec"
        assert jdz.main([wav, ref] + common) == 0
        assert open(mine).read() == open(ref).read()

    def test_cli_directory_and_validation(self, models, tmp_path):
        d, wav = models
        import shutil
        wavs = tmp_path / "wavs"
        wavs.mkdir()
        for name in ("r0.wav", "r1.wav"):
            shutil.copy(wav, wavs / name)
        out = str(tmp_path / "all.rttm")
        assert dz.main([str(wavs), out, "--extractor", str(d / "ext.npz"),
                        "--plda", str(d / "plda.npz"), "--num-speakers",
                        "1", "--device", CPU]) == 0
        assert {ln.split()[1] for ln in open(out)} == {"r0", "r1"}
        with pytest.raises(ValueError, match="UBM dim"):
            dz.main([wav, "-", "--extractor", str(d / "ext.npz"),
                     "--plda", str(d / "plda.npz"), "--preset", "whisper80",
                     "--device", CPU])
