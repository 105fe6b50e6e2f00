"""The port's host tools against the reference's: ``tpufeat_torch.data``
against ``tpufeat.data``, the CLI (``tpufeat_torch.cli.main``) against
``tpufeat.cli.main`` and the corpus pipeline
(``tpufeat_torch.pipeline.extract_corpus`` / ``main``) against
``tpufeat.pipeline``, on WAV directories written by
``tpufeat_torch.io.write_wav`` into ``tmp_path``; and the three defects of
the reference's corpus pipeline that the port does not copy.

Tolerances: outputs of the same config on the plain path, <= 1e-4 scaled
by max(1, |want|.max()) (the same f32 arithmetic in another order); corpus
statistics, LDA transforms and batching helpers, exact or float64
rounding. Everything runs on the CPU (``--device cpu``).
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from tpufeat import cli as jcli
from tpufeat import data as jdata
from tpufeat import feats_io as jfeats_io
from tpufeat import pipeline as jpipeline
from tpufeat.config import PRESETS as JPRESETS

from tpufeat_torch import cli, data, feats_io, io, pipeline
from tpufeat_torch.config import KALDI39, MFCC13_HTK, PRESETS

TOL = 1e-4


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if got.size == 0:
        return 0.0
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _wav_dir(root, lengths, seed=0, sub=None):
    """PCM16 WAVs of noise and a tone at the given lengths; returns the
    paths in sorted order."""
    rng = np.random.default_rng(seed)
    d = os.path.join(str(root), sub) if sub else str(root)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t) \
            + 0.05 * rng.standard_normal(n)
        p = os.path.join(d, f"u{i:02d}.wav")
        io.write_wav(p, x.astype(np.float32), 16000)
        paths.append(p)
    return sorted(paths)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_batching_helpers_match_reference(tmp_path):
    rng = np.random.default_rng(1)
    sigs = [rng.standard_normal(n).astype(np.float32)
            for n in (16000, 9000, 31000, 16001, 4000, 23000)]
    for n in (100, 16000, 16001, 22627, 22628, 500000):
        assert data.bucket_length(n) == jdata.bucket_length(n)
    for got, want in zip(data.pad_batch(sigs), jdata.pad_batch(sigs)):
        np.testing.assert_array_equal(got, want)
    for bucket in (False, True):
        got = list(data.batched(sigs, 2, bucket=bucket))
        want = list(jdata.batched(sigs, 2, bucket=bucket))
        assert len(got) == len(want)
        for (gx, gl), (wx, wl) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gl, wl)
    paths = _wav_dir(tmp_path, [8000, 4000, 6000], sub="a")
    got = list(data.iter_wav_dir(str(tmp_path)))
    want = list(jdata.iter_wav_dir(str(tmp_path)))
    assert [g[0] for g in got] == [w[0] for w in want] == paths
    for (_, gs, gr), (_, ws, wr) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        assert gr == wr == 16000


def test_frame_transforms_match_reference():
    rng = np.random.default_rng(2)
    feat = rng.standard_normal((2, 11, 4)).astype(np.float32)
    nf = np.array([11, 6])
    t = torch.from_numpy(feat)
    np.testing.assert_array_equal(
        data.splice_frames(t, torch.from_numpy(nf), 2, 3).numpy(),
        np.asarray(jdata.splice_frames(feat, nf, 2, 3)))
    out, counts = data.paste_feats([t, t[..., :2]], [nf, nf])
    want, wcounts = jdata.paste_feats([feat, feat[..., :2]], [nf, nf])
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(counts.numpy(), wcounts)
    with pytest.raises(ValueError, match="frame counts"):
        data.paste_feats([t, t], [nf, nf + 1])
    with pytest.raises(ValueError, match="disagree"):
        data.paste_feats([t, t[:, :5]])
    for factor, offset in ((1, 0), (3, 0), (3, 2)):
        got, gnf = data.subsample_frames(t, torch.from_numpy(nf), factor,
                                         offset)
        want, wnf = jdata.subsample_frames(feat, nf, factor, offset)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gnf.numpy(), wnf)
    for cols in (4, 5):                      # linear, affine
        mat = rng.standard_normal((3, cols)).astype(np.float32)
        got = data.apply_transform(t, mat).numpy()
        want = np.asarray(jdata.apply_transform(feat, mat))
        assert _scaled(got, want) <= 1e-6
    with pytest.raises(ValueError, match="transform"):
        data.apply_transform(t, np.zeros((3, 7)))


def test_lda_estimate_matches_reference():
    """LdaStats has no file form: the same accumulated features give the
    same transform."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((400, 6)) + np.repeat(
        rng.standard_normal((4, 6)) * 3, 100, axis=0)
    labels = np.repeat(np.arange(4), 100)
    port, ref = data.LdaStats(6), jdata.LdaStats(6)
    for lo in (0, 150):
        port.accumulate(torch.from_numpy(feats[lo:lo + 250]),
                        torch.from_numpy(labels[lo:lo + 250]))
        ref.accumulate(feats[lo:lo + 250], labels[lo:lo + 250])
    np.testing.assert_allclose(port.estimate(3), ref.estimate(3), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("ext", [".ark", ".npz"])
def test_cmvn_stats_files_cross_load(tmp_path, ext):
    rng = np.random.default_rng(4)
    ref, port = jdata.CmvnStats(5), data.CmvnStats(5)
    for _ in range(3):
        f = rng.standard_normal((40, 5)) * 2 + 1
        ref.accumulate(f)
        port.accumulate(torch.from_numpy(f))
    ref.save(str(tmp_path / f"ref{ext}"))
    port.save(str(tmp_path / f"port{ext}"))
    for loaded in (data.CmvnStats.load(str(tmp_path / f"ref{ext}")),
                   jdata.CmvnStats.load(str(tmp_path / f"port{ext}"))):
        assert loaded.count == ref.count
        np.testing.assert_array_equal(loaded.sum, ref.sum)
        np.testing.assert_array_equal(loaded.sumsq, ref.sumsq)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        data.CmvnStats.load(str(tmp_path / f"ref{ext}")).apply(x, True),
        ref.apply(x, True))
    merged = data.CmvnStats(5).merge(port).merge(port)
    assert merged.count == 2 * port.count


# ---------------------------------------------------------------------------
# cli
# ---------------------------------------------------------------------------

@pytest.fixture
def wavs(tmp_path):
    return _wav_dir(tmp_path / "in", [16000, 9000])


@pytest.mark.parametrize("preset,ext,extra", [
    ("mfcc13", ".npy", []), ("whisper80", ".npz", []),
    ("kaldi39", ".ark", []), ("mfcc13", ".htk", []),
    ("plp13", ".htk", ["--htk-compress"]), ("fbank80", ".npz",
                                            ["--set", "n_mels=40"]),
    ("mfcc13", ".npz", ["--stream", "1600"]),
], ids=["npy", "npz", "ark", "htk", "htk_plp_compressed", "set",
        "stream"])
def test_cli_matches_reference(wavs, tmp_path, preset, ext, extra):
    ins = wavs[:1] if ext == ".npy" else wavs
    outs = {}
    for name, main in (("port", cli.main), ("reference", jcli.main)):
        out = str(tmp_path / f"{name}{ext}")
        argv = [*ins, out, "--preset", preset, *extra]
        assert main(argv + (["--device", "cpu"] if name == "port"
                            else [])) == 0
        outs[name] = out
    if ext == ".npy":
        assert _scaled(np.load(outs["port"]), np.load(outs["reference"])) \
            <= TOL
    elif ext == ".npz":
        with np.load(outs["port"]) as g, np.load(outs["reference"]) as w:
            np.testing.assert_array_equal(g["mask"], w["mask"])
            np.testing.assert_array_equal(g["lengths"], w["lengths"])
            m = w["mask"]
            assert _scaled(g["features"][m], w["features"][m]) <= TOL
    elif ext == ".ark":
        got = feats_io.read_kaldi_ark(outs["port"])
        want = jfeats_io.read_kaldi_ark(outs["reference"])
        assert list(got) == list(want) == ["u00", "u01"]
        for k in got:
            assert _scaled(got[k], want[k]) <= TOL
    else:
        for b in range(len(ins)):
            p = [outs["port"].replace(ext, f".{b}{ext}"),
                 outs["reference"].replace(ext, f".{b}{ext}")]
            (gf, gs, gk), (wf, ws, wk) = (feats_io.read_htk(q) for q in p)
            assert (gs, gk) == (ws, wk)
            tol = TOL if "--htk-compress" not in extra else \
                2 * (np.ptp(wf, axis=0).max() / 65534 + TOL)
            assert _scaled(gf, wf) <= tol


def test_cli_validate_time_and_profile(wavs, tmp_path, capsys):
    prof = str(tmp_path / "prof")
    assert cli.main([*wavs, str(tmp_path / "o.npz"), "--device", "cpu",
                     "--validate", "--time", "--profile", prof]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    import json
    timing, valid = json.loads(lines[-2]), json.loads(lines[-1])
    assert timing["rtfx"] > 0 and timing["device"] == "cpu"
    assert valid["max_abs_err"]["numpy_f64"] < 1e-3
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0


def test_cli_refusals(wavs, tmp_path, monkeypatch):
    out = str(tmp_path / "o.npy")
    w8 = str(tmp_path / "a8k.wav")
    io.write_wav(w8, np.zeros(8000, np.float32), 8000)
    with pytest.raises(SystemExit, match="--resample"):
        cli.main([w8, out, "--device", "cpu"])
    for ext in (".htk", ".npy"):
        with pytest.raises(SystemExit, match="pitch"):
            cli.main([wavs[0], str(tmp_path / f"p{ext}"), "--pitch",
                      "--device", "cpu"] + (["--validate"] if ext == ".npy"
                                            else []))
    with pytest.raises(SystemExit, match="unknown config field"):
        cli.main([wavs[0], out, "--set", "nope=1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main([wavs[0], out])
    assert not os.path.exists(out)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

@pytest.fixture
def corpus(tmp_path):
    """Seven PCM16 files over three length buckets, one in a subdir."""
    root = tmp_path / "corpus"
    paths = _wav_dir(root, [16000, 9000, 20000, 12000, 30000, 4000],
                     seed=5)
    paths += _wav_dir(root, [17000], seed=6, sub="sub")
    return str(root), sorted(paths)


def test_extract_corpus_matches_reference(corpus):
    root, paths = corpus
    cfg = KALDI39
    stats = {}
    got = dict(pipeline.extract_corpus(root, cfg, batch_size=2, stats=stats,
                                       device="cpu"))
    want = dict(jpipeline.extract_corpus(root, JPRESETS["kaldi39"],
                                         batch_size=2))
    assert sorted(got) == sorted(want) == paths
    for k in got:
        assert _scaled(got[k], want[k]) <= TOL
    assert stats["files"] == 7 and stats["batches"] >= 4
    assert stats["n_shapes"] >= 3 and 0 < stats["padding_waste"] < 1
    assert stats["decode_s"] > 0


def test_extract_corpus_matches_per_utterance_extract(corpus):
    from tpufeat_torch import features
    root, _ = corpus
    for key, feats in pipeline.extract_corpus(root, MFCC13_HTK,
                                              batch_size=3, device="cpu"):
        x, _ = io.read_wav(key)
        want = features.extract(x, cfg=MFCC13_HTK, device="cpu").features
        assert _scaled(feats, want) <= 1e-6


def test_pipeline_main_ark_matches_reference(corpus, tmp_path, capsys):
    root, _ = corpus
    outs = {}
    for name, main in (("port", pipeline.main), ("reference",
                                                 jpipeline.main)):
        out = str(tmp_path / f"{name}.ark")
        argv = [root, out, "--preset", "mfcc13", "--batch", "4"]
        assert main(argv + (["--device", "cpu"] if name == "port"
                            else [])) == 0
        outs[name] = feats_io.read_kaldi_ark(out)
        assert os.path.exists(out[:-4] + ".scp")
    assert list(outs["port"]) == list(outs["reference"])
    for k in outs["port"]:
        assert _scaled(outs["port"][k], outs["reference"][k]) <= TOL


def test_pipeline_segments_and_utt2spk_cmvn(corpus, tmp_path):
    """Per-segment features keyed by utterance, and per-speaker CMVN stats
    written and applied, as the reference does."""
    root, _ = corpus
    seg = tmp_path / "segments"
    seg.write_text("s1 u00 0.0 0.5\ns2 u00 0.25 1.0\ns3 sub/u00 0.1 1.0\n")
    u2s = tmp_path / "utt2spk"
    u2s.write_text("s1 A\ns2 B\ns3 A\n")
    got = {}
    for name, main in (("port", pipeline.main), ("reference",
                                                 jpipeline.main)):
        stats = str(tmp_path / f"{name}_cmvn.ark")
        out = str(tmp_path / f"{name}.ark")
        common = [root, "--segments", str(seg), "--utt2spk", str(u2s),
                  "--preset", "mfcc13"]
        dev = ["--device", "cpu"] if name == "port" else []
        assert main([common[0], str(tmp_path / f"{name}_x.npz"),
                     *common[1:], "--global-cmvn", stats, *dev]) == 0
        assert main([common[0], out, *common[1:], "--apply-cmvn", stats,
                     "--norm-vars", *dev]) == 0
        got[name] = (feats_io.read_kaldi_ark(out),
                     feats_io.read_kaldi_ark(stats))
    (pf, ps), (rf, rs) = got["port"], got["reference"]
    assert sorted(pf) == sorted(rf) == ["s1", "s2", "s3"]
    for k in pf:
        assert _scaled(pf[k], rf[k]) <= 1e-3      # after var normalization
    assert sorted(ps) == sorted(rs) == ["A", "B"]
    for k in ps:
        assert _scaled(ps[k], rs[k]) <= TOL



@pytest.fixture
def speaker_models(corpus, tmp_path):
    """A UBM (G=4) and an extractor (K=3) the reference trains on the
    corpus' mfcc13 features, saved as npz, and an utt2spk of two
    speakers."""
    from tpufeat import ivector as jiv
    root, _ = corpus
    feats = [f for _, f in jpipeline.extract_corpus(root,
                                                     JPRESETS["mfcc13"])]
    ubm = jiv.train_diag_ubm(np.concatenate(feats), 4, iters=2,
                             final_iters=3, seed=0)
    ext = jiv.train_ivector_extractor(ubm, feats, ivector_dim=3, iters=2,
                                      seed=1)
    ubm.save(str(tmp_path / "ubm.npz"))
    ext.save(str(tmp_path / "ext.npz"))
    u2s = tmp_path / "utt2spk"
    u2s.write_text("u00 A\nu01 B\nu02 A\nu03 B\nu04 A\nu05 B\n"
                   "sub/u00 A\n")
    return str(tmp_path / "ubm.npz"), str(tmp_path / "ext.npz"), str(u2s)


def test_pipeline_ivector_and_fmllr_arks(corpus, speaker_models, tmp_path):
    """--ivector-extractor/--ivector-ark and --fmllr-ubm/--fmllr-ark: the
    reference's keys; its i-vectors within 1e-3 (the features agree to
    1e-4, and an estimate magnifies that); transforms whose fMLLR
    objective on the port's statistics of each speaker is the
    reference's transform's to within what the estimator's 20 sweeps
    leave short of 40 (on 340 frames a speaker the optimum is flat and
    slow to reach: f32 statistics 3e-7 apart move the transform by 0.1
    and 20 more sweeps move it by 3, while the objective barely moves);
    and archives byte for byte what the reference's writers make of the
    same vectors."""
    from tpufeat_torch import fmllr, ivector
    root, _ = corpus
    ubm, ext, u2s = speaker_models
    got = {}
    for name, main in (("port", pipeline.main), ("reference",
                                                 jpipeline.main)):
        iv_ark = str(tmp_path / f"{name}_iv.ark")
        fm_ark = str(tmp_path / f"{name}_fmllr.ark")
        argv = [root, str(tmp_path / f"{name}.npz"), "--preset", "mfcc13",
                "--batch", "4", "--utt2spk", u2s,
                "--ivector-extractor", ext, "--ivector-ark", iv_ark,
                "--fmllr-ubm", ubm, "--fmllr-ark", fm_ark,
                "--fmllr-min-count", "100"]
        assert main(argv + (["--device", "cpu"] if name == "port"
                            else [])) == 0
        got[name] = (iv_ark, fm_ark)
    (iv_p, fm_p), (iv_r, fm_r) = got["port"], got["reference"]
    vp, vr = feats_io.read_kaldi_vec_ark(iv_p), feats_io.read_kaldi_vec_ark(
        iv_r)
    assert list(vp) == list(vr) and len(vp) == 7
    for k in vp:
        assert vp[k].dtype == np.float32
        assert _scaled(vp[k], vr[k]) <= 1e-3, k
    tp, tr = feats_io.read_kaldi_ark(fm_p), feats_io.read_kaldi_ark(fm_r)
    assert list(tp) == list(tr) == ["A", "B"]
    feats = np.load(str(tmp_path / "port.npz"))
    spk_of = dict(ln.split() for ln in open(u2s))
    eye = np.concatenate([np.eye(13), np.zeros((13, 1))], axis=1)
    for k in tp:
        assert tp[k].shape == (13, 14)
        stats = fmllr.fmllr_stats(
            ivector.DiagUbm.load(ubm),
            np.concatenate([feats[r] for r in feats.files
                            if spk_of[r[:-4]] == k]), device="cpu")
        q_port, q_ref, q_eye, q20, q40 = (
            fmllr.fmllr_objective(*stats, W) for W in (
                tp[k], tr[k], eye,
                fmllr.estimate_fmllr(*stats, min_count=100, iters=20),
                fmllr.estimate_fmllr(*stats, min_count=100, iters=40)))
        assert abs(q_port - q_ref) <= q40 - q20, k
        assert q_port - q_eye > 10 * (q40 - q20), k
    same_iv, same_fm = str(tmp_path / "iv.ark"), str(tmp_path / "fm.ark")
    jfeats_io.write_kaldi_vec_ark(same_iv, vp, scp_path=same_iv[:-4] + ".scp")
    jfeats_io.write_kaldi_ark(same_fm, tp, scp_path=same_fm[:-4] + ".scp")
    for mine, theirs in ((iv_p, same_iv), (fm_p, same_fm)):
        for ext_ in (".ark", ".scp"):
            a = open(mine[:-4] + ext_, "rb").read()
            b = open(theirs[:-4] + ext_, "rb").read()
            if ext_ == ".scp":      # the same keys at the same offsets
                a = a.replace(mine.encode(), b"")
                b = b.replace(theirs.encode(), b"")
            assert a == b, ext_


def test_extract_corpus_ivectors_match_reference(corpus, speaker_models):
    from tpufeat import ivector as jiv
    from tpufeat_torch import ivector
    root, _ = corpus
    _, ext, _ = speaker_models
    mine, ref = {}, {}
    for _ in pipeline.extract_corpus(root, PRESETS["mfcc13"], batch_size=3,
                                     ivector=ivector.IvectorExtractor.load(
                                         ext),
                                     ivectors=mine, device="cpu"):
        pass
    for _ in jpipeline.extract_corpus(root, JPRESETS["mfcc13"],
                                      batch_size=3,
                                      ivector=jiv.IvectorExtractor.load(ext),
                                      ivectors=ref):
        pass
    assert sorted(mine) == sorted(ref) and len(mine) == 7
    for k in mine:
        assert _scaled(mine[k], ref[k]) <= 1e-3, k
    with pytest.raises(ValueError, match="UBM dim"):
        next(pipeline.extract_corpus(root, KALDI39,
                                     ivector=ivector.IvectorExtractor.load(
                                         ext), ivectors={}, device="cpu"))

def test_pipeline_dither_generator(corpus):
    root, _ = corpus
    cfg = dataclasses.replace(PRESETS["fbank80"], dither=1.0)
    with pytest.raises(ValueError, match="generator"):
        next(pipeline.extract_corpus(root, cfg, device="cpu"))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return dict(pipeline.extract_corpus(root, cfg, batch_size=3,
                                            generator=g, device="cpu"))
    a, b, c = run(1), run(1), run(2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert np.abs(a[k] - c[k]).max() > 1e-3


def test_pipeline_refuses_unported_options(corpus, tmp_path):
    """dp= / --dp run: without a process group one rank, the arks and
    rows those of the plain pass bit for bit, and dither under dp refused
    (as the reference refuses it). The i-vector and fMLLR surface refuses
    only a call that lacks its other half."""
    root, _ = corpus
    plain = dict(pipeline.extract_corpus(root, KALDI39, batch_size=3,
                                         device="cpu"))
    dp = dict(pipeline.extract_corpus(root, KALDI39, batch_size=3,
                                      device="cpu", dp=True))
    assert sorted(dp) == sorted(plain) and len(dp) == 7
    for k in plain:
        np.testing.assert_array_equal(dp[k], plain[k])
    with pytest.raises(ValueError, match="dp=True has no per-batch"):
        next(pipeline.extract_corpus(
            root, dataclasses.replace(KALDI39, dither=1.0), device="cpu",
            dp=True, generator=torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="ivectors= dict"):
        next(pipeline.extract_corpus(root, MFCC13_HTK, device="cpu",
                                     ivector=object()))
    out = str(tmp_path / "o.npz")
    arks = {}
    for name, flags in (("plain", []), ("dp", ["--dp"])):
        arks[name] = str(tmp_path / f"{name}.ark")
        assert pipeline.main([root, arks[name], "--preset", "kaldi39",
                              "--batch", "3", *flags, "--device",
                              "cpu"]) == 0
    with open(arks["plain"], "rb") as a, open(arks["dp"], "rb") as b:
        assert a.read() == b.read()
    for flags, match in ((["--fmllr-ubm", "u.npz"], "--fmllr-ark"),
                         (["--fmllr-ark", "f.ark"], "--fmllr-ubm"),
                         (["--ivector-ark", "i.ark"],
                          "--ivector-extractor")):
        with pytest.raises(ValueError, match=match):
            pipeline.main([root, out, *flags, "--device", "cpu"])


def test_pipeline_rate_mismatch_rejected(tmp_path):
    io.write_wav(str(tmp_path / "a.wav"), np.zeros(8000, np.float32), 8000)
    with pytest.raises(ValueError, match="not at 16000 Hz.*resample=True"):
        list(pipeline.extract_corpus(str(tmp_path), MFCC13_HTK,
                                     device="cpu"))


# ---------------------------------------------------------------------------
# the reference's corpus-pipeline defects, not copied
# ---------------------------------------------------------------------------

def test_pcm16_minimum_round_trips(tmp_path):
    """A file holding PCM16's -32768 (-1.0 exactly) reaches the card
    exactly: its features are those of its samples alone, bit for bit.
    (The reference's int16 compaction refused such arenas, whose check
    took -32768 for out of range; the port uploads the decoded float32
    arena, so no sample value is refused or altered.)"""
    from tpufeat_torch import features
    x = (np.random.default_rng(9).standard_normal(16000) * 0.3
         ).astype(np.float32)
    x[100:140] = -1.0
    io.write_wav(str(tmp_path / "a.wav"), x, 16000)
    samples, _ = io.read_wav(str(tmp_path / "a.wav"))
    assert samples.min() == -1.0
    (_, got), = pipeline.extract_corpus(str(tmp_path), MFCC13_HTK,
                                        device="cpu")
    want = features.extract(samples, cfg=MFCC13_HTK, device="cpu")
    np.testing.assert_array_equal(got, want.features.numpy())
    assert jpipeline._compact_arena(samples[None]).dtype == np.float32


def test_device_time_leaves_out_the_consumer(corpus):
    """device_s times upload, dispatch and the fetch, not the consumer's
    work between items (the reference's timed window held its yields)."""
    root, _ = corpus
    stats = {}
    start = time.perf_counter()
    for _ in pipeline.extract_corpus(root, MFCC13_HTK, batch_size=2,
                                     stats=stats, device="cpu"):
        time.sleep(0.2)                       # 7 items: 1.4 s of consumer
    wall = time.perf_counter() - start
    assert wall >= 1.4
    assert stats["device_s"] < wall - 1.4 + 0.05


def _decode_threads():
    return [t for t in threading.enumerate()
            if t.name == pipeline.DECODE_THREAD and t.is_alive()]


def _held_decode(monkeypatch, release: threading.Event) -> None:
    """Patch the decode so that every batch after the first (the ones the
    decode thread takes) waits for ``release``, up to 10 s: the thread is
    then alive until the test lets it go, however slow the host."""
    real = pipeline._decode_batch
    calls = []

    def held(*a, **kw):
        calls.append(1)
        if len(calls) > 1:
            release.wait(timeout=10)
        return real(*a, **kw)
    monkeypatch.setattr(pipeline, "_decode_batch", held)


def test_no_thread_outlives_an_abandoned_generator(corpus, monkeypatch):
    root, _ = corpus
    release = threading.Event()
    _held_decode(monkeypatch, release)
    gen = pipeline.extract_corpus(root, MFCC13_HTK, batch_size=2,
                                  device="cpu")
    next(gen)                                 # batch 1's thread is held
    assert _decode_threads()
    release.set()
    gen.close()
    assert not _decode_threads()


def test_no_thread_outlives_a_failed_fetch(corpus, monkeypatch):
    root, _ = corpus
    release = threading.Event()
    _held_decode(monkeypatch, release)
    real_rows = pipeline._rows
    alive_at_failure = []

    def boom(*a, **kw):
        if alive_at_failure or not _decode_threads():
            return real_rows(*a, **kw)
        alive_at_failure.append(True)         # the next batch is held
        release.set()
        raise RuntimeError("fetch failed")
    monkeypatch.setattr(pipeline, "_rows", boom)
    with pytest.raises(RuntimeError, match="fetch failed"):
        list(pipeline.extract_corpus(root, MFCC13_HTK, batch_size=2,
                                     device="cpu"))
    assert alive_at_failure
    assert not _decode_threads()


def test_decode_failure_names_the_file(corpus):
    root, paths = corpus
    with open(paths[3], "wb") as f:
        f.write(b"RIFF\x00\x00\x00\x00WAVEjunk")
    with pytest.raises(ValueError, match=os.path.basename(paths[3])):
        list(pipeline.extract_corpus(root, MFCC13_HTK, batch_size=2,
                                     device="cpu"))
    assert not _decode_threads()


# ---------------------------------------------------------------------------
# --resample and --pitch
# ---------------------------------------------------------------------------

def _rate_wav(path, n, rate, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = 0.3 * np.sin(2 * np.pi * 170.0 * t) + 0.05 * rng.standard_normal(n)
    io.write_wav(path, x.astype(np.float32), rate)


@pytest.mark.parametrize("flags", [["--resample"], ["--pitch"],
                                   ["--resample", "--pitch"]],
                         ids=["resample", "pitch", "both"])
def test_cli_resample_and_pitch_match_tpufeat(tmp_path, flags):
    """--resample / --pitch against ``tpufeat.cli`` on the same WAVs:
    the spectral columns within TOL, the pitch columns within 1e-5 abs
    (the same decisions, f32 products in other orders)."""
    rate = 48000 if "--resample" in flags else 16000
    ins = []
    for i, n in enumerate((rate, rate * 3 // 4)):
        ins.append(str(tmp_path / f"u{i}.wav"))
        _rate_wav(ins[-1], n, rate, i)
    got, want = str(tmp_path / "g.npz"), str(tmp_path / "w.npz")
    assert cli.main([*ins, got, "--preset", "kaldi39", "--device", "cpu",
                     *flags]) == 0
    assert jcli.main([*ins, want, "--preset", "kaldi39", *flags]) == 0
    g, w = np.load(got), np.load(want)
    np.testing.assert_array_equal(g["mask"], w["mask"])
    m = g["mask"]
    gf, wf = g["features"][m], w["features"][m]
    assert gf.shape == wf.shape
    assert gf.shape[-1] == (42 if "--pitch" in flags else 39)
    assert _scaled(gf[:, :39], wf[:, :39]) <= TOL
    np.testing.assert_allclose(gf[:, 39:], wf[:, 39:], rtol=0, atol=1e-5)


def test_cli_pitch_columns_are_pitch_features(tmp_path):
    from tpufeat_torch import pitch as pm
    w = str(tmp_path / "a.wav")
    _rate_wav(w, 16000, 16000, 3)
    out = str(tmp_path / "o.npy")
    assert cli.main([w, out, "--pitch", "--device", "cpu"]) == 0
    f = np.load(out)
    x, _ = io.read_wav(w)
    pf, _ = pm.pitch_features(x, cfg=pm.config_for(MFCC13_HTK),
                              device="cpu")
    assert f.shape == (pf.shape[0], 16)
    np.testing.assert_array_equal(f[:, 13:], pf.numpy())


def test_corpus_resample_matches_per_file(tmp_path):
    """8k/16k/48k files in one corpus with resample=True: each output
    equals extract of resampling.resample of its file (a padded row's
    valid prefix resamples as the lone file does: within TOL, the batch's
    products in other shapes); without it, the corpus is refused."""
    from tpufeat_torch import features, resampling
    rates = {"a.wav": 16000, "b.wav": 8000, "c.wav": 48000, "d.wav": 8000,
             "e.wav": 48000}
    for i, (name, r) in enumerate(rates.items()):
        _rate_wav(str(tmp_path / name), r // 2 + 77 * i, r, i)
    stats = {}
    got = {os.path.basename(k): v for k, v in pipeline.extract_corpus(
        str(tmp_path), KALDI39, batch_size=2, stats=stats, resample=True,
        device="cpu")}
    assert set(got) == set(rates)
    assert stats["files"] == 5
    for name, r in rates.items():
        x, _ = io.read_wav(str(tmp_path / name))
        x16 = resampling.resample(x, r, 16000, device="cpu")
        want = features.extract(x16, cfg=KALDI39).features.numpy()
        assert got[name].shape == want.shape
        assert _scaled(got[name], want) <= TOL
    # the reference pipeline on the same corpus
    ref = {os.path.basename(k): v for k, v in jpipeline.extract_corpus(
        str(tmp_path), JPRESETS["kaldi39"], batch_size=2, resample=True)}
    for name in rates:
        assert _scaled(got[name], ref[name]) <= TOL


def test_corpus_resample_cli(tmp_path):
    for i, r in enumerate((8000, 16000, 48000)):
        _rate_wav(str(tmp_path / f"u{i}.wav"), r, r, i)
    out = str(tmp_path / "o.npz")
    assert pipeline.main([str(tmp_path), out, "--preset", "kaldi39",
                          "--resample", "--device", "cpu"]) == 0
    got = np.load(out)
    assert sorted(got.files) == ["u0.wav", "u1.wav", "u2.wav"]
    for k in got.files:
        assert got[k].shape == (KALDI39.num_frames(16000), 39)


def test_no_thread_outlives_a_failed_resample(tmp_path, monkeypatch):
    """A resample that fails in the decode thread surfaces in the consumer,
    and the thread is joined."""
    from tpufeat_torch import resampling
    for i in range(4):
        _rate_wav(str(tmp_path / f"u{i}.wav"), 8000, 8000, i)

    def boom(*a, **kw):
        raise RuntimeError("resample failed")
    monkeypatch.setattr(resampling, "resample", boom)
    with pytest.raises(RuntimeError, match="resample failed"):
        list(pipeline.extract_corpus(str(tmp_path), MFCC13_HTK,
                                     batch_size=2, resample=True,
                                     device="cpu"))
    assert not _decode_threads()
