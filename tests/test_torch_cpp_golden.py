"""The port's native C++ golden (``tpufeat_torch.cpp_golden``): three-way
parity of the C++ float64 goldens, the port's float64 goldens
(``tpufeat_torch.reference.cpu``) and the port's own path on the CPU, as
``tests/test_cpp_golden.py`` holds the reference's; the native WAV
decoders against the Python parser; the build (into
``tpufeat_torch/_build/``, atomic when processes build at once); and the
native decode where the port uses it (``io.read_wav(native=)``,
``data.iter_wav_dir``, the corpus pipeline, ``cli --validate``).

Tolerances (``tests/test_cpp_golden.py``'s): C++ against the numpy golden
1e-9 (MFCC), 1e-8 (PLP), 1e-12 (CMVN, resampling against scipy), rtol
1e-12 (refined pitch); against the port's float32 path 1e-3 (MFCC), 2e-3
(PLP), 5e-4 / 2e-4 (sliding / online CMVN), rtol 1e-6 (pitch); the native
decode equals the Python decode bit for bit on mono PCM16 (the corpus
arks too), within 1e-7 for a stereo average, and within
``tests/test_io.py``'s per-format tolerances against the signal.

No test here depends on the JAX package's library: the port builds its
own.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from tpufeat_torch import cli, cpp_golden, data, features, io, pipeline
from tpufeat_torch import matrices
from tpufeat_torch.config import MFCC13_HTK, PLP13, WHISPER80, FeatureConfig
from tpufeat_torch.pitch import PitchConfig
from tpufeat_torch.pitch import track as track_pitch
from tpufeat_torch.reference import cpu

from conftest import make_signal

CPU = "cpu"
REPO = pathlib.Path(__file__).resolve().parent.parent


def _port(sig, cfg):
    return features.extract(sig, cfg=cfg, device=CPU).features.numpy()


class TestThreeWayParity:
    def test_cpp_vs_numpy_golden(self):
        """Two independent float64 implementations (C++ radix-2 FFT vs
        np.fft) agree to near machine epsilon."""
        sig = make_signal(16000, seed=60).astype(np.float64)
        a = cpp_golden.mfcc_native(sig, MFCC13_HTK)
        b = cpu.mfcc(sig, MFCC13_HTK)
        assert a.shape == b.shape == (98, 13)
        assert np.abs(a - b).max() < 1e-9

    def test_cpp_vs_port_path(self):
        sig = make_signal(8000, seed=61)
        a = cpp_golden.mfcc_native(sig.astype(np.float64), MFCC13_HTK)
        assert np.abs(a - _port(sig, MFCC13_HTK)).max() < 1e-3

    def test_vtln_three_way(self):
        """The C++ golden builds its own triangles and warp function."""
        for w in (0.85, 1.15):
            cfg = dataclasses.replace(MFCC13_HTK, vtln_warp=w)
            sig = make_signal(8000, seed=63).astype(np.float64)
            a = cpp_golden.mfcc_native(sig, cfg)
            assert np.abs(a - cpu.mfcc(sig, cfg)).max() < 1e-9
            assert np.abs(a - _port(sig.astype(np.float32), cfg)).max() \
                < 1e-3
            un = cpp_golden.mfcc_native(sig, MFCC13_HTK)
            assert np.abs(a - un).max() > 1e-3   # the warp does something

    def test_lifter(self):
        cfg = FeatureConfig(lifter=22)
        sig = make_signal(4000, seed=62).astype(np.float64)
        assert np.abs(cpp_golden.mfcc_native(sig, cfg)
                      - cpu.mfcc(sig, cfg)).max() < 1e-9

    def test_short_signal(self):
        assert cpp_golden.mfcc_native(np.zeros(100), MFCC13_HTK).shape \
            == (0, 13)

    def test_rejects_uncovered_configs(self):
        with pytest.raises(ValueError):
            cpp_golden.mfcc_native(np.zeros(1000), WHISPER80)
        with pytest.raises(ValueError):
            cpp_golden.plp_native(np.zeros(1000), MFCC13_HTK)

    @pytest.mark.parametrize("kw", [
        dict(n_mfcc=0), dict(n_mfcc=0, use_energy=True),
        dict(n_mels=0, n_mfcc=0), dict(n_mels=0, n_mfcc=0, use_energy=True)],
        ids=["fbank", "fbank_energy", "spec", "spec_energy"])
    def test_fbank_and_spec_cpp_vs_numpy_golden(self, kw):
        """The filterbank and spectrogram bindings (the reference's tests
        leave them out) against the numpy golden, then the port's path."""
        cfg = dataclasses.replace(MFCC13_HTK, **kw)
        native = cpp_golden.spec_native if cfg.n_mels == 0 else \
            cpp_golden.fbank_native
        sig = make_signal(8000, seed=66)
        a = native(sig.astype(np.float64), cfg)
        assert a.shape == (48, cfg.feature_dim)
        assert np.abs(a - cpu.extract(sig.astype(np.float64), cfg)).max() \
            < 1e-9
        assert np.abs(a - _port(sig, cfg)).max() < 1e-3
        with pytest.raises(ValueError):
            native(sig, WHISPER80)

    def test_plp_cpp_vs_numpy_golden(self):
        sig = make_signal(16000, seed=63).astype(np.float64)
        a = cpp_golden.plp_native(sig, PLP13)
        b = cpu.plp(sig, PLP13)
        assert a.shape == b.shape == (98, 13)
        assert np.abs(a - b).max() < 1e-8

    def test_plp_cpp_vs_port_path(self):
        sig = make_signal(8000, seed=64)
        a = cpp_golden.plp_native(sig.astype(np.float64), PLP13)
        assert np.abs(a - _port(sig, PLP13)).max() < 2e-3

    def test_plp_lifter_and_silence(self):
        cfg = dataclasses.replace(PLP13, lifter=22)
        sig = make_signal(4000, seed=65).astype(np.float64)
        assert np.abs(cpp_golden.plp_native(sig, cfg)
                      - cpu.plp(sig, cfg)).max() < 1e-8
        assert np.isfinite(cpp_golden.plp_native(np.zeros(4000),
                                                 PLP13)).all()

    @staticmethod
    def _pitch_tone(f0=140.0, n=12000, seed=7):
        t = np.arange(n) / 16000.0
        r = np.random.default_rng(seed)
        return (0.3 * np.sin(2 * np.pi * f0 * t)
                + 0.03 * np.sin(2 * np.pi * 2 * f0 * t + 0.3)
                + 0.01 * r.standard_normal(n)).astype(np.float64)

    @pytest.mark.parametrize("center", [False, True])
    def test_pitch_cpp_vs_numpy_golden(self, center):
        """The same Viterbi path; refined hz to near-f64 (the two
        resamplers differ at about 1e-15); the native lag grid bit for
        bit."""
        cfg = PitchConfig(center=center)
        sig = self._pitch_tone()
        chz, cpov = cpp_golden.pitch_native(sig, cfg)
        ghz, gpov = cpu.pitch(sig, cfg)
        assert chz.shape == ghz.shape
        np.testing.assert_allclose(chz, ghz, rtol=1e-12)
        assert np.abs(cpov - gpov).max() < 1e-10
        cfg0 = PitchConfig(center=center, lag_rate=0, refine=False)
        np.testing.assert_array_equal(cpp_golden.pitch_native(sig, cfg0)[0],
                                      cpu.pitch(sig, cfg0)[0])

    @pytest.mark.parametrize("pq", [(1, 8), (2, 1), (160, 441)])
    def test_resample_cpp_vs_scipy(self, pq):
        from scipy.signal import resample_poly
        p, q = pq
        r = np.random.default_rng(17)
        for n in (16000, 4091):
            x = r.standard_normal(n)
            got = cpp_golden.resample_native(x, p, q)
            ref = resample_poly(x, p, q)
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)

    def test_pitch_cpp_vs_port_path(self):
        cfg = PitchConfig()
        sig = self._pitch_tone(f0=185.0, n=9600, seed=11)
        chz, cpov = cpp_golden.pitch_native(sig, cfg)
        hz, pov, valid = track_pitch(sig.astype(np.float32), cfg=cfg,
                                     device=CPU)
        F = int(valid.sum())
        np.testing.assert_allclose(hz.numpy()[:F], chz[:F], rtol=1e-6)
        np.testing.assert_allclose(pov.numpy()[:F], cpov[:F], rtol=0,
                                   atol=1e-4)

    def test_pitch_short_and_silence(self):
        cfg = PitchConfig()
        hz, _ = cpp_golden.pitch_native(np.zeros(100), cfg)
        assert hz.shape == (0,)
        hz, pov = cpp_golden.pitch_native(np.zeros(4000), cfg)
        assert np.isfinite(hz).all() and np.abs(pov).max() < 0.1


def _stereo(path, sig):
    pcm = np.clip(np.round(np.stack([sig, -0.5 * sig], 1) * 32768),
                  -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


class TestNativeWav:
    def test_matches_python_reader(self, tmp_path):
        sig = make_signal(12345, seed=63)
        path = str(tmp_path / "t.wav")
        io.write_wav(path, sig, 16000)
        a, ra = cpp_golden.read_wav_native(path)
        b, rb = io.read_wav(path, native=False)
        assert ra == rb == 16000 and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)      # PCM16: bit for bit
        assert cpp_golden.wav_header(path) == (12345, 16000)

    def test_stereo_average(self, tmp_path):
        path = str(tmp_path / "s.wav")
        _stereo(path, make_signal(4000, seed=64))
        a, _ = cpp_golden.read_wav_native(path)
        b, _ = io.read_wav(path, native=False)
        np.testing.assert_allclose(a, b, atol=1e-7)

    def test_batch_loader(self, tmp_path):
        sigs = [make_signal(4000 + 100 * i, seed=130 + i) for i in range(6)]
        paths = []
        for i, s in enumerate(sigs):
            p = str(tmp_path / f"b{i}.wav")
            io.write_wav(p, s, 16000)
            paths.append(p)
        paths.append(str(tmp_path / "missing.wav"))
        batch, lengths, rates = cpp_golden.read_wav_batch(paths, 8000,
                                                          n_threads=3)
        assert batch.shape == (7, 8000)
        assert lengths[-1] == -1  # a missing file is reported, not fatal
        for i, s in enumerate(sigs):
            assert lengths[i] == len(s) and rates[i] == 16000
            ref, _ = io.read_wav(paths[i], native=False)
            np.testing.assert_array_equal(batch[i, : len(s)], ref)
            assert (batch[i, len(s):] == 0).all()
        empty = cpp_golden.read_wav_batch([], 100)
        assert [a.shape for a in empty] == [(0, 100), (0,), (0,)]

    def test_rejects_garbage(self, tmp_path):
        path = str(tmp_path / "bad.wav")
        with open(path, "wb") as f:
            f.write(b"not a wav file at all")
        with pytest.raises(ValueError):
            cpp_golden.read_wav_native(path)
        with pytest.raises(ValueError):
            cpp_golden.wav_header(path)


class TestSlidingCmvnThreeWay:
    @pytest.mark.parametrize("center,norm_vars", [
        (False, False), (False, True), (True, False), (True, True)])
    @pytest.mark.parametrize("T", [5, 80, 400])
    def test_three_way(self, T, center, norm_vars):
        """numpy f64 golden == C++ double to 1e-12; the port's f32 within
        5e-4 (the one-pass variance at small T)."""
        rng = np.random.default_rng(T)
        f = (rng.standard_normal((T, 7)) * 2 + 1).astype(np.float64)
        kw = dict(window=50, min_window=15, center=center,
                  norm_vars=norm_vars)
        a = cpu.sliding_cmvn(f, **kw)
        np.testing.assert_allclose(cpp_golden.sliding_cmvn_native(f, **kw),
                                   a, atol=1e-12, rtol=0)
        c = features.sliding_cmvn(torch.tensor(f, dtype=torch.float32)[None],
                                  None, **kw)[0]
        np.testing.assert_allclose(c.numpy(), a, atol=5e-4, rtol=0)


class TestOnlineCmvnThreeWay:
    @pytest.mark.parametrize("norm_vars", [False, True])
    @pytest.mark.parametrize("priors", ["none", "both"])
    @pytest.mark.parametrize("T", [5, 80, 400])
    def test_three_way(self, T, priors, norm_vars):
        """Kaldi online2 OnlineCmvn: numpy f64 golden == C++ double to
        1e-12; the port's f32 within 2e-4."""
        rng = np.random.default_rng(1000 + T)
        D = 7
        f = (rng.standard_normal((T, D)) * 2 + 1).astype(np.float64)
        spk = glob = None
        if priors == "both":
            s = rng.standard_normal((40, D)) * 1.5 + 0.5
            g = rng.standard_normal((300, D)) * 2 - 0.3
            spk, glob = data.CmvnStats(D), data.CmvnStats(D)
            spk.accumulate(s)
            glob.accumulate(g)
        kw = dict(window=50, speaker_stats=spk, global_stats=glob,
                  speaker_frames=30, global_frames=20, norm_vars=norm_vars)
        a = cpu.online_cmvn(f, **kw)
        np.testing.assert_allclose(cpp_golden.online_cmvn_native(f, **kw),
                                   a, atol=1e-12, rtol=0)
        if spk is not None:       # the (count, sum, sumsq) triple form too
            trip = dict(kw, speaker_stats=(spk.count, spk.sum, spk.sumsq),
                        global_stats=(glob.count, glob.sum, glob.sumsq))
            np.testing.assert_allclose(
                cpp_golden.online_cmvn_native(f, **trip), a, atol=1e-12,
                rtol=0)
        c = features.online_cmvn(torch.tensor(f, dtype=torch.float32)[None],
                                 None, **kw)[0]
        np.testing.assert_allclose(c.numpy(), a, atol=2e-4, rtol=0)


class TestGammatoneThreeWay:
    def test_cpp_bank_matches_numpy(self):
        got = cpp_golden.gammatone_fb_native(16000, 512, 64, 50.0, 8000.0)
        want = matrices.mel_filterbank(16000, 512, 64, 50.0, 8000.0,
                                       "erb", None, "gammatone")
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


class TestBuild:
    def test_builds_into_the_port_build_dir(self):
        so = cpp_golden.library_path()
        assert cpp_golden.available()
        assert so.exists() and so.parent.parent == cpp_golden.BUILD_ROOT
        assert cpp_golden.BUILD_ROOT == REPO / "tpufeat_torch" / "_build"
        assert cpp_golden.SOURCE == REPO / "cpp_ref" / "mfcc.cc"

    def test_concurrent_builds_never_tear(self, tmp_path):
        """Four processes build into one empty root at once: each loads a
        whole library, one file is left, no temporary remains, and nothing
        is written beside the source."""
        before = sorted(os.listdir(REPO / "cpp_ref"))
        code = ("import pathlib, sys; from tpufeat_torch import cpp_golden "
                "as c; c.BUILD_ROOT = pathlib.Path(sys.argv[1]); "
                "import numpy as np; from tpufeat_torch.config import "
                "MFCC13_HTK; print(c.mfcc_native(np.ones(800), "
                "MFCC13_HTK).shape)")
        procs = [subprocess.Popen([sys.executable, "-c", code,
                                   str(tmp_path)], cwd=REPO,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(4)]
        outs = [p.communicate(timeout=120) for p in procs]
        assert [p.returncode for p in procs] == [0] * 4, outs
        assert all(o.strip() == "(3, 13)" for o, _ in outs), outs
        (d,) = tmp_path.iterdir()
        assert [f.name for f in d.iterdir()] == ["libtpufeat_ref.so"]
        assert sorted(os.listdir(REPO / "cpp_ref")) == before


ENCODINGS = [("pcm8", 1 / 128), ("pcm16", 1 / 32768), ("pcm24", 1 / 8388608),
             ("pcm32", 1e-7), ("float32", 1e-7), ("float64", 1e-7)]


class TestReadWavNative:
    @pytest.mark.parametrize("encoding,tol", ENCODINGS)
    @pytest.mark.parametrize("native", [None, True, False])
    def test_roundtrip_all_formats(self, tmp_path, encoding, tol, native):
        sig = make_signal(3000, seed=164)
        p = str(tmp_path / f"{encoding}.wav")
        io.write_wav(p, sig, 16000, encoding=encoding)
        x, r = io.read_wav(p, native=native)
        assert r == 16000 and x.dtype == np.float32
        assert np.abs(x - sig).max() < tol + 1e-6
        if encoding == "pcm16":
            np.testing.assert_array_equal(x, io.read_wav(p, native=False)[0])

    def test_garbage_and_channels(self, tmp_path):
        bad = str(tmp_path / "bad.wav")
        with open(bad, "wb") as f:
            f.write(b"RIFF....junk")
        with pytest.raises(ValueError, match="not a readable WAV"):
            io.read_wav(bad, native=True)
        with pytest.raises(ValueError, match="RIFF/WAVE"):
            io.read_wav(bad)          # the Python parser's error
        st = str(tmp_path / "st.wav")
        sig = make_signal(2000, seed=5)
        _stereo(st, sig)
        left, _ = io.read_wav(st, channel=0)
        np.testing.assert_array_equal(left, io.read_wav(
            st, native=False, channel=0)[0])
        both, _ = io.read_wav(st, channel="all")
        assert both.shape == (2, 2000)
        np.testing.assert_allclose(io.read_wav(st)[0], both.mean(axis=0),
                                   atol=1e-7)

    def test_iter_wav_dir(self, tmp_path):
        for i in range(3):
            io.write_wav(str(tmp_path / f"{i}.wav"),
                         make_signal(1000 + 7 * i, seed=i), 16000)
        got = list(data.iter_wav_dir(str(tmp_path), native=True))
        want = list(data.iter_wav_dir(str(tmp_path), native=False))
        assert [g[0] for g in got] == [w[0] for w in want]
        for (_, a, ra), (_, b, rb) in zip(got, want):
            assert ra == rb
            np.testing.assert_array_equal(a, b)


def _corpus(root, lengths, rate=16000):
    paths = []
    for i, n in enumerate(lengths):
        p = os.path.join(str(root), f"u{i:02d}.wav")
        io.write_wav(p, make_signal(n, seed=40 + i), rate)
        paths.append(p)
    return paths


class TestCorpusNative:
    def test_scan_and_decode_match_python(self, tmp_path):
        _corpus(tmp_path, [4000, 4100, 4200, 800, 9999, 40000])
        scan = pipeline._scan_corpus(str(tmp_path), native=True)
        assert scan == pipeline._scan_corpus(str(tmp_path), native=False)
        plans = pipeline._plan_batches(scan, 2)
        assert any(len(b) < rows for b, _, rows, _ in plans)  # padded rows
        for batch, width, rows, rate in plans:
            a = pipeline._decode_batch(batch, width, rows, rate, native=True)
            b = pipeline._decode_batch(batch, width, rows, rate, native=False)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])

    def test_arks_bit_for_bit(self, tmp_path):
        """The corpus pipeline's features with the native decode equal those
        with the Python decode on PCM16, file for file."""
        _corpus(tmp_path, [4000, 5321, 12000, 16000, 9999, 700])
        got = dict(pipeline.extract_corpus(str(tmp_path), MFCC13_HTK,
                                           batch_size=2, native=True,
                                           device=CPU))
        want = dict(pipeline.extract_corpus(str(tmp_path), MFCC13_HTK,
                                            batch_size=2, native=False,
                                            device=CPU))
        assert sorted(got) == sorted(want) and len(got) == 6
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])

    def test_rate_mismatch_raises_the_reason(self, tmp_path):
        _corpus(tmp_path, [4000, 4000], rate=8000)
        scan = pipeline._scan_corpus(str(tmp_path), native=True)
        with pytest.raises(ValueError, match="rate 8000 != 16000"):
            pipeline._decode_batch(scan, 4000, 2, 16000, native=True)


def test_cli_validate_reports_cpp_golden(tmp_path, capsys):
    w = str(tmp_path / "a.wav")
    io.write_wav(w, make_signal(8000, seed=3), 16000)
    assert cli.main([w, str(tmp_path / "o.npy"), "--device", CPU,
                     "--validate"]) == 0
    errs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert errs["max_abs_err"]["numpy_f64"] < 1e-3
    assert errs["max_abs_err"]["cpp_golden"] < 1e-3
