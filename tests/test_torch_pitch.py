"""The port's pitch tracker (``tpufeat_torch/pitch.py``) against the float64
golden (``tpufeat_torch.reference.cpu.pitch``, a copy of the reference's),
against ``tpufeat.pitch`` on the same input, and against itself (offline
against online, batch against alone). Mirrors ``tests/test_pitch.py``;
the reference's online tracker runs in a process of its own
(``tests/_jax_pitch_oracle.py``, group "pitch", about 15 s), its offline
tracker here.

Tolerances:
- against the golden, the reference's: hz rtol 1e-6 (the same Viterbi
  path, hz at f32 resolution), POV atol 1e-4; on noise the sorted path
  scores within 5e-3 (paths may differ where scores tie);
- "gemm" against "fft" NCCF: 2e-5 abs (f32 roundoff), hz rtol 1e-6;
- against ``tpufeat.pitch`` (offline and online): hz rtol 1e-6, POV and
  the feature columns atol 1e-5 (both f32; products summed in other
  orders, the same decisions);
- online against offline: the reference's, hz rtol 1e-6, POV atol 1e-5,
  the feature columns atol 2e-5 (the running mean's column atol 5e-3 on
  the last 20 rows at K=15);
- mask invariance: decisions (refine=False) bit for bit; refined hz rtol
  2e-5 (the blocked resampler's BLAS sums follow the row count); the
  native grid bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpufeat import pitch as jpitch

import _jax_pitch_oracle as oracle
from conftest import make_signal
from tpufeat_torch import pitch, streaming
from tpufeat_torch.config import MFCC13_HTK, WHISPER80
from tpufeat_torch.reference import cpu


def tone(f0, n=16000, sr=16000, amp=0.3, seed=0):
    return oracle.tone(f0, n, seed, sr=sr, amp=amp)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def track(sig, lengths=None, cfg=pitch.PitchConfig()):
    return tuple(_np(t) for t in pitch.track(sig, lengths, cfg,
                                             device="cpu"))


def _jcfg(cfg: pitch.PitchConfig) -> jpitch.PitchConfig:
    return jpitch.PitchConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's online tracker on the oracle's cases."""
    out = str(tmp_path_factory.mktemp("oracle") / "pitch.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, oracle.__file__, out, "pitch"],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as d:
        got = {k: d[k] for k in d.files}
    got["_out"] = out
    return got


class TestTracking:
    @pytest.mark.parametrize("f0", [80.0, 125.0, 220.0, 330.0])
    def test_tone_frequency(self, f0):
        hz, pov, v = track(tone(f0))
        got = np.median(hz[v])
        assert abs(got - f0) <= max(1.5 * f0 * f0 / 16000, 0.5), got
        assert pov[v].mean() > 0.5

    def test_silence_is_unvoiced(self):
        _, pov, _ = track(np.zeros(16000, np.float32))
        assert np.abs(pov).max() < 0.1

    def test_octave_smoothing(self):
        t = np.arange(24000) / 16000
        sig = (0.15 * np.sin(2 * np.pi * 110.0 * t)
               + 0.3 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
        hz, _, v = track(sig)
        assert (np.abs(np.diff(np.log(hz[v]))) > 0.5).sum() == 0

    def test_chirp_tracks(self):
        t = np.arange(32000) / 16000
        f = 120.0 + 60.0 * t / t[-1]
        sig = (0.3 * np.sin(2 * np.pi * np.cumsum(f) / 16000)).astype(
            np.float32)
        hz, _, v = track(sig)
        hz = hz[v]
        assert hz[-1] > hz[0] + 30
        assert np.all(np.diff(hz) > -8)


class TestGoldenParity:
    def test_matches_cpu_golden(self):
        cfg = pitch.PitchConfig()
        sig = tone(140.0, n=12000) + 0.3 * make_signal(12000, seed=7)
        hz, pov, v = track(sig, cfg=cfg)
        ghz, gpov = cpu.pitch(sig.astype(np.float64), cfg)
        F = int(v.sum())
        np.testing.assert_allclose(hz[:F], ghz[:F], rtol=1e-6)
        np.testing.assert_allclose(pov[:F], gpov[:F], rtol=0, atol=1e-4)

    def test_gemm_equals_fft_nccf(self):
        for sig in (tone(185.0, n=9600) + 0.2 * make_signal(9600, seed=11),
                    make_signal(9600, seed=12)):
            g = pitch.PitchConfig(nccf_method="gemm")
            f = dataclasses.replace(g, nccf_method="fft")
            x = torch.from_numpy(np.asarray(sig, np.float32)[None])
            lens = torch.tensor([len(sig)], dtype=torch.int32)
            sg, vg = pitch.nccf(x, lens, g)
            sf, vf = pitch.nccf(x, lens, f)
            assert torch.equal(vg, vf)
            torch.testing.assert_close(sg, sf, rtol=0, atol=2e-5)
            np.testing.assert_allclose(track(sig, cfg=g)[0],
                                       track(sig, cfg=f)[0], rtol=1e-6)

    def test_noise_parity(self):
        cfg = pitch.PitchConfig()
        sig = make_signal(9600, seed=9)
        _, pov, v = track(sig, cfg=cfg)
        _, gpov = cpu.pitch(sig.astype(np.float64), cfg)
        F = int(v.sum())
        np.testing.assert_allclose(np.sort(pov[:F]), np.sort(gpov[:F]),
                                   rtol=0, atol=5e-3)

    def test_native_grid_matches_golden(self):
        cfg = pitch.PitchConfig(lag_rate=0)
        sig = tone(160.0, n=8000) + 0.2 * make_signal(8000, seed=17)
        hz, pov, v = track(sig, cfg=cfg)
        ghz, gpov = cpu.pitch(sig.astype(np.float64), cfg)
        F = int(v.sum())
        np.testing.assert_allclose(hz[:F], ghz[:F], rtol=1e-6)
        np.testing.assert_allclose(pov[:F], gpov[:F], rtol=0, atol=1e-4)


class TestAgainstTpufeat:
    """The same seeded input through ``tpufeat.pitch`` (offline, here)."""

    @pytest.mark.parametrize("change", [{}, dict(center=True),
                                        dict(lag_rate=0, refine=False)],
                             ids=["default", "center", "native"])
    def test_track(self, change):
        cfg = dataclasses.replace(pitch.PitchConfig(), **change)
        x = np.stack([tone(140.0, n=12000) + 0.3 * make_signal(12000, 7),
                      tone(230.0, n=12000, seed=4)])
        lens = np.array([12000, 9000], np.int32)
        hz, pov, v = track(x, lens, cfg)
        jhz, jpov, jv = (np.asarray(a) for a in jpitch.track(
            x, lens, _jcfg(cfg)))
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_allclose(hz[v], jhz[v], rtol=1e-6)
        np.testing.assert_allclose(pov[v], jpov[v], rtol=0, atol=1e-5)

    def test_pitch_features(self):
        cfg = pitch.PitchConfig()
        sig = tone(150.0, n=12000, seed=3)
        f, v = pitch.pitch_features(sig, cfg=cfg, device="cpu")
        jf, jv = jpitch.pitch_features(sig, cfg=_jcfg(cfg))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                                   atol=1e-5)

    def test_nccf_and_lag_grid(self):
        cfg = pitch.PitchConfig()
        x = np.random.default_rng(6).standard_normal((2, 6000)).astype(
            np.float32)
        lens = np.array([6000, 4321], np.int32)
        y, ly, inner = pitch.to_lag_grid(torch.from_numpy(x),
                                         torch.from_numpy(lens), cfg)
        jy, jly, jinner = jpitch.to_lag_grid(x, lens, _jcfg(cfg))
        assert inner == pitch.PitchConfig(**dataclasses.asdict(jinner))
        np.testing.assert_array_equal(ly.numpy(), np.asarray(jly))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-6)
        s, v = pitch.nccf(torch.from_numpy(x), torch.from_numpy(lens), cfg)
        js, jv = jpitch.nccf(x, lens, _jcfg(cfg))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0,
                                   atol=1e-5)

    def test_transition_matrix(self):
        cfg = pitch.PitchConfig()
        np.testing.assert_array_equal(
            pitch._transition_matrix(cfg),
            jpitch._transition_matrix(_jcfg(cfg)))


class TestViterbi:
    @staticmethod
    def _golden(scores, trans):
        """The golden's Viterbi (``cpu.pitch``'s loop) on given scores."""
        F, L = scores.shape
        v = scores[0].astype(np.float64)
        ptrs = []
        for t in range(1, F):
            cand = v[:, None] - trans
            ptrs.append(np.argmax(cand, axis=0))
            v = scores[t] + np.max(cand, axis=0)
        path = [int(np.argmax(v))]
        for t in range(F - 2, -1, -1):
            path.append(int(ptrs[t][path[-1]]))
        return np.array(path[::-1])

    def test_ties_take_the_first_maximum(self):
        """A real tie: two lags score exactly alike on every frame, with a
        transition matrix symmetric about them, so both paths have the same
        score. The first (lower) index wins, as np.argmax's does."""
        L, F = 6, 5
        scores = np.zeros((F, L), np.float32)
        scores[:, 1] = scores[:, 4] = 1.0
        lags = np.arange(L, dtype=np.float64)
        trans = (0.5 * (lags[:, None] - lags[None, :]) ** 2).astype(
            np.float32)
        got = pitch._viterbi(torch.from_numpy(scores)[None],
                             torch.ones(1, F, dtype=torch.bool),
                             torch.from_numpy(trans))[0].numpy()
        want = self._golden(scores, trans)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.full(F, 1))

    def test_random_scores_match_the_golden(self):
        rng = np.random.default_rng(8)
        cfg = pitch.PitchConfig().inner()
        trans = pitch._transition_matrix(cfg)
        scores = rng.uniform(-1, 1, (3, 40, cfg.n_lags)).astype(np.float32)
        got = pitch._viterbi(torch.from_numpy(scores),
                             torch.ones(3, 40, dtype=torch.bool),
                             torch.from_numpy(trans)).numpy()
        for b in range(3):
            np.testing.assert_array_equal(got[b],
                                          self._golden(scores[b], trans))

    def test_padded_frames_freeze_the_path(self):
        rng = np.random.default_rng(9)
        cfg = pitch.PitchConfig().inner()
        trans = torch.from_numpy(pitch._transition_matrix(cfg))
        scores = torch.from_numpy(
            rng.uniform(-1, 1, (1, 30, cfg.n_lags)).astype(np.float32))
        valid = torch.ones(1, 30, dtype=torch.bool)
        valid[:, 20:] = False
        junk = scores.clone()
        junk[:, 20:] = 5.0 * torch.from_numpy(
            rng.standard_normal((1, 10, cfg.n_lags)).astype(np.float32))
        a = pitch._viterbi(scores[:, :20], valid[:, :20], trans)
        b = pitch._viterbi(junk, valid, trans)
        torch.testing.assert_close(b[:, :20], a, rtol=0, atol=0)
        assert bool((b[:, 20:] == a[:, -1:]).all())


class TestBatchAndFeatures:
    def test_batch_mask_invariance(self):
        sig = tone(150.0, n=9600)
        padded = np.concatenate(
            [sig, (10 * np.random.default_rng(3).standard_normal(6400))
             .astype(np.float32)])
        lens = np.array([9600], np.int32)
        for refine in (False, True):
            cfg = dataclasses.replace(pitch.PitchConfig(), refine=refine)
            hz1, _, v1 = track(sig, cfg=cfg)
            hz2, _, _ = track(padded[None], lens, cfg)
            F = int(v1.sum())
            if refine:
                np.testing.assert_allclose(hz1[:F], hz2[0, :F], rtol=2e-5)
            else:
                np.testing.assert_array_equal(hz1[:F], hz2[0, :F])

    def test_features_shape_and_masking(self):
        f, v = pitch.pitch_features(tone(200.0, n=12800), device="cpu")
        F = v.shape[0]
        assert tuple(f.shape) == (F, 3)
        f = f.numpy()
        assert np.isfinite(f).all()
        assert abs(f[v.numpy(), 1].mean()) < 1e-5

    def test_batched_two_utterances(self):
        x = np.zeros((2, 12000), np.float32)
        x[0], x[1, :8000] = tone(100.0, n=12000), tone(250.0, n=8000)
        hz, _, v = track(x, np.array([12000, 8000], np.int32))
        assert abs(np.median(hz[0][v[0]]) - 100) < 3
        assert abs(np.median(hz[1][v[1]]) - 250) < 8

    def test_short_audio_has_no_frames(self):
        hz, pov, v = track(np.zeros(500, np.float32))
        assert hz.shape == pov.shape == v.shape == (0,)


class TestCenterAndConfigFor:
    def test_config_for_derives_grid(self):
        pc = pitch.config_for(WHISPER80)
        assert pc.sample_rate == WHISPER80.sample_rate
        assert pc.hop_length == WHISPER80.hop_length
        assert pc.center is True
        cfg8 = dataclasses.replace(MFCC13_HTK, sample_rate=8000,
                                   frame_length=200, hop_length=80,
                                   n_fft=256)
        pc8 = pitch.config_for(cfg8)
        assert (pc8.sample_rate, pc8.hop_length) == (8000, 80)
        assert pc8.frame_length == 200
        assert pc8.center is False
        assert pitch.config_for(cfg8, max_f0=300.0).max_f0 == 300.0

    def test_8k_audio_tracks_true_f0(self):
        sr, f0, n = 8000, 120.0, 16000
        t = np.arange(n) / sr
        sig = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.03 * np.sin(2 * np.pi * 2 * f0 * t)).astype(np.float32)
        pc = pitch.PitchConfig(sample_rate=sr, frame_length=200,
                               hop_length=80)
        hz, _, v = track(sig, cfg=pc)
        assert abs(np.median(hz[v]) - f0) <= max(1.5 * f0 * f0 / sr, 0.5)

    def test_center_equals_explicit_pad(self):
        cfg_c = pitch.PitchConfig(center=True, ballast=0.0, lag_rate=0)
        cfg_u = pitch.PitchConfig(center=False, ballast=0.0, lag_rate=0)
        sig = tone(150.0, n=9600)
        pad = cfg_c.wext // 2
        padded = np.pad(sig, (pad, pad))
        assert cfg_c.num_frames(len(sig)) == cfg_u.num_frames(len(padded))
        hz_c, pov_c, _ = track(sig, cfg=cfg_c)
        hz_u, pov_u, _ = track(padded, cfg=cfg_u)
        np.testing.assert_array_equal(hz_c, hz_u)
        np.testing.assert_array_equal(pov_c, pov_u)

    def test_center_golden_parity(self):
        cfg = pitch.PitchConfig(center=True)
        sig = tone(140.0, n=12000) + 0.3 * make_signal(12000, seed=7)
        hz, _, _ = track(sig, cfg=cfg)
        ghz, gpov = cpu.pitch(sig.astype(np.float64), cfg)
        strong = gpov > 0.5
        assert strong.sum() > 20
        np.testing.assert_allclose(hz[strong], ghz[strong], rtol=1e-6)

    def test_center_validity_matches_spectral_convention(self):
        cfg = pitch.PitchConfig(center=True)
        n, length = 12800, 9600
        x = np.zeros((1, n), np.float32)
        x[0, :length] = tone(170.0, n=length)
        _, _, v = track(x, np.array([length], np.int32), cfg)
        want = min(cfg.num_frames(n), 1 + length // cfg.hop_length)
        assert int(v.sum()) == want


def _online(sp, sig, plan):
    outs, pos = [], 0
    for c in plan:
        outs.append(sp.process(sig[None, pos: pos + c]))
        pos += c
    outs.append(sp.flush())
    return outs


class TestStreamingPitch:
    def test_full_lookahead_equals_offline(self):
        cfg = pitch.PitchConfig(ballast=0.0)
        sig = tone(140.0, n=6400, seed=13)
        F = cfg.num_frames(len(sig))
        want_hz, want_pov, _ = track(sig, cfg=cfg)
        sp = pitch.StreamingPitch(cfg, 1, F + 4, device="cpu")
        for i in range(0, len(sig), 3200):
            hz, _ = sp.process(sig[None, i: i + 3200])
            assert hz.shape[1] == 0
        hz, pov = sp.flush()
        np.testing.assert_allclose(hz[0].numpy(), want_hz[:F], rtol=1e-6)
        np.testing.assert_allclose(pov[0].numpy(), want_pov[:F], rtol=0,
                                   atol=1e-5)

    @pytest.mark.parametrize("center", [False, True])
    def test_full_lookahead_equals_offline_native_grid(self, center):
        """The native grid (no resampler) and the centered pads, whose
        offline twin the reference runs only in its slow tier."""
        cfg = pitch.PitchConfig(ballast=0.0, lag_rate=0, center=center)
        sig = tone(160.0, n=5600, seed=2)
        F = cfg.num_frames(len(sig))
        want_hz, want_pov, _ = track(sig, cfg=cfg)
        sp = pitch.StreamingPitch(cfg, 1, F + 4, device="cpu")
        hz, pov = (torch.cat(p, dim=1) for p in zip(
            *_online(sp, sig, [2800, 2800])))
        assert hz.shape[1] == F
        np.testing.assert_allclose(hz[0].numpy(), want_hz[:F], rtol=1e-6)
        np.testing.assert_allclose(pov[0].numpy(), want_pov[:F], rtol=0,
                                   atol=1e-5)

    def test_realistic_lookahead_on_tone(self):
        cfg = pitch.PitchConfig(ballast=0.0)
        sig = tone(180.0, n=16000, seed=13)
        F = cfg.num_frames(len(sig))
        want_hz, _, _ = track(sig, cfg=cfg)
        sp = pitch.StreamingPitch(cfg, 1, 15, device="cpu")
        got = torch.cat([o[0] for o in _online(sp, sig, [1600] * 10)],
                        dim=1)[0].numpy()
        assert got.shape[0] == F
        np.testing.assert_allclose(got, want_hz[:F], rtol=1e-6)

    def test_emission_counting(self):
        cfg = pitch.PitchConfig()
        sig = tone(140.0, n=14000, seed=13)
        sp = pitch.StreamingPitch(cfg, 1, 7, device="cpu")
        outs = _online(sp, sig, [1000, 3000, 750, 4250, 5000])
        emitted = sum(o[0].shape[1] for o in outs)
        assert emitted == cfg.num_frames(14000)
        assert outs[-1][0].shape[1] >= 7

    def test_matches_tpufeat_streaming(self, reference):
        kind, sig, change, k, plan, _ = oracle.PITCH["track/k7"]
        cfg = dataclasses.replace(pitch.PitchConfig(), **change)
        sp = pitch.StreamingPitch(cfg, 1, k, device="cpu")
        outs = _online(sp, sig()[0], plan)
        hz = torch.cat([o[0] for o in outs], dim=1).numpy()
        pov = torch.cat([o[1] for o in outs], dim=1).numpy()
        np.testing.assert_allclose(hz, reference["track/k7/hz"], rtol=1e-6)
        np.testing.assert_allclose(pov, reference["track/k7/pov"], rtol=0,
                                   atol=1e-5)

    def test_state_is_saved_and_loaded(self, tmp_path):
        cfg = pitch.PitchConfig()
        sp = pitch.StreamingPitch(cfg, 2, 5, device="cpu")
        sp.process(np.random.default_rng(0).standard_normal(
            (2, 4000)).astype(np.float32))
        path = str(tmp_path / "pitch_state.npz")
        streaming.save_state(path, sp.state)
        loaded = streaming.load_state(path, sp.state)
        for a, b in zip(sp.state, loaded):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_reset_rows_leaves_the_other_rows(self):
        cfg = pitch.PitchConfig()
        x = np.stack([tone(150.0, n=9600, seed=1), tone(210.0, n=9600,
                                                         seed=2)])
        a = pitch.StreamingPitch(cfg, 2, 5, device="cpu")
        b = pitch.StreamingPitch(cfg, 2, 5, device="cpu")
        outs_a, outs_b = [], []
        for k in range(6):
            if k == 3:
                b.reset_rows([0])
            outs_a.append(a.process(x[:, k * 1600:(k + 1) * 1600]))
            outs_b.append(b.process(x[:, k * 1600:(k + 1) * 1600]))
        ha = torch.cat([o[0] for o in outs_a], 1)
        hb = torch.cat([o[0] for o in outs_b], 1)
        torch.testing.assert_close(hb[1], ha[1], rtol=0, atol=0)
        assert bool(torch.isfinite(hb).all())


class TestStreamingPitchFeatures:
    def test_full_lookahead_equals_offline(self):
        cfg = pitch.PitchConfig(ballast=0.0)
        sig = tone(150.0, n=8000, seed=13)
        F = cfg.num_frames(len(sig))
        want, _ = pitch.pitch_features(sig, cfg=cfg, device="cpu")
        spf = pitch.StreamingPitchFeatures(cfg, 1, F + 4, device="cpu")
        got = torch.cat(_online(spf, sig, [2000] * 4), dim=1)[0]
        assert tuple(got.shape) == (F, 3)
        np.testing.assert_allclose(got.numpy(), want[:F].numpy(), rtol=0,
                                   atol=2e-5)

    def test_realistic_lookahead(self):
        cfg = pitch.PitchConfig(ballast=0.0)
        sig = tone(200.0, n=16000, seed=13)
        F = cfg.num_frames(len(sig))
        want, _ = pitch.pitch_features(sig, cfg=cfg, device="cpu")
        spf = pitch.StreamingPitchFeatures(cfg, 1, 15, device="cpu")
        got = torch.cat(_online(spf, sig, [1600] * 10), dim=1)[0].numpy()
        assert got.shape == (F, 3)
        w = want[:F].numpy()
        np.testing.assert_allclose(got[:, 0], w[:, 0], rtol=0, atol=2e-5)
        np.testing.assert_allclose(got[:, 2], w[:, 2], rtol=0, atol=2e-5)
        np.testing.assert_allclose(got[-20:, 1], w[-20:, 1], rtol=0,
                                   atol=5e-3)

    def test_state_roundtrip_with_resampler(self):
        cfg = pitch.PitchConfig(ballast=0.0)
        sig = tone(170.0, n=12000, seed=21)
        a = pitch.StreamingPitchFeatures(cfg, 1, 9, device="cpu")
        rows = [a.process(sig[None, :7000])]
        st = a.state()
        rows += [a.process(sig[None, 7000:]), a.flush()]
        b = pitch.StreamingPitchFeatures(cfg, 1, 9, device="cpu")
        b.process(sig[None, :7000])
        b.set_state(st)
        got = torch.cat([rows[0], b.process(sig[None, 7000:]), b.flush()],
                        dim=1)
        torch.testing.assert_close(got, torch.cat(rows, dim=1), rtol=0,
                                   atol=0)

    def test_matches_tpufeat_streaming(self, reference):
        _, sig, change, k, plan, _ = oracle.PITCH["features/k9"]
        cfg = dataclasses.replace(pitch.PitchConfig(), **change)
        spf = pitch.StreamingPitchFeatures(cfg, 1, k, device="cpu")
        got = torch.cat(_online(spf, sig()[0], plan), dim=1).numpy()
        np.testing.assert_allclose(got, reference["features/k9"], rtol=0,
                                   atol=1e-5)

    def test_resume_from_a_state_tpufeat_saved(self, reference):
        """The reference's state (its tracker rings, resampler carry,
        delta carry, FIFOs), saved after the first chunk, loads into the
        port, which then gives the reference's remaining rows."""
        _, sig, change, k, plan, _ = oracle.PITCH["features/k9"]
        cfg = dataclasses.replace(pitch.PitchConfig(), **change)
        x = sig()[0]
        first = pitch.StreamingPitchFeatures(cfg, 1, k, device="cpu")
        head = first.process(x[None, :plan[0]])
        spf = pitch.StreamingPitchFeatures(cfg, 1, k, device="cpu")
        path = oracle.state_path(reference["_out"], "features/k9")
        spf.set_state(streaming.load_state(path, spf.state()))
        pos = int(reference["features/k9/at"])
        tail = torch.cat([spf.process(x[None, pos:]), spf.flush()], dim=1)
        want = reference["features/k9"]
        np.testing.assert_allclose(tail.numpy(),
                                   want[:, head.shape[1]:], rtol=0,
                                   atol=1e-5)


class TestLagGrid:
    def test_default_is_kaldi_grid(self):
        cfg = pitch.PitchConfig()
        assert cfg.lag_rate == 2000 and cfg.resampled and cfg.refine
        inner = cfg.inner()
        assert (inner.sample_rate, inner.frame_length,
                inner.hop_length) == (2000, 50, 20)
        assert (inner.lag_min, inner.lag_max, inner.n_lags) == (5, 40, 36)
        assert not inner.resampled

    def test_refined_accuracy_beats_native_quantization(self):
        for f0 in (95.0, 187.0, 263.0, 330.0):
            hz, _, v = track(tone(f0, n=16000))
            assert abs(np.median(hz[v]) - f0) < max(0.01 * f0, 0.5)

    def test_native_twin_agrees(self):
        sig = tone(150.0, n=12000)
        hz_r, _, v_r = track(sig)
        hz_n, _, v_n = track(sig, cfg=pitch.PitchConfig(lag_rate=0))
        assert abs(np.median(hz_r[v_r]) - np.median(hz_n[v_n])) < 3.0

    def test_refine_lag_recovers_parabola_vertex(self):
        lags = np.arange(9, dtype=np.float64)
        scores = (1.0 - (lags - 4.3125) ** 2 * 0.2)[None, :]
        d = pitch.refine_lag(torch.tensor(scores, dtype=torch.float32),
                             torch.tensor([4]))
        np.testing.assert_allclose(d.numpy(), [0.3125], atol=1e-5)

    def test_refine_lag_gates_edges_and_flat_peaks(self):
        d = pitch.refine_lag(torch.ones(3, 5), torch.tensor([0, 2, 4]))
        np.testing.assert_array_equal(d.numpy(), np.zeros(3))

    def test_indivisible_rate_falls_back_to_native(self):
        cfg_odd = dataclasses.replace(MFCC13_HTK, sample_rate=22050,
                                      frame_length=551, hop_length=221,
                                      n_fft=1024)
        assert pitch.config_for(cfg_odd).lag_rate == 0
        with pytest.raises(ValueError):
            pitch.PitchConfig(sample_rate=22050, frame_length=551,
                              hop_length=221).inner()

    def test_num_frames_matches_output(self):
        cfg = pitch.PitchConfig()
        for n in (7200, 14000, 16001):
            assert track(tone(150.0, n=n))[0].shape[0] == cfg.num_frames(n)

    def test_mask_invariance_through_the_resampler(self):
        sig = tone(150.0, n=9600)
        hz1, _, v1 = track(sig)
        padded = np.concatenate(
            [sig, (10 * np.random.default_rng(3).standard_normal(6400))
             .astype(np.float32)])
        hz2, _, _ = track(padded[None], np.array([9600], np.int32))
        F = int(v1.sum())
        np.testing.assert_allclose(hz1[:F], hz2[0, :F], rtol=2e-5)

    def test_native_twin_mask_invariance_is_bitwise(self):
        sig = tone(150.0, n=9600)
        cfg = pitch.PitchConfig(lag_rate=0)
        hz1, _, v1 = track(sig, cfg=cfg)
        padded = np.concatenate(
            [sig, (10 * np.random.default_rng(3).standard_normal(6400))
             .astype(np.float32)])
        hz2, _, _ = track(padded[None], np.array([9600], np.int32), cfg)
        F = int(v1.sum())
        np.testing.assert_array_equal(hz1[:F], hz2[0, :F])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device"):
        pitch.track(np.zeros(8000, np.float32))
    with pytest.raises(RuntimeError, match="device"):
        pitch.StreamingPitchFeatures()
