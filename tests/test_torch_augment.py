"""The port's augmentation, VAD and endpointing (``tpufeat_torch/augment.py``)
against ``tpufeat.augment`` on the same input, against float64 and loop
oracles, and against itself across chunk plans. Mirrors
``tests/test_augment.py``.

SpecAugment draws from a ``torch.Generator``, so its masks are not the
reference's: it is held to the reference's invariants (padding untouched,
banded frequency masks, time masks inside the valid frames, the adaptive
budget, the mean fill) and to its mask statistics: over 400 draws on the
same batch, the mean shares of masked cells, of wholly masked frames and
of wholly masked columns within 0.03 of the reference's over 400 keys
(several standard errors of a mean of 400 draws).

Tolerances of the deterministic functions against the reference: the
VADs and the segments exactly (decisions; the energies are the same f32
sums to within roundoff far from the thresholds here); noise, reverb and
speed perturbation 1e-5 scaled by max(1, |want|.max()) (f32 FFTs and
sums in other orders); against the float64 oracles the reference's own
bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tpufeat import augment as jaugment

from conftest import make_signal
from tpufeat_torch import augment, features, streaming
from tpufeat_torch.config import FBANK80, MFCC13_HTK, WHISPER80


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


class TestSpecAugment:
    @staticmethod
    def _feats():
        x = np.zeros((2, 16000), np.float32)
        x[0] = make_signal(16000, seed=80)
        x[1, :9000] = make_signal(9000, seed=81)
        res = features.extract(x, np.array([16000, 9000]), FBANK80,
                               device="cpu")
        return res.features, res.num_frames

    def test_masks_applied_and_bounded(self):
        feats, nf = self._feats()
        out = augment.spec_augment(feats, nf, _gen(0))
        assert out.shape == feats.shape
        assert bool((out != feats).any(dim=-1).any())
        for b in range(2):
            assert torch.equal(out[b, nf[b]:], feats[b, nf[b]:])

    def test_freq_mask_is_banded(self):
        feats, nf = self._feats()
        out = augment.spec_augment(feats, nf, _gen(3), n_time_masks=0,
                                   fill="zero")
        for b in range(2):
            diff = (out[b, : nf[b]] != feats[b, : nf[b]]).numpy()
            cols = diff.any(axis=0)
            assert (diff == cols[None, :]).all()
            assert 0 < cols.sum() <= 2 * 27

    def test_time_mask_within_valid(self):
        feats, nf = self._feats()
        out = augment.spec_augment(feats, nf, _gen(5), n_freq_masks=0,
                                   fill="zero")
        for b in range(2):
            assert not bool((out[b] != feats[b]).any(dim=-1)[nf[b]:].any())

    def test_deterministic_per_generator_seed(self):
        feats, nf = self._feats()
        a = augment.spec_augment(feats, nf, _gen(7))
        b = augment.spec_augment(feats, nf, _gen(7))
        assert torch.equal(a, b)
        assert bool((a != augment.spec_augment(feats, nf, _gen(8))).any())

    def test_adaptive_time_width(self):
        feats = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (2, 200, 8)).astype(np.float32))
        nf = np.array([200, 20])
        for seed in range(20):
            aug = augment.spec_augment(feats, nf, _gen(seed),
                                       n_freq_masks=0, n_time_masks=1,
                                       time_width_ratio=0.25, fill="zero")
            for b, n in enumerate(nf):
                changed = np.flatnonzero(
                    (aug[b, :n] != feats[b, :n]).any(dim=-1).numpy())
                assert changed.size <= int(0.25 * n)
                assert torch.equal(aug[b, n:], feats[b, n:])

    def test_mean_fill_value(self):
        feats, nf = self._feats()
        out = augment.spec_augment(feats, nf, _gen(1), fill="mean")
        for b in range(2):
            diffs = out[b] != feats[b]
            if bool(diffs.any()):
                np.testing.assert_allclose(
                    out[b][diffs].numpy(),
                    feats[b, : nf[b]].mean().item(), rtol=1e-5)

    def test_all_padding_utterance_untouched(self):
        feats = torch.randn(2, 30, 5, generator=_gen(2))
        out = augment.spec_augment(feats, np.array([30, 0]), _gen(4))
        assert torch.equal(out[1], feats[1])
        with pytest.raises(ValueError, match="fill"):
            augment.spec_augment(feats, np.array([30, 0]), _gen(4),
                                 fill="noise")

    @pytest.mark.parametrize("kw", [{}, dict(time_width_ratio=0.2)],
                             ids=["fixed", "adaptive"])
    def test_mask_statistics_match_the_reference(self, kw):
        rng = np.random.default_rng(12)
        feats = rng.standard_normal((3, 120, 40)).astype(np.float32) + 5.0
        nf = np.array([120, 80, 35])
        kw = dict(kw, time_width=40, freq_width=10, fill="zero")
        valid = np.arange(120)[None, :] < nf[:, None]

        def shares(masked):                   # [B, T, D] bool
            cols = [masked[b, :n].all(axis=0).mean()
                    for b, n in enumerate(nf)]
            return np.array([masked[valid].mean(),
                             masked[valid].all(axis=-1).mean(),
                             np.mean(cols)])
        port = np.mean([shares(_np(augment.spec_augment(
            torch.from_numpy(feats), nf, _gen(s), **kw)) == 0)
            for s in range(400)], axis=0)
        f = jnp.asarray(feats)
        ref = np.mean([shares(np.asarray(jaugment.spec_augment(
            f, jnp.asarray(nf), jax.random.PRNGKey(s), **kw)) == 0)
            for s in range(400)], axis=0)
        np.testing.assert_allclose(port, ref, atol=0.03)


class TestEnergyVad:
    def test_speech_vs_silence(self):
        sig = np.zeros(16000, np.float32)
        sig[3200:8000] = make_signal(4800, seed=90)
        sig += 1e-5 * np.random.default_rng(0).standard_normal(16000).astype(
            np.float32)
        vad = _np(augment.energy_vad(sig[None], np.array([16000]),
                                     device="cpu"))[0]
        first_in, last_in = 3200 // 160 + 1, (8000 - 400) // 160 - 1
        assert vad[first_in: last_in].all()
        assert not vad[last_in + 10:].any()
        np.testing.assert_array_equal(vad, np.asarray(jaugment.energy_vad(
            sig[None], np.array([16000])))[0])

    def test_padding_masked(self):
        x = np.zeros((1, 16000), np.float32)
        x[0, :8000] = make_signal(8000, seed=91)
        vad = _np(augment.energy_vad(x, np.array([8000]), device="cpu"))[0]
        nf = dataclasses.replace(MFCC13_HTK, preemphasis=0.0).num_frames(8000)
        assert not vad[nf:].any() and vad[:nf].any()
        np.testing.assert_array_equal(vad, np.asarray(jaugment.energy_vad(
            x, np.array([8000])))[0])


class TestAddNoise:
    def test_target_snr_achieved(self):
        rng = np.random.default_rng(50)
        x = rng.standard_normal((3, 8000)).astype(np.float32)
        v = rng.standard_normal((3, 8000)).astype(np.float32)
        lens = np.asarray([8000, 5000, 1000])
        for snr in (0.0, 10.0, 20.0):
            y = _np(augment.add_noise(x, v, lens, snr, device="cpu"))
            d = y - x
            m = np.arange(8000) < lens[:, None]
            got = 10 * np.log10((x * x * m).sum(1) / (d * d * m).sum(1))
            np.testing.assert_allclose(got, snr, atol=1e-3)
            assert (d[1, 5000:] == 0).all() and (d[2, 1000:] == 0).all()
            assert _scaled(y, jaugment.add_noise(x, v, lens, snr)) <= 1e-5

    def test_per_utterance_snr_and_silence(self):
        rng = np.random.default_rng(51)
        x = rng.standard_normal((2, 4000)).astype(np.float32)
        x[1] = 0.0
        v = rng.standard_normal((2, 4000)).astype(np.float32)
        y = _np(augment.add_noise(x, v, np.asarray([4000, 4000]),
                                  np.asarray([5.0, 5.0]), device="cpu"))
        d = y - x
        np.testing.assert_allclose(
            10 * np.log10((x[0] ** 2).sum() / (d[0] ** 2).sum()), 5.0,
            atol=1e-3)
        assert (y[1] == 0).all()


class TestSpeechSegments:
    def test_basic_runs_and_gap_bridging(self):
        f = np.zeros(200, bool)
        f[10:50] = f[60:100] = f[150:190] = True
        assert augment.speech_segments(f, pad=0) == [(10, 100), (150, 190)]

    def test_min_speech_drop_and_padding(self):
        f = np.zeros(100, bool)
        f[5:8] = f[40:60] = True
        assert augment.speech_segments(f, min_silence=10, pad=5) == \
            [(35, 65)]

    def test_padding_clamped_and_merge_after_pad(self):
        f = np.zeros(60, bool)
        f[0:15] = f[22:40] = True
        assert augment.speech_segments(f, min_silence=5, min_speech=5,
                                       pad=4) == [(0, 44)]
        assert augment.speech_segments(np.zeros(60, bool)) == []
        assert augment.speech_segments(np.ones(60, bool), pad=9) == [(0, 60)]

    def test_batched_and_samples(self):
        f = np.zeros((2, 100), bool)
        f[0, 20:50] = True
        per_row = augment.speech_segments(torch.from_numpy(f), pad=0)
        assert per_row[0] == [(20, 50)] and per_row[1] == []
        assert augment.segments_to_samples(per_row[0], MFCC13_HTK) == \
            [(20 * 160, 49 * 160 + 400)]
        assert augment.segments_to_samples([(0, 10), (20, 50)],
                                           WHISPER80) == [
            (0, 9 * 160 + 200), (20 * 160 - 200, 49 * 160 + 200)]

    def test_composes_with_energy_vad(self):
        rng = np.random.default_rng(9)
        x = 1e-4 * rng.standard_normal(48000).astype(np.float32)
        tone = 0.5 * np.sin(2 * np.pi * 440 * np.arange(8000) / 16000
                            ).astype(np.float32)
        x[8000:16000] += tone
        x[32000:40000] += tone
        mask = augment.energy_vad(x[None], np.array([48000]),
                                  device="cpu")[0]
        segs = augment.speech_segments(mask)
        assert segs == jaugment.speech_segments(np.asarray(
            jaugment.energy_vad(x[None], np.array([48000])))[0])
        (s0, e0), (s1, e1) = augment.segments_to_samples(segs, MFCC13_HTK)
        assert s0 <= 8000 < 16000 <= e0 + 400
        assert s1 <= 32000 < 40000 <= e1 + 400


class TestStreamingEndpointer:
    def test_silence_only_rule_fires_at_5s(self):
        ep = augment.StreamingEndpointer()
        assert not ep.update(np.zeros((1, 499), bool))[0]
        assert ep.update(np.zeros((1, 1), bool))[0]

    def test_trailing_silence_after_speech(self):
        ep = augment.StreamingEndpointer()
        flags = np.zeros((1, 50), bool)
        flags[0, :30] = True
        assert not ep.update(flags)[0]
        assert not ep.update(np.zeros((1, 79), bool))[0]
        assert ep.update(np.zeros((1, 1), bool))[0]

    def test_max_length_rule(self):
        ep = augment.StreamingEndpointer()
        assert not ep.update(np.ones((1, 1999), bool))[0]
        assert ep.update(np.ones((1, 1), bool))[0]

    def test_chunk_plan_invariance_and_the_reference(self):
        flags = np.random.default_rng(7).random(997) < 0.3
        one = augment.StreamingEndpointer()
        one.update(flags[None])
        many = augment.StreamingEndpointer()
        ref = jaugment.StreamingEndpointer()
        i = 0
        for step in [1, 7, 13, 160, 816]:
            np.testing.assert_array_equal(
                many.update(torch.from_numpy(flags[None, i:i + step])),
                ref.update(flags[None, i:i + step]))
            i += step
        for k in ("frames_seen", "trailing_silence", "seen_speech"):
            np.testing.assert_array_equal(one.state()[k], many.state()[k])
            np.testing.assert_array_equal(ref.state()[k], many.state()[k])

    def test_batch_rows_and_reset(self):
        ep = augment.StreamingEndpointer(batch_size=2)
        flags = np.zeros((2, 150), bool)
        flags[0, :40] = True
        done = ep.update(flags)
        assert done[0] and not done[1]
        ep.reset(0)
        assert not ep.decision()[0]
        assert not ep.state()["seen_speech"][1]

    def test_state_roundtrip_and_empty_update(self):
        ep = augment.StreamingEndpointer()
        ep.update(np.ones((1, 30), bool))
        s = ep.state()
        ep2 = augment.StreamingEndpointer()
        ep2.set_state(s)
        np.testing.assert_array_equal(ep2.update(np.zeros((1, 0), bool)),
                                      ep.decision())

    def test_composes_with_streaming_vad(self):
        rng = np.random.default_rng(8)
        x = 1e-4 * rng.standard_normal(40000).astype(np.float32)
        x[:16000] += 0.5 * np.sin(2 * np.pi * 440 * np.arange(16000)
                                  / 16000).astype(np.float32)
        vad = augment.StreamingEnergyVAD(device="cpu")
        ep = augment.StreamingEndpointer()
        fired_at = None
        for i in range(0, 40000, 1600):
            if ep.update(vad.process(x[None, i:i + 1600]))[0]:
                fired_at = i + 1600
                break
        assert fired_at is not None and 26000 <= fired_at <= 36000

    def test_validation(self):
        with pytest.raises(ValueError):
            augment.StreamingEndpointer(rules=())
        with pytest.raises(ValueError):
            augment.StreamingEndpointer(batch_size=2).update(
                np.zeros((3, 10), bool))

    def test_reset_rows_matches_reset(self):
        ep = augment.StreamingEndpointer(batch_size=3)
        flags = np.zeros((3, 120), bool)
        flags[:, :20] = True
        ep.update(flags)
        ep.reset_rows([0, 2])
        s = ep.state()
        np.testing.assert_array_equal(s["frames_seen"], [0, 120, 0])
        np.testing.assert_array_equal(s["seen_speech"], [False, True, False])
        np.testing.assert_array_equal(s["trailing_silence"], [0, 100, 0])


def _numpy_reverb(x, h, lengths, shift_to_peak=True, normalize=True):
    """float64 np.convolve oracle of add_reverb (the reference test's)."""
    B, N = x.shape
    out = np.zeros((B, N))
    for b in range(B):
        xm = np.where(np.arange(N) < lengths[b], x[b], 0.0).astype(
            np.float64)
        y = np.convolve(xm, h[b].astype(np.float64))
        d = int(np.argmax(np.abs(h[b]))) if shift_to_peak else 0
        y = np.where(np.arange(N) < lengths[b], y[d:d + N], 0.0)
        if normalize:
            p_in, p_out = np.sum(xm * xm), np.sum(y * y)
            y = y * (np.sqrt(p_in / p_out) if p_out > 0 else 0.0)
        out[b] = y
    return out


def _reverb(x, h, lengths, **kw):
    return _np(augment.add_reverb(x, h, lengths, device="cpu", **kw))


class TestAddReverb:
    def test_identity_rir(self):
        x = np.random.default_rng(0).standard_normal((2, 4000)).astype(
            np.float32)
        lengths = np.array([4000, 3200])
        h = np.zeros(64, np.float32)
        h[0] = 1.0
        m = np.arange(4000) < lengths[:, None]
        np.testing.assert_allclose(_reverb(x, h, lengths),
                                   np.where(m, x, 0.0), atol=2e-5)

    def test_golden_parity_per_utterance_rirs(self):
        rng = np.random.default_rng(1)
        B, N, R = 3, 7000, 513
        x = rng.standard_normal((B, N)).astype(np.float32)
        lengths = np.array([7000, 5000, 1])
        h = (rng.standard_normal((B, R))
             * np.exp(-np.arange(R) / 80.0)).astype(np.float32)
        h[:, :5] = 0.0
        h[np.arange(B), [5, 17, 40]] = 3.0
        y = _reverb(x, h, lengths)
        ref = _numpy_reverb(x, h, lengths)
        assert np.max(np.abs(y - ref)) < 2e-3 * max(1.0, np.abs(ref).max())
        assert _scaled(y, jaugment.add_reverb(x, h, lengths)) <= 1e-5

    def test_delayed_delta_realigns(self):
        x = np.random.default_rng(2).standard_normal((1, 3000)).astype(
            np.float32)
        h = np.zeros(200, np.float32)
        h[77] = 0.5
        np.testing.assert_allclose(_reverb(x, h, np.array([3000]))[0], x[0],
                                   atol=2e-4)

    def test_no_shift_keeps_delay(self):
        x = np.zeros((1, 100), np.float32)
        x[0, 10] = 1.0
        h = np.zeros(32, np.float32)
        h[7] = 1.0
        y = _reverb(x, h, np.array([100]), shift_to_peak=False,
                    normalize=False)
        assert abs(y[0, 17] - 1.0) < 1e-5 and abs(y[0, 10]) < 1e-5

    def test_padding_untouched_and_silence_safe(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 2000)).astype(np.float32)
        y = _reverb(x, rng.standard_normal(128).astype(np.float32),
                    np.array([1500, 0]))
        assert np.all(y[0, 1500:] == 0.0) and np.all(y[1] == 0.0)

    @given(n=st.integers(300, 5000), r=st.integers(1, 300),
           lfrac=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 31))
    @settings(max_examples=20, deadline=None)
    def test_property_random_geometry(self, n, r, lfrac, seed):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((1, n)).astype(np.float32)
        h = rng.standard_normal(r).astype(np.float32)
        lengths = np.array([int(round(lfrac * n))])
        y = _reverb(x, h, lengths)
        ref = _numpy_reverb(x, h[None], lengths)
        assert np.max(np.abs(y - ref)) < 2e-3 * max(1.0, np.abs(ref).max())
        assert np.all(y[0, lengths[0]:] == 0.0)

    def test_normalize_preserves_power(self):
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 5000)).astype(np.float32)
        lengths = np.array([5000, 4096])
        h = (rng.standard_normal((2, 300))
             * np.exp(-np.arange(300) / 50.0)).astype(np.float32)
        y = _reverb(x, h, lengths)
        for b in range(2):
            np.testing.assert_allclose(
                np.sum(np.square(y[b], dtype=np.float64)),
                np.sum(np.square(x[b, :lengths[b]], dtype=np.float64)),
                rtol=1e-3)


class TestSpeedPerturb:
    def test_length_and_pitch_shift(self):
        t = np.arange(16000) / 16000
        x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)[None]
        for factor in (0.9, 1.1):
            y = _np(augment.speed_perturb(x, 16000, factor, device="cpu"))[0]
            assert abs(y.shape[0] - round(16000 / factor)) <= 2
            spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
            assert abs(np.argmax(spec) * 16000 / len(y) - 440.0 * factor) \
                < 5.0
            want = np.asarray(jaugment.speed_perturb(x, 16000, factor))[0]
            assert _scaled(y, want) <= 1e-5

    def test_identity_and_validation(self):
        x = np.zeros((1, 100), np.float32)
        assert tuple(augment.speed_perturb(x, 16000, 1.0,
                                           device="cpu").shape) == (1, 100)
        _, l2 = augment.speed_perturb(x, 16000, 1.0, lengths=np.array([70]),
                                      device="cpu")
        np.testing.assert_array_equal(_np(l2), [70])
        with pytest.raises(ValueError, match="integral"):
            augment.speed_perturb(x, 16000, 1.0001, device="cpu")

    def test_padded_batch_with_lengths(self):
        rng = np.random.default_rng(11)
        a = rng.standard_normal(16000).astype(np.float32)
        b = rng.standard_normal(11000).astype(np.float32)
        x = np.zeros((2, 16000), np.float32)
        x[0], x[1, :11000] = a, b
        y, nl = augment.speed_perturb(x, 16000, 0.9,
                                      lengths=np.array([16000, 11000]),
                                      device="cpu")
        y, nl = _np(y), _np(nl)
        for sig, n, row in [(a, 16000, 0), (b, 11000, 1)]:
            lone = _np(augment.speed_perturb(sig[None], 16000, 0.9,
                                             device="cpu"))[0]
            assert nl[row] == lone.shape[0] == -(-n * 10 // 9)
            np.testing.assert_array_equal(y[row, : nl[row]],
                                          lone[: nl[row]])


def _speech_like(n=16000, seed=60, loud_first=False):
    rng = np.random.default_rng(seed)
    x = 0.001 * rng.standard_normal(n).astype(np.float32)
    a, b = (0, n // 4) if loud_first else (n // 2, 3 * n // 4)
    x[a:b] += 0.5 * np.sin(2 * np.pi * 220 * np.arange(b - a) / 16000
                           ).astype(np.float32)
    return x


def _vad_run(v, x, plan, reset_at=None):
    outs, pos = [], 0
    for i, c in enumerate(plan):
        outs.append(_np(v.process(x[:, pos:pos + c])))
        pos += c
        if i == reset_at:
            v.reset_rows([0])
    return np.concatenate(outs, axis=1)


class TestStreamingEnergyVAD:
    def test_chunk_plan_invariance(self):
        x = _speech_like()[None]
        rows = [_vad_run(augment.StreamingEnergyVAD(device="cpu"), x, plan)
                for plan in ([16000], [160] * 100, [37, 4000, 1, 11962],
                             [7000, 9000])]
        for r in rows[1:]:
            np.testing.assert_array_equal(r, rows[0])
        ref = jaugment.StreamingEnergyVAD()
        want = np.concatenate([np.asarray(ref.process(x[:, i:i + 1600]))
                               for i in range(0, 16000, 1600)], axis=1)
        np.testing.assert_array_equal(rows[0], want)

    def test_matches_offline_when_peak_first(self):
        x = _speech_like(loud_first=True)
        want = _np(augment.energy_vad(x[None], np.asarray([len(x)]),
                                      device="cpu"))
        got = _vad_run(augment.StreamingEnergyVAD(device="cpu"), x[None],
                       [3200] * 5)
        assert got.shape[1] > 0
        np.testing.assert_array_equal(got, want[:, :got.shape[1]])

    def test_only_more_permissive_early(self):
        x = _speech_like(loud_first=False)
        want = _np(augment.energy_vad(x[None], np.asarray([len(x)]),
                                      device="cpu"))
        got = _vad_run(augment.StreamingEnergyVAD(device="cpu"), x[None],
                       [1600] * 10)
        F = got.shape[1]
        assert (want[:, :F] & ~got).sum() == 0
        frame_e = np.asarray([(x[t * 160: t * 160 + 400] ** 2).sum()
                              for t in range(F)])
        peak_t = int(np.argmax(frame_e))
        np.testing.assert_array_equal(got[:, peak_t:F], want[:, peak_t:F])

    def test_reset_rows_zeros_prefix_decisions(self):
        plan = [1600, 4800, 1600, 4800, 3200]
        x = np.stack([_speech_like(seed=62, loud_first=True),
                      _speech_like(seed=63)])
        ref = _vad_run(augment.StreamingEnergyVAD(2, device="cpu"), x, plan)
        got = _vad_run(augment.StreamingEnergyVAD(2, device="cpu"), x, plan,
                       reset_at=1)
        np.testing.assert_array_equal(got[1], ref[1])
        xz = x.copy()
        xz[0, :sum(plan[:2])] = 0.0
        oracle = _vad_run(augment.StreamingEnergyVAD(2, device="cpu"), xz,
                          plan)
        f_pre = 1 + (sum(plan[:2]) - 400) // 160
        np.testing.assert_array_equal(got[0, f_pre:], oracle[0, f_pre:])
        assert got[0, f_pre:].any() and not ref[0, f_pre:].any()

    def test_state_roundtrip(self, tmp_path):
        x = _speech_like(seed=61)
        v1 = augment.StreamingEnergyVAD(device="cpu")
        out1 = v1.process(x[None, :7000])
        p = str(tmp_path / "vad.npz")
        streaming.save_state(p, v1.state())
        v2 = augment.StreamingEnergyVAD(device="cpu")
        v2.set_state(streaming.load_state(p, v2.state()))
        a, b = v1.process(x[None, 7000:]), v2.process(x[None, 7000:])
        assert torch.equal(a, b)
        assert out1.shape[1] + a.shape[1] == 1 + (16000 - 400) // 160


class TestKaldiVad:
    @staticmethod
    def _oracle(e, n, thr, scale, ctx, prop):
        e = np.asarray(e, np.float64)
        out = np.zeros(e.shape, bool)
        for b in range(e.shape[0]):
            T = int(n[b])
            if T == 0:
                continue
            t0 = thr + scale * e[b, :T].mean()
            for t in range(T):
                lo, hi = max(0, t - ctx), min(T - 1, t + ctx)
                num = (e[b, lo:hi + 1] > t0).sum()
                out[b, t] = num >= prop * (hi - lo + 1)
        return out

    @pytest.mark.parametrize("ctx,prop", [(0, 0.6), (2, 0.6), (5, 0.3)])
    def test_matches_oracle(self, ctx, prop):
        e = np.random.default_rng(ctx).normal(3.0, 4.0, (3, 40)).astype(
            np.float32)
        n = np.array([40, 25, 7])
        got = _np(augment.kaldi_vad(e, n, frames_context=ctx,
                                    proportion_threshold=prop,
                                    device="cpu"))
        np.testing.assert_array_equal(got, self._oracle(e, n, 5.0, 0.5, ctx,
                                                        prop))
        np.testing.assert_array_equal(got, np.asarray(jaugment.kaldi_vad(
            e, n, frames_context=ctx, proportion_threshold=prop)))
        assert not got[1, 25:].any() and not got[2, 7:].any()

    def test_mean_scale_and_threshold(self):
        e = np.array([[0.0, 10.0, 10.0, 0.0]])
        np.testing.assert_array_equal(
            _np(augment.kaldi_vad(e, device="cpu"))[0],
            [False, True, True, False])
        assert bool(augment.kaldi_vad(e, energy_mean_scale=0.0,
                                      energy_threshold=-1.0,
                                      device="cpu").all())

    def test_single_track_1d(self):
        assert tuple(augment.kaldi_vad(np.array([0.0, 10.0, 10.0, 0.0]),
                                       device="cpu").shape) == (4,)

    def test_c0_from_extract(self):
        sig = np.zeros((2, 8000), np.float32)
        sig[0] = make_signal(8000, seed=1)
        sig[1, :6400] = make_signal(6400, seed=2)
        res = features.extract(sig, np.array([8000, 6400]), MFCC13_HTK,
                               device="cpu")
        v = augment.kaldi_vad(res.features[..., 0], res.num_frames)
        assert v.shape == res.features.shape[:2]
        assert bool(v.any(dim=1).all())

    def test_scalar_count_for_single_track(self):
        got = _np(augment.kaldi_vad(np.array([0.0, 10.0, 10.0, 0.0, 5.0]),
                                    4, device="cpu"))
        assert got.shape == (5,) and not got[4]


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device"):
        augment.energy_vad(np.zeros((1, 800), np.float32), [800])
    with pytest.raises(RuntimeError, match="device"):
        augment.StreamingEnergyVAD()
