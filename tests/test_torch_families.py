"""The port's other front-end families against ``tpufeat`` and the float64
golden: PLP (``tpufeat_torch/plp.py``), PNCC (``tpufeat_torch/pncc.py``) with
the port's PNCC golden, spectrogram features (``n_mels=0``), dither, VTLN,
and PLP streaming.

Tolerances (the reference's own tests'):
- PLP against ``tpufeat.plp`` on the same energies and against
  ``tpufeat.extract``, plain path: 1e-4 abs (``tests/test_plp.py``);
- PLP against the golden, plain and fused at "highest": 2e-3 abs
  (``tests/test_plp.py:60-103``); fused at bf16x3: max 5e-3, median 2e-4,
  the on-chip budget of ``tests/test_tpu_smoke.py:317-345``;
- PNCC against the port's golden, plain and fused: 5e-5 abs
  (``tests/test_pncc.py:19-32``); the port's PNCC golden against
  ``tpufeat``'s: 1e-12 (both float64); a masked batch against each row
  alone: 1e-5 (``tests/test_pncc.py:34-53``);
- SPEC257 against the golden: 1e-3 (``tests/test_spectrogram_feats.py``);
  the log power spectrum without it: see
  :func:`test_log_power_spectrum_matches_golden_and_tpufeat`;
- VTLN FBANK80 against the golden at "highest": 1.2e-4 scaled by
  max(1, |gold|.max()), the "highest" contract of ``chip_smoke.py``;
- PLP streaming against ``extract_scan``, one-shot ``extract`` and
  ``tpufeat``'s streaming: 1e-5 scaled.
The fused flags run the signal kernel's plain twin here; the JAX side runs
its Pallas kernels in interpret mode, as its own tests do on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufeat import features as jfeat
from tpufeat import plp as jplp
from tpufeat import pncc as jpncc
from tpufeat import streaming as jstream
from tpufeat.config import PRESETS as JPRESETS
from tpufeat.reference import cpu as jcpu

from conftest import make_signal
from tpufeat_torch import features, plp, pncc, streaming
from tpufeat_torch.config import (FBANK80, PLP13, PNCC13, SPEC257,
                                  FeatureConfig)
from tpufeat_torch.kernels import signal as signal_kernel
from tpufeat_torch.reference import cpu

FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True)


def _jcfg(cfg):
    """The reference's config with the port config's fields."""
    from tpufeat.config import FeatureConfig as JConfig
    return JConfig(**dataclasses.asdict(cfg))


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _batch(lengths, seed=0):
    x = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = make_signal(n, seed=seed + i)
    return x, np.array(lengths)


# ---------------------------------------------------------------------------
# PLP
# ---------------------------------------------------------------------------

def test_durbin_solves_the_normal_equations():
    rng = np.random.default_rng(0)
    sig = np.convolve(rng.standard_normal(4096), [1.0, 0.8, 0.5, 0.2],
                      mode="same")
    r = np.correlate(sig, sig, "full")[len(sig) - 1:][:13] / len(sig)
    a, err = plp.durbin(torch.tensor(r, dtype=torch.float32), 12)
    a = a.double().numpy()
    R = np.array([[r[abs(i - j)] for j in range(12)] for i in range(12)])
    np.testing.assert_allclose(R @ a, r[1:13], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(err), r[0] - a @ r[1:13], rtol=1e-3)


@pytest.mark.parametrize("lifter", [0, 22])
def test_plp_from_energies_matches_tpufeat(lifter):
    cfg = dataclasses.replace(PLP13, lifter=lifter)
    e = np.random.default_rng(1).random((2, 40, 23)).astype(np.float32) \
        * 10.0 + 1e-3
    got = plp.plp_from_energies(torch.from_numpy(e), cfg).numpy()
    want = np.asarray(jplp.plp_from_energies(jnp.asarray(e), _jcfg(cfg)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_plp_idft_product_is_fp32_under_tf32():
    """The autocorrelation product runs in fp32 even when the caller
    allows TF32 (which keeps 10 mantissa bits, as a bf16 pass keeps 8)."""
    e = torch.rand(1, 50, 23) * 10 + 1e-3
    want = plp.plp_from_energies(e, PLP13)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = plp.plp_from_energies(e, PLP13)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("flags", [{}, FUSED], ids=["plain", "fused"])
def test_plp13_matches_tpufeat(flags):
    cfg = dataclasses.replace(PLP13, **flags)
    x, lengths = _batch([16000, 9000, 4321], seed=3)
    got = features.extract(x, lengths, cfg, device="cpu")
    want = jfeat.extract(x, lengths, _jcfg(cfg))
    np.testing.assert_array_equal(got.num_frames.numpy(),
                                  np.asarray(want.num_frames))
    m = got.mask.numpy()
    assert np.abs(got.features.numpy()[m]
                  - np.asarray(want.features)[m]).max() <= 1e-4


@pytest.mark.parametrize("flags", [{}, FUSED], ids=["plain", "fused"])
def test_plp13_batch_matches_golden(flags):
    cfg = dataclasses.replace(PLP13, **flags)
    x, lengths = _batch([16000, 9000, 4321], seed=3)
    res = features.extract(x, lengths, cfg, device="cpu")
    calls = 0
    for b, n in enumerate(lengths):
        gold = cpu.plp(x[b, :n].astype(np.float64), PLP13)
        nf = int(res.num_frames[b])
        assert nf == gold.shape[0]
        assert np.abs(res.features[b, :nf].numpy() - gold).max() < 2e-3
        calls += 1
    assert calls == 3


def test_plp13_fused_bf16x3_within_the_on_chip_budget():
    """bf16x3 behind the kernel (its twin here) with the IDFT pinned to
    fp32: max 5e-3 and median 2e-4 from the golden, the TPU's on-chip
    budget for the same precisions."""
    cfg = dataclasses.replace(PLP13, **FUSED, matmul_precision="bf16x3")
    sig = make_signal(16000, seed=60)
    got = features.extract(sig, cfg=cfg, device="cpu").features.numpy()
    err = np.abs(got - cpu.plp(sig.astype(np.float64), PLP13))
    assert err.max() < 5e-3 and np.median(err) < 2e-4


def test_plp_fused_runs_the_signal_kernel(monkeypatch):
    """PLP's fused route goes through the signal kernel's wrapper (log
    "none", 23 bands) and PLP takes its raw energies."""
    seen = []
    real = signal_kernel.signal_features

    def spy(buf, n_frames, cfg):
        out = real(buf, n_frames, cfg)
        seen.append((cfg.log, out.shape[-1]))
        return out
    monkeypatch.setattr(signal_kernel, "signal_features", spy)
    cfg = dataclasses.replace(PLP13, **FUSED)
    features.extract(make_signal(4000, seed=61), cfg=cfg, device="cpu")
    assert seen == [("none", 23)]


def test_plp_deltas_cmvn_and_lifter_match_golden():
    sig = make_signal(8000, seed=7)
    cfg = dataclasses.replace(PLP13, deltas=True, cmvn="mean")
    assert cfg.feature_dim == 39
    got = features.extract(sig, cfg=cfg, device="cpu").features.numpy()
    assert np.abs(got - cpu.extract(sig.astype(np.float64), cfg)).max() \
        < 2e-3
    cfg = dataclasses.replace(PLP13, lifter=22)
    got = features.extract(sig, cfg=cfg, device="cpu").features.numpy()
    assert np.abs(got - cpu.plp(sig.astype(np.float64), cfg)).max() < 2e-2


def test_plp_silence_is_finite():
    res = features.extract(np.zeros(8000, np.float32), cfg=PLP13,
                           device="cpu")
    assert torch.isfinite(res.features).all()


# ---------------------------------------------------------------------------
# PNCC and its golden
# ---------------------------------------------------------------------------

def test_pncc_golden_matches_tpufeat_golden():
    sig = make_signal(12000, seed=50).astype(np.float64)
    got = cpu.extract(sig, PNCC13)
    want = jcpu.extract(sig, JPRESETS["pncc13"])
    assert got.shape == (73, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("flags", [{}, FUSED], ids=["plain", "fused"])
def test_pncc13_matches_golden(flags):
    cfg = dataclasses.replace(PNCC13, **flags)
    sig = make_signal(16000, seed=51)
    got = features.extract(sig, cfg=cfg, device="cpu").features.numpy()
    want = cpu.extract(sig.astype(np.float64), PNCC13)
    assert got.shape == want.shape == (98, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("flags", [{}, FUSED], ids=["plain", "fused"])
def test_pncc13_matches_tpufeat(flags):
    cfg = dataclasses.replace(PNCC13, **flags)
    x, lengths = _batch([16000, 9600], seed=52)
    got = features.extract(x, lengths, cfg, device="cpu")
    want = jfeat.extract(x, lengths, _jcfg(cfg))
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(want.features), rtol=0, atol=5e-5)


def test_pncc_bf16x3_follows_tpufeat_through_a_switch_flip():
    """At bf16x3 the energies move by about 2^-16, enough to flip PNCC's
    excitation switch (Q >= 2 Qle) in a frame near it: on this draw of
    noise (the first 0.75 s of row 1 of ``chip_smoke.py``'s batch) frame
    66 lands 3.7e-2 from the golden, past the on-chip budget of 5e-3, in
    both packages; the port follows the reference there (1e-5)."""
    x = (np.random.default_rng(0).standard_normal((2, 480000)) * 0.1
         ).astype(np.float32)[1, :12000]
    cfg = dataclasses.replace(PNCC13, **FUSED, matmul_precision="bf16x3")
    got = features.extract(x, cfg=cfg, device="cpu").features.numpy()
    want = np.asarray(jfeat.extract(x, cfg=_jcfg(cfg)).features)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_pncc_masked_batch_matches_single():
    """Each row of a padded batch equals the row alone: the medium-time
    window is mask-aware, each row starts its carries at its own first
    valid frame and freezes them through padding, padding rows are 0."""
    a, b = make_signal(16000, seed=52), make_signal(9600, seed=53)
    pad = np.zeros((2, 16000), np.float32)
    pad[0], pad[1, :9600] = a, b
    res = features.extract(pad, np.array([16000, 9600]), PNCC13,
                           device="cpu")
    feats, nf = res.features.numpy(), res.num_frames.numpy()
    for row, sig in ((0, a), (1, b)):
        alone = features.extract(sig, cfg=PNCC13, device="cpu").features
        np.testing.assert_allclose(feats[row, : nf[row]], alone.numpy(),
                                   rtol=0, atol=1e-5)
    assert (feats[1, nf[1]:] == 0).all()


def test_pncc_from_power_matches_tpufeat_with_late_starts():
    """Rows whose first valid frame is not frame 0 (a mask with leading
    padding) start their recursions there, in both packages."""
    rng = np.random.default_rng(54)
    p = (rng.random((3, 30, 40)) * 5 + 1e-3).astype(np.float32)
    mask = np.ones((3, 30), bool)
    mask[1, :4] = False
    mask[2, 20:] = False
    got = pncc.pncc_from_power(torch.from_numpy(p), torch.from_numpy(mask),
                               PNCC13).numpy()
    want = np.asarray(jpncc.pncc_from_power(jnp.asarray(p),
                                            jnp.asarray(mask),
                                            _jcfg(PNCC13)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_pncc_scale_invariance():
    sig = make_signal(16000, seed=54)
    base = features.extract(sig, cfg=PNCC13, device="cpu").features
    scaled = features.extract(7.5 * sig, cfg=PNCC13, device="cpu").features
    torch.testing.assert_close(scaled, base, rtol=0, atol=1e-4)


def test_pncc_constants_are_the_reference_ones():
    for name in ("LAMBDA_A", "LAMBDA_B", "LAMBDA_T", "MU_T", "C_EXC",
                 "LAMBDA_MU", "POWER", "M_MED", "N_SPEC"):
        assert getattr(pncc, name) == getattr(jpncc, name)


# ---------------------------------------------------------------------------
# spectrogram features (n_mels=0)
# ---------------------------------------------------------------------------

def _spec_inputs():
    """The inputs of ``tests/test_spectrogram_feats.py::TestGoldenParity``."""
    sigs = [make_signal(16000, seed=s) for s in range(3)]
    sigs[1] = sigs[1][:9173]
    x = np.zeros((3, 16000), np.float32)
    for b, s in enumerate(sigs):
        x[b, : len(s)] = s
    return x, np.array([len(s) for s in sigs])


def test_spec257_matches_golden_and_tpufeat():
    x, lengths = _spec_inputs()
    res = features.extract(x, lengths, SPEC257, device="cpu")
    assert res.features.shape[-1] == 257
    for b, n in enumerate(lengths):
        gold = cpu.extract(x[b, :n].astype(np.float64), SPEC257)
        nf = int(res.num_frames[b])
        assert np.abs(res.features[b, :nf].numpy() - gold).max() <= 1e-3
    want = jfeat.extract(x, lengths, _jcfg(SPEC257))
    m = res.mask.numpy()
    assert _scaled(res.features.numpy()[m],
                   np.asarray(want.features)[m]) <= 1e-4


@pytest.mark.parametrize("gemm", [False, True], ids=["rfft", "gemm"])
def test_log_power_spectrum_matches_golden_and_tpufeat(gemm):
    """Without SPEC257's energy in element 0, the DC bin of a
    pre-emphasized frame sits 8 to 9 decades below the frame's peak, where
    an f32 transform's error, relative to the peak, is 1e-3 to 2e-3 of the
    log (the port's rfft and GEMM here; the reference's rfft 2e-4 to 9e-4
    on these inputs): the golden holds the power spectrum relative to each
    frame's peak, within 1e-6, and the reference's output within 2e-6
    (each f32 path within 1e-6 of the golden)."""
    cfg = FeatureConfig(n_mels=0, n_mfcc=0, gemm_dft=gemm)
    x, lengths = _spec_inputs()
    res = features.extract(x, lengths, cfg, device="cpu")
    assert res.features.shape[-1] == 257
    for b, n in enumerate(lengths):
        gold = np.exp(cpu.extract(x[b, :n].astype(np.float64), cfg))
        nf = int(res.num_frames[b])
        got = np.exp(res.features[b, :nf].double().numpy())
        peak = gold.max(axis=1, keepdims=True)
        assert (np.abs(got - gold) / peak).max() <= 1e-6
    want = np.exp(np.asarray(jfeat.extract(x, lengths, _jcfg(cfg)).features,
                             np.float64))
    got = np.exp(res.features.double().numpy())
    m = res.mask.numpy()
    peak = want.max(axis=-1, keepdims=True)
    assert (np.abs(got - want) / peak)[m].max() <= 2e-6   # two f32 paths


def test_spectrogram_energy_element():
    sig = make_signal(8000, seed=3)
    classic = FeatureConfig(n_mels=0, n_mfcc=0)
    cfg = dataclasses.replace(classic, use_energy=True)
    got = features.extract(sig, cfg=cfg, device="cpu").features.numpy()
    e = cpu.frame_energy(sig.astype(np.float64), cfg)
    np.testing.assert_allclose(got[:, 0], e, rtol=0, atol=1e-4)
    base = features.extract(sig, cfg=classic, device="cpu").features.numpy()
    np.testing.assert_array_equal(got[:, 1:], base[:, 1:])


def test_spectrogram_refuses_the_kernels():
    with pytest.raises(ValueError, match="use_pallas=False"):
        FeatureConfig(n_mels=0, n_mfcc=0, use_pallas=True)


# ---------------------------------------------------------------------------
# dither
# ---------------------------------------------------------------------------

DITHERED = dataclasses.replace(FBANK80, dither=1.0)


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def test_dither_same_seed_same_bits_other_seed_other_bits():
    x, lengths = _batch([8000, 6000], seed=70)
    a = features.extract(x, lengths, DITHERED, device="cpu",
                         generator=_gen(1)).features
    b = features.extract(x, lengths, DITHERED, device="cpu",
                         generator=_gen(1)).features
    c = features.extract(x, lengths, DITHERED, device="cpu",
                         generator=_gen(2)).features
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-3


def test_dither_is_noise_on_the_raw_samples():
    """extract(x, dither=d, g) == extract(x + d * n), n drawn from a clone
    of g, bit for bit."""
    x, lengths = _batch([8000, 6000], seed=71)
    d = 0.5
    cfg = dataclasses.replace(DITHERED, dither=d)
    g = _gen(3)
    clone = torch.Generator(device="cpu")
    clone.set_state(g.get_state())
    noisy = torch.from_numpy(x) + d * torch.randn(x.shape, generator=clone)
    got = features.extract(x, lengths, cfg, device="cpu", generator=g)
    want = features.extract(noisy, lengths, FBANK80, device="cpu")
    torch.testing.assert_close(got.features, want.features, rtol=0, atol=0)
    # and the noise is standard normal times d
    n = (noisy - torch.from_numpy(x)) / d
    assert abs(n.mean().item()) < 0.02 and abs(n.std().item() - 1) < 0.02


def test_dither_without_a_generator_raises():
    x = make_signal(4000, seed=72)
    with pytest.raises(ValueError, match="generator"):
        features.extract(x, cfg=DITHERED, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        features.extract_chunked(x[None], cfg=DITHERED, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        features.make_extractor(DITHERED, device="cpu")(x)
    with pytest.raises(ValueError, match="generator"):
        features.features_impl(torch.from_numpy(x)[None],
                               torch.tensor([4000]), DITHERED)
    run = features.make_extractor(DITHERED, device="cpu",
                                  generator=_gen(4))
    assert torch.isfinite(run(x).features).all()


def test_dither_extract_chunked_draws_per_slice_in_turn():
    x, lengths = _batch([8000, 6000, 7000], seed=73)
    got = features.extract_chunked(x, lengths, DITHERED, 2, device="cpu",
                                   generator=_gen(5)).features
    g = _gen(5)
    parts = [features.extract(x[r:r + 2], lengths[r:r + 2], DITHERED,
                              device="cpu", generator=g).features
             for r in (0, 2)]
    F = got.shape[1]
    want = torch.cat([torch.nn.functional.pad(
        p, (0, 0, 0, F - p.shape[1])) for p in parts])
    m = features.extract(x, lengths, FBANK80, device="cpu").mask
    torch.testing.assert_close(got[m], want[m], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# VTLN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [{}, FUSED], ids=["plain", "fused"])
def test_vtln_fbank80_matches_golden_and_tpufeat(flags):
    cfg = dataclasses.replace(FBANK80, vtln_warp=1.1, **flags)
    x, lengths = _batch([12000, 7000], seed=80)
    res = features.extract(x, lengths, cfg, device="cpu")
    for b, n in enumerate(lengths):
        gold = cpu.extract(x[b, :n].astype(np.float64), cfg)
        nf = int(res.num_frames[b])
        assert _scaled(res.features[b, :nf].numpy(), gold) <= 1.2e-4
    want = jfeat.extract(x, lengths, _jcfg(cfg))
    m = res.mask.numpy()
    assert _scaled(res.features.numpy()[m],
                   np.asarray(want.features)[m]) <= 1e-4


# ---------------------------------------------------------------------------
# PLP streaming, and what streaming refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [{}, FUSED], ids=["plain", "fused"])
def test_plp_streaming_matches_scan_one_shot_and_tpufeat(flags):
    cfg = dataclasses.replace(PLP13, **flags)
    sig = np.stack([make_signal(12800, seed=90), make_signal(12800,
                                                             seed=91)])
    fe = streaming.StreamingFrontend(cfg, batch_size=2, device="cpu")
    got = torch.cat([fe.process(sig[:, s: s + 3200])[0]
                     for s in range(0, 12800, 3200)], dim=1)
    scan = streaming.extract_scan(sig, cfg, chunk_len=3200, device="cpu")
    one = features.extract(sig, cfg=cfg, device="cpu").features
    assert _scaled(got, scan) <= 1e-5
    assert _scaled(got, one) <= 1e-5
    jfe = jstream.StreamingFrontend(_jcfg(cfg), batch_size=2)
    want = np.concatenate([np.asarray(jfe.process(sig[:, s: s + 3200])[0])
                           for s in range(0, 12800, 3200)], axis=1)
    assert _scaled(got, want) <= 1e-5


def test_spectrogram_streams():
    cfg = FeatureConfig(n_mels=0, n_mfcc=0)
    sig = make_signal(8000, seed=92)
    scan = streaming.extract_scan(sig, cfg, chunk_len=1600, device="cpu")
    one = features.extract(sig, cfg=cfg, device="cpu").features
    assert _scaled(scan, one) <= 1e-5


@pytest.mark.parametrize("cfg", [PNCC13, dataclasses.replace(FBANK80,
                                                             dither=1.0)],
                         ids=["pncc", "dither"])
def test_streaming_refuses_what_the_reference_refuses(cfg):
    """PNCC and dither: the reference's ValueError, word for word."""
    with pytest.raises(ValueError) as want:
        jstream.StreamingFrontend(_jcfg(cfg))
    with pytest.raises(ValueError) as got:
        streaming.StreamingFrontend(cfg, device="cpu")
    assert str(got.value) == str(want.value)
