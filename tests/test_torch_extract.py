"""The port's ``extract`` against ``tpufeat.extract`` and the float64 golden.

Tolerances:
- against ``tpufeat.extract`` with the same flags: masks and num_frames
  exact; features <= 1e-4 abs on valid frames (the same fp32 math with a
  different summation order);
- against ``tpufeat.reference.cpu.extract`` (float64): <= 1e-3 relative to
  max(1, |gold|.max()), the repo's fidelity budget.
Frames past a row's num_frames are finite garbage in both packages and are
not compared. Inputs are broadband noise: near the 1e-10 log floor the GEMM
paths differ by ~1e-2.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpufeat import features as jfeat
from tpufeat import io as jio
from tpufeat.config import PRESETS as JPRESETS
from tpufeat.reference import cpu as jcpu

import tpufeat_torch
from tpufeat_torch import features as tfeat
from tpufeat_torch.config import from_reference
from tpufeat_torch.experiments import RUNNERS
from tpufeat_torch.reference import cpu as tcpu

# the main path's flags; the port computes every matmul_precision in fp32
FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True,
             matmul_precision="bf16x3")
LENGTHS = np.array([24000, 17001, 9001])     # ragged, <= 1.5 s at 16 kHz
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), int(lengths.max())), np.float32)
    for i, L in enumerate(lengths):
        x[i, :L] = rng.standard_normal(L) * 0.1
        x[i, L:] = rng.standard_normal(x.shape[1] - L)   # inert padding
    return x


def _port(jcfg):
    return from_reference(dataclasses.asdict(jcfg))


def _assert_golden(res, x, lengths, jcfg):
    for i, L in enumerate(lengths):
        gold = jcpu.extract(x[i, :L].astype(np.float64), jcfg)
        nf = int(res.num_frames[i])
        assert nf == gold.shape[0]
        got = res.features[i, :nf].double().numpy()
        assert np.abs(got - gold).max() / max(1.0, np.abs(gold).max()) \
            <= 1e-3


@pytest.mark.parametrize("flags",
                         [{}, dict(FUSED, matmul_precision="highest")],
                         ids=["plain", "fused"])
@pytest.mark.parametrize("name", ["mfcc13", "whisper80"])
def test_extract_matches_tpufeat_and_golden(name, flags):
    """The JAX side runs "highest" (its bf16x3 is itself ~2e-4 off fp32)."""
    jcfg = dataclasses.replace(JPRESETS[name], **flags)
    x = _batch()
    want = jfeat.extract(x, LENGTHS, jcfg)
    got = tfeat.extract(x, LENGTHS, _port(jcfg), device="cpu")
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.num_frames.numpy(),
                                  np.asarray(want.num_frames))
    assert got.num_frames.dtype == torch.int32
    assert got.features.shape == want.features.shape
    wf = np.asarray(want.features)
    for i, nf in enumerate(got.num_frames.tolist()):
        assert np.abs(got.features[i, :nf].numpy() - wf[i, :nf]).max() \
            <= 1e-4
    _assert_golden(got, x, LENGTHS, JPRESETS[name])


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("name", ["mfcc13", "whisper80"])
def test_every_precision_computes_fp32(name, precision):
    cfg = dataclasses.replace(_port(JPRESETS[name]), **FUSED)
    x = _batch(seed=10)
    want = tfeat.extract(x, LENGTHS, dataclasses.replace(
        cfg, matmul_precision="highest"), device="cpu")
    got = tfeat.extract(x, LENGTHS, dataclasses.replace(
        cfg, matmul_precision=precision), device="cpu")
    torch.testing.assert_close(got.features, want.features, rtol=0, atol=0)


@pytest.mark.parametrize("flags", [{}, FUSED, dict(gemm_dft=True)],
                         ids=["plain", "fused", "plain_gemm"])
@pytest.mark.parametrize("name", ["fbank80", "whisper128", "gfcc13"])
def test_other_presets_match_golden(name, flags):
    x = _batch(seed=1)
    cfg = dataclasses.replace(_port(JPRESETS[name]), **flags)
    _assert_golden(tfeat.extract(x, LENGTHS, cfg, device="cpu"), x, LENGTHS,
                   JPRESETS[name])


@pytest.mark.parametrize("variant", [
    dict(kaldi_mode=True, dc_offset=True, window="povey"),
    dict(kaldi_mode=True),
    dict(spectrum="magnitude"),
    dict(lifter=22),
    dict(log="log10"),
    dict(log="none"),
    dict(n_mfcc=13, log="whisper", n_mels=40),
], ids=["kaldi_dc", "kaldi_pre", "magnitude", "lifter", "log10",
        "log_none", "whisper_mfcc"])
@pytest.mark.parametrize("flags", [{}, FUSED], ids=["plain", "fused"])
def test_kernel_corners_match_golden(variant, flags):
    jcfg = dataclasses.replace(JPRESETS["mfcc13"], **variant)
    x = _batch(seed=2)
    cfg = dataclasses.replace(_port(jcfg), **flags)
    _assert_golden(tfeat.extract(x, LENGTHS, cfg, device="cpu"), x, LENGTHS,
                   jcfg)


@pytest.mark.parametrize("name", sorted(set(JPRESETS) - {"pncc13"}))
def test_golden_copy_matches_tpufeat_golden(name):
    """The port's float64 golden is the same numpy code: equal bits."""
    x = _batch(seed=11)[1, :LENGTHS[1]].astype(np.float64)
    np.testing.assert_array_equal(
        tcpu.extract(x, _port(JPRESETS[name])),
        jcpu.extract(x, JPRESETS[name]))


def test_golden_copy_refuses_pncc():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcpu.extract(np.zeros(4000), _port(JPRESETS["pncc13"]))


def test_padding_is_inert():
    cfg = dataclasses.replace(_port(JPRESETS["whisper80"]), **FUSED)
    x = _batch(seed=3)
    alone = tfeat.extract(x[1, :LENGTHS[1]], cfg=cfg, device="cpu")
    batch = tfeat.extract(x, LENGTHS, cfg, device="cpu")
    nf = int(alone.num_frames)
    torch.testing.assert_close(batch.features[1, :nf], alone.features,
                               rtol=0, atol=0)


def test_whisper_normalize_matches_tpufeat_with_masked_row():
    rng = np.random.default_rng(4)
    ls = rng.standard_normal((3, 20, 8)).astype(np.float32) * 5
    mask = np.ones((3, 20), bool)
    mask[1, 7:] = False
    mask[2] = False                    # every frame masked: the guard
    want = np.asarray(jfeat.whisper_normalize(ls, mask))
    got = tfeat.whisper_normalize(torch.from_numpy(ls),
                                  torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_input_promotion_and_squeeze():
    cfg = _port(JPRESETS["mfcc13"])
    x = _batch(seed=5)[0]
    pcm = np.round(x * 20000).astype(np.int16)
    a = tfeat.extract(pcm, cfg=cfg, device="cpu")
    b = tfeat.extract(pcm.astype(np.float32) / 32768.0, cfg=cfg, device="cpu")
    torch.testing.assert_close(a.features, b.features, rtol=0, atol=0)
    assert a.features.dim() == 2 and a.num_frames.dim() == 0
    f64 = tfeat.extract(x.astype(np.float64), cfg=cfg, device="cpu")
    assert f64.features.dtype == torch.float64
    fused = dataclasses.replace(cfg, **FUSED)
    assert tfeat.extract(x.astype(np.float64), cfg=fused,
                         device="cpu").features.dtype == torch.float32
    bf16 = dataclasses.replace(cfg, out_dtype="bfloat16")
    assert tfeat.extract(x, cfg=bf16, device="cpu").features.dtype \
        == torch.bfloat16


def test_tensor_input_stays_where_it_lives():
    cfg = _port(JPRESETS["mfcc13"])
    x = torch.from_numpy(_batch(seed=6)[:2])
    res = tfeat.extract(x, cfg=cfg, device="cpu")
    assert res.features.device == x.device
    torch.testing.assert_close(tfeat.extract(x, cfg=cfg, device="cpu")
                               .features, res.features, rtol=0, atol=0)
    with pytest.raises(ValueError, match="move it first"):
        tfeat.extract(x, cfg=cfg, device="meta")


@pytest.mark.parametrize("stage", ["frames", "spectrogram",
                                   "mel_spectrogram", "logmel", "mfcc"])
@pytest.mark.parametrize("name", ["mfcc13", "whisper80"])
def test_stage_api_matches_tpufeat(name, stage):
    jcfg = JPRESETS[name]
    x = _batch(seed=7)
    want, wmask = getattr(jfeat, stage)(x, LENGTHS, jcfg)
    got, mask = getattr(tfeat, stage)(x, LENGTHS, _port(jcfg), device="cpu")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    valid = mask.numpy()
    want, got = np.asarray(want)[valid], got.numpy()[valid]
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() / scale <= 1e-5


STAGED = {"staged_k3": dict(use_pallas=True, gemm_dft=True),
          "staged_k4": dict(use_pallas=True)}


def _assert_close_scaled(got, want, tol=1e-4):
    """Valid frames within ``tol`` relative to max(1, |want|.max()): the
    narrow low bands of 40- and 80-band banks sit near the log floor, where
    fp32 sums in another order move the log by ~1e-3 absolute."""
    wf = np.asarray(want.features)
    assert got.features.shape == wf.shape
    for i, nf in enumerate(got.num_frames.tolist()):
        err = np.abs(got.features[i, :nf].numpy() - wf[i, :nf]).max()
        assert err / max(1.0, np.abs(wf[i, :nf]).max()) <= tol


@pytest.mark.parametrize("route", sorted(STAGED))
@pytest.mark.parametrize("name", ["mfcc13", "whisper80", "fbank80",
                                  "gfcc13"])
def test_staged_routes_match_tpufeat(name, route):
    """``use_pallas`` without ``fused_framing``: frames, then the staged
    GEMM kernel (K3) or the rFFT and the tail kernel (K4); the JAX side
    runs them in Pallas interpret mode at "highest"."""
    jcfg = dataclasses.replace(JPRESETS[name], matmul_precision="highest",
                               **STAGED[route])
    x = _batch(seed=12)
    want = jfeat.extract(x, LENGTHS, jcfg)
    got = tfeat.extract(x, LENGTHS, _port(jcfg), device="cpu")
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    _assert_close_scaled(got, want)


@pytest.mark.parametrize("flags", [{}, FUSED, STAGED["staged_k3"],
                                   STAGED["staged_k4"]],
                         ids=["plain", "fused", "staged_k3", "staged_k4"])
@pytest.mark.parametrize("variant", [
    dict(use_energy=True),
    dict(use_energy=True, kaldi_mode=True, dc_offset=True, window="povey"),
    dict(use_energy=True, n_mfcc=0, n_mels=40),
], ids=["mfcc", "kaldi_mfcc", "fbank"])
def test_use_energy_matches_tpufeat_and_golden(variant, flags):
    """MFCC replaces c0 with the log frame energy; fbank prepends it."""
    jcfg = dataclasses.replace(JPRESETS["mfcc13"], **variant)
    x = _batch(seed=13)
    want = jfeat.extract(x, LENGTHS, dataclasses.replace(
        jcfg, **{**flags, "matmul_precision": "highest"}))
    got = tfeat.extract(x, LENGTHS, dataclasses.replace(_port(jcfg),
                                                        **flags), device="cpu")
    assert got.features.shape == (3, 148, jcfg.feature_dim)
    _assert_close_scaled(got, want)
    _assert_golden(got, x, LENGTHS, jcfg)


@pytest.mark.parametrize("change", [
    dict(deltas=True), dict(cmvn="mean"), dict(cmvn="sliding"),
    dict(n_mels=23, n_mfcc=0, log="none", plp_order=12),
    dict(n_mels=40, n_mfcc=0, log="none", pncc=True),
    dict(dither=1.0), dict(n_mels=0, n_mfcc=0),
], ids=["deltas", "cmvn", "sliding_cmvn", "plp", "pncc", "dither",
        "spectrogram"])
def test_unported_configs_raise(change):
    cfg = dataclasses.replace(_port(JPRESETS["mfcc13"]), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfeat.extract(_batch(seed=8)[:1, :4000], cfg=cfg, device="cpu")


def test_wav_roundtrip_matches_tpufeat(tmp_path):
    x = _batch(seed=9)[0, :4000]
    tpufeat_torch.write_wav(str(tmp_path / "a.wav"), x, 16000)
    jio.write_wav(str(tmp_path / "b.wav"), x, 16000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    got, rate = tpufeat_torch.read_wav(str(tmp_path / "a.wav"))
    want, _ = jio.read_wav(str(tmp_path / "a.wav"), native=False)
    assert rate == 16000
    np.testing.assert_array_equal(got, want)


def test_import_leaves_jax_and_tpufeat_out():
    runners = ", ".join(f"tpufeat_torch.experiments.{name}"
                        for name in RUNNERS)
    code = ("import sys, tpufeat_torch, tpufeat_torch.features, "
            "tpufeat_torch.kernels.signal, tpufeat_torch.kernels.staged, "
            "tpufeat_torch.kernels.anatomy, "
            "tpufeat_torch.streaming, tpufeat_torch.profile_stream, "
            f"tpufeat_torch.reference.cpu, {runners}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpufeat', 'benchmarks')]; "
            "assert not bad, bad; "
            "from tpufeat_torch.kernels import _build; "
            "assert _build.load.cache_info().currsize == 0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
