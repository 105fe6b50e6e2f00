"""The staged kernels' plain twins against the Pallas kernels they replace.

``tpufeat.pallas.fused.dft_mel_log_dct`` (K3), ``mel_log_dct`` (K4) and
``spectro_features`` run in Pallas interpret mode on the CPU with
matmul_precision="highest", as ``tests/test_pallas.py`` runs them.

Tolerances, relative to max(1, |reference|.max()):
- twin vs the Pallas kernel: <= 1e-5 — the same fp32 math with the sums in
  another order, on broadband inputs (near the 1e-10 log floor the GEMM
  paths differ by ~1e-2, so no input sits there);
- the staged ``extract`` (bf16x3 flag, fp32 in the port) vs the float64
  golden: <= 1e-3, the repo's fidelity budget.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufeat.config import FeatureConfig as JConfig
from tpufeat.config import PRESETS as JPRESETS
from tpufeat.pallas import fused
from tpufeat.reference import cpu as jcpu

from tpufeat_torch import features, matrices
from tpufeat_torch.config import from_reference
from tpufeat_torch.kernels import signal, staged

CFGS = {
    "mfcc13": JPRESETS["mfcc13"],
    "fbank80": JPRESETS["fbank80"],
    "magnitude_lifter": JConfig(spectrum="magnitude", lifter=22),
    "whisper_mfcc": dataclasses.replace(JPRESETS["whisper80"], n_mfcc=13),
    "kaldi_dc": JConfig(kaldi_mode=True, dc_offset=True, window="povey"),
}
ROWS = [1, 7, 511, 512, 513]       # one, ragged, and around the 512 block
TOL = 1e-5


def _port(jcfg):
    return from_reference(dataclasses.asdict(jcfg))


def _highest(name):
    return dataclasses.replace(CFGS[name], matmul_precision="highest")


def _scaled_err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() \
        / max(1.0, np.abs(want).max())


def _frames(jcfg, rows, seed=0):
    return (np.random.default_rng(seed).standard_normal(
        (rows, jcfg.frame_length)) * 0.1).astype(np.float32)


def _spectrum_rows(jcfg, rows, seed=0):
    """Power (or magnitude) spectra of windowed noise frames: broadband."""
    w = matrices.window(jcfg.window, jcfg.frame_length)
    x = np.fft.rfft(_frames(jcfg, rows, seed) * w, n=jcfg.n_fft)
    p = x.real ** 2 + x.imag ** 2
    return (np.sqrt(p) if jcfg.spectrum == "magnitude" else p
            ).astype(np.float32)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("name", sorted(CFGS))
def test_dft_twin_matches_pallas_kernel(name, rows):
    jcfg = _highest(name)
    fr = _frames(jcfg, rows)
    want = np.asarray(fused.dft_mel_log_dct(jnp.asarray(fr), jcfg))
    got = staged.dft_mel_log_dct_reference(torch.from_numpy(fr), _port(jcfg))
    assert got.shape == want.shape
    assert _scaled_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("name", sorted(CFGS))
def test_tail_twin_matches_pallas_kernel(name, rows):
    jcfg = _highest(name)
    spec = _spectrum_rows(jcfg, rows, seed=1)
    want = np.asarray(fused.mel_log_dct(jnp.asarray(spec), jcfg))
    got = staged.mel_log_dct_reference(torch.from_numpy(spec), _port(jcfg))
    assert got.shape == want.shape
    assert _scaled_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("gemm_dft", [True, False], ids=["K3", "K4"])
@pytest.mark.parametrize("name", ["mfcc13", "whisper_mfcc",
                                  "magnitude_lifter"])
def test_spectro_features_matches_pallas(name, gemm_dft):
    """[B, F, fl] frames with a ragged mask (whisper's max sees valid
    frames only); valid frames compared."""
    jcfg = dataclasses.replace(_highest(name), use_pallas=True,
                               gemm_dft=gemm_dft)
    fr = _frames(jcfg, 2 * 37, seed=2).reshape(2, 37, -1)
    mask = np.ones((2, 37), bool)
    mask[1, 20:] = False
    fr[1, 20:] *= 50.0                # loud padding must not move the max
    want = np.asarray(fused.spectro_features(jnp.asarray(fr),
                                             jnp.asarray(mask), jcfg))
    got = staged.spectro_features(torch.from_numpy(fr),
                                  torch.from_numpy(mask), _port(jcfg))
    assert got.shape == want.shape
    assert _scaled_err(got.numpy()[mask], want[mask]) <= TOL


@pytest.mark.parametrize("route", [dict(gemm_dft=True), {}],
                         ids=["K3", "K4"])
@pytest.mark.parametrize("name", ["mfcc13", "whisper80", "fbank80"])
def test_staged_extract_matches_golden(name, route):
    jcfg = JPRESETS[name]
    cfg = dataclasses.replace(_port(jcfg), use_pallas=True,
                              matmul_precision="bf16x3", **route)
    lengths = np.array([16000, 9001])
    x = (np.random.default_rng(3).standard_normal((2, 16000)) * 0.1
         ).astype(np.float32)
    res = features.extract(x, lengths, cfg, device="cpu")
    for i, L in enumerate(lengths):
        gold = jcpu.extract(x[i, :L].astype(np.float64), jcfg)
        nf = int(res.num_frames[i])
        assert nf == gold.shape[0]
        assert _scaled_err(res.features[i, :nf].numpy(), gold) <= 1e-3


@pytest.mark.parametrize("kernel", ["dft_mel_log_dct", "mel_log_dct"])
def test_cpu_tensor_runs_the_twin(kernel):
    """A CPU tensor takes the twin and counts no launch."""
    cfg = _port(JPRESETS["mfcc13"])
    width = cfg.frame_length if kernel == "dft_mel_log_dct" else cfg.n_bins
    x = torch.from_numpy(np.abs(_frames(JPRESETS["mfcc13"], 3 * 5, seed=4)
                                )[:, :width].reshape(3, 5, width).copy())
    count = f"{kernel}_launches"
    before = getattr(staged, count)
    out = getattr(staged, kernel)(x, cfg)
    assert getattr(staged, count) == before
    assert out.shape == (3, 5, 13)
    torch.testing.assert_close(
        out, getattr(staged, f"{kernel}_reference")(x, cfg), rtol=0, atol=0)


@pytest.mark.parametrize("twin", ["signal", "dft", "tail"])
def test_twins_restore_the_tf32_flags(twin, monkeypatch):
    """A twin computes in full fp32 without changing the caller's TF32
    flags for good."""
    for mod in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(mod, "allow_tf32", True)
    cfg = _port(JPRESETS["mfcc13"])
    fr = torch.from_numpy(_frames(JPRESETS["mfcc13"], 4, seed=5))
    seen = []
    real_tail = signal.log_tail

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real_tail(*args)

    monkeypatch.setattr(signal, "log_tail", spy)
    if twin == "signal":
        signal.signal_features_reference(fr.reshape(1, -1), 4, cfg)
    elif twin == "dft":
        staged.dft_mel_log_dct_reference(fr, cfg)
    else:
        staged.mel_log_dct_reference(fr[:, :cfg.n_bins].abs(), cfg)
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("bad,exc", [
    (lambda x: x.to("meta"), ValueError),
    (lambda x: x[..., :-1], ValueError),
    (lambda x: x.to(torch.int32), TypeError),
], ids=["meta_device", "width", "int_dtype"])
@pytest.mark.parametrize("kernel", ["dft_mel_log_dct", "mel_log_dct"])
def test_wrapper_rejects_bad_input(kernel, bad, exc):
    cfg = _port(JPRESETS["mfcc13"])
    width = cfg.frame_length if kernel == "dft_mel_log_dct" else cfg.n_bins
    x = torch.ones(2, width)
    with pytest.raises(exc):
        getattr(staged, kernel)(bad(x), cfg)


def test_output_dims_and_empty_rows():
    """D: n_mfcc with a DCT, n_mels for log-mel and whisper (log10 out);
    zero rows give an empty result."""
    base = _port(JPRESETS["mfcc13"])
    spec = torch.ones(3, base.n_bins)
    assert staged.mel_log_dct(spec, base).shape == (3, 13)
    fbank = dataclasses.replace(base, n_mfcc=0)
    assert staged.mel_log_dct(spec, fbank).shape == (3, 26)
    whisper = dataclasses.replace(base, log="whisper")
    torch.testing.assert_close(
        staged.mel_log_dct(spec, whisper),
        torch.log10(torch.clamp(staged.mel_log_dct(
            spec, dataclasses.replace(fbank, log="none")), min=1e-10)))
    assert staged.dft_mel_log_dct(torch.ones(0, 7, 400), base).shape \
        == (0, 7, 13)


def test_staged_dft_matrix_does_not_fold_kaldi():
    """The staged kernel's frames arrive conditioned, so its CS is the
    plain windowed DFT; the signal kernel's folds the conditioning in."""
    cfg = _port(CFGS["kaldi_dc"])
    plain = matrices.dft_matrix_combined(cfg.frame_length, cfg.n_fft,
                                         cfg.window).astype(np.float32)
    np.testing.assert_array_equal(
        signal.cs_constant(cfg, fold_kaldi=False), plain)
    assert not np.array_equal(signal.cs_constant(cfg), plain)
