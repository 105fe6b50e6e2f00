"""The staged kernels' plain twins against the Pallas kernels they replace.

``tpufeat.pallas.fused.dft_mel_log_dct`` (K3), ``mel_log_dct`` (K4) and
``spectro_features`` run in Pallas interpret mode on the CPU with
matmul_precision="highest", as ``tests/test_pallas.py`` runs them, and at
bf16x3.

Tolerances, relative to max(1, |reference|.max()):
- twin vs the Pallas kernel at "highest": <= 1e-5 — the interpreter's f32
  against the twin's six bf16 passes (the TPU's form, within about 1e-6 of
  f32), with the sums in another order, on broadband inputs (near the
  1e-10 log floor the GEMM paths differ by ~1e-2, so no input sits there);
- K4's twin vs the Pallas kernel at bf16x3: <= 1e-6 — the same split
  products in both (an fp32 mel product misses it by 3.6e-6 on MFCC-13);
- the staged ``extract`` at "highest" vs the float64 golden: <= 1e-3, the
  repo's fidelity budget. Not at bf16x3: its 16-bit operands miss the
  budget several times over on fbank80, whose lowest band sits on the DC
  bin after pre-emphasis, in the JAX package's bf16x3 too
  (test_bf16x3_fbank80_misses_the_budget_as_tpufeat_does), so bf16x3 is
  held to the golden where it meets it (MFCC-13, Whisper-80) and to the
  JAX package's bf16x3 everywhere.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufeat.config import FeatureConfig as JConfig
from tpufeat.config import PRESETS as JPRESETS
from tpufeat import features as jfeatures
from tpufeat.pallas import fused
from tpufeat.reference import cpu as jcpu

from tpufeat_torch import features, matrices
from tpufeat_torch.config import from_reference
from tpufeat_torch.kernels import _tolerance as tolerance, signal, staged

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
                              matmul_precision="highest", **route)
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
    count = {"dft_mel_log_dct": "dft_mel_log_dct_mma_launches",
             "mel_log_dct": "mel_log_dct_launches"}[kernel]
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


# ---------------------------------------------------------------------------
# K3 at bf16x3 and default: the twin of the tensor-core route
# ---------------------------------------------------------------------------
# As in tests/test_torch_signal.py: bf16x3 is the same function in both
# packages, held at 1e-4 relative to max(1, |want|) (hi + lo keeps 16-17
# bits, so another sum order moves what the split drops by up to 2^-17 of a
# term) and to the golden at 5e-4 scaled; "default" against the numpy
# one-pass oracle within tolerance.twin_tolerance.

import _one_pass  # noqa: E402


@pytest.mark.parametrize("rows", [1, 7, 513])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_bf16x3_dft_twin_matches_pallas_kernel(name, rows):
    jcfg = dataclasses.replace(CFGS[name], matmul_precision="bf16x3")
    fr = _frames(jcfg, rows, seed=6)
    want = np.asarray(fused.dft_mel_log_dct(jnp.asarray(fr), jcfg))
    got = staged.dft_mel_log_dct_reference(torch.from_numpy(fr), _port(jcfg))
    assert got.shape == want.shape
    assert _scaled_err(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("name", ["mfcc13", "whisper80"])
def test_bf16x3_staged_extract_matches_golden(name):
    jcfg = JPRESETS[name]
    cfg = dataclasses.replace(_port(jcfg), use_pallas=True, gemm_dft=True,
                              matmul_precision="bf16x3")
    x = (np.random.default_rng(7).standard_normal((1, 16000)) * 0.1
         ).astype(np.float32)
    res = features.extract(x, cfg=cfg, device="cpu")
    gold = jcpu.extract(x[0].astype(np.float64), jcfg)
    assert _scaled_err(res.features[0].numpy(), gold) < 5e-4


@pytest.mark.parametrize("name", sorted(CFGS))
def test_default_dft_twin_matches_one_pass_oracle(name):
    cfg = dataclasses.replace(_port(CFGS[name]), matmul_precision="default")
    fr = _frames(CFGS[name], 64, seed=8)
    want = torch.from_numpy(_one_pass.features(fr, cfg, fold_kaldi=False))
    got = staged.dft_mel_log_dct_reference(torch.from_numpy(fr), cfg)
    tolerance.compare_to_twin(got, want, torch.from_numpy(fr), cfg,
                           fold_kaldi=False, what=name)


def test_bf16x3_fbank80_misses_the_budget_as_tpufeat_does():
    """bf16x3 keeps 16 bits of each operand, and fbank80's lowest band
    rests on the DC bin, which pre-emphasis all but removes: both packages'
    bf16x3 miss the 1e-3 golden budget there by the same amount (within 5 %:
    that band magnifies another sum order too), while "highest" meets it
    (test_staged_extract_matches_golden)."""
    jcfg = dataclasses.replace(JPRESETS["fbank80"], use_pallas=True,
                               gemm_dft=True, matmul_precision="bf16x3")
    x = (np.random.default_rng(3).standard_normal(16000) * 0.1
         ).astype(np.float32)
    gold = jcpu.extract(x.astype(np.float64), JPRESETS["fbank80"])
    jax_err = _scaled_err(np.asarray(jfeatures.extract(x, cfg=jcfg)
                                     .features), gold)
    port_err = _scaled_err(features.extract(x, cfg=_port(jcfg),
                                            device="cpu").features.numpy(),
                           gold)
    assert jax_err > 5e-3 and port_err > 5e-3
    assert abs(port_err - jax_err) <= 0.05 * jax_err


# ---------------------------------------------------------------------------
# K4 at every precision: the twin of the tensor-core tail kernel
# ---------------------------------------------------------------------------
# The TPU's _tail_kernel runs its mel and DCT products through _cdot at the
# config's precision, so at bf16x3 they are split products, and the twin
# computes the same ones.


@pytest.mark.parametrize("rows", [1, 7, 513])
@pytest.mark.parametrize("name", ["mfcc13", "whisper80", "fbank80"])
def test_bf16x3_tail_twin_matches_pallas_kernel(name, rows):
    jcfg = dataclasses.replace(JPRESETS[name], matmul_precision="bf16x3")
    spec = _spectrum_rows(jcfg, rows, seed=9)
    want = np.asarray(fused.mel_log_dct(jnp.asarray(spec), jcfg))
    got = staged.mel_log_dct_reference(torch.from_numpy(spec), _port(jcfg))
    assert got.shape == want.shape
    assert _scaled_err(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("name", sorted(CFGS))
def test_default_tail_twin_matches_one_pass_oracle(name):
    cfg = dataclasses.replace(_port(CFGS[name]), matmul_precision="default")
    spec = _spectrum_rows(CFGS[name], 64, seed=10)
    want = torch.from_numpy(_one_pass.tail_features(spec, cfg))
    got = staged.mel_log_dct_reference(torch.from_numpy(spec), cfg)
    tolerance.compare_to_twin(got, want, torch.from_numpy(spec), cfg,
                              what=name, spectrum=True)


def _unpack_fragments(frags: torch.Tensor) -> list:
    """The matrices [16 ks, 8 nt] (one per piece) that the kernel reads out
    of B fragments, with lane 4 g + t's register r holding rows
    16 s + 8 r + 2 t (low half) and + 1 (high half) of column 8 j + g, as
    mma.sync m16n8k16 takes its B operand."""
    ks, nt, n, _, _ = frags.shape
    words = frags.numpy().view(np.uint32)
    out = []
    for p in range(n):
        m = np.zeros((16 * ks, 8 * nt), np.uint16)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for r in range(2):
                w = words[:, :, p, lane, r]
                m[8 * r + 2 * t::16, g::8] = w & 0xFFFF
                m[8 * r + 2 * t + 1::16, g::8] = w >> 16
        out.append(torch.from_numpy(m.view(np.int16)).view(torch.bfloat16))
    return out


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("name", ["mfcc13", "fbank80", "whisper80",
                                  "magnitude_lifter", "mel160"])
def test_tail_fragments_emulate_the_twin(name, precision):
    """K4's packed constants (staged.tail_mma_constants), read back as the
    kernel reads them, are the filterbank's and the DCT's pieces, and its
    data flow on them (rows split into pieces, f32 products in the pass
    order, the floored log, the log-mel split the same way against the
    DCT's) gives the twin's features within the twin tolerance. Checks the
    host side of the kernel where no card is."""
    jcfg = {"whisper80": JPRESETS["whisper80"],
            "mel160": dataclasses.replace(JPRESETS["mfcc13"], n_mels=160)
            }.get(name) or CFGS[name]
    cfg = dataclasses.replace(_port(jcfg), matmul_precision=precision)
    frags, dct_frags = staged.tail_mma_constants(cfg)
    n = signal.PIECES[signal.passes(cfg)]
    dct = signal.dct_constant(cfg)
    assert (dct_frags is None) == (dct is None)
    packed = {}
    for name, f, w in (("fb", frags, staged.tail_fb_constant(cfg)),
                       ("dct", dct_frags, dct)):
        if w is None:
            continue
        assert f.dtype == torch.int32
        assert f.shape == (-(-w.shape[0] // 16), -(-w.shape[1] // 8), n,
                           32, 2)
        packed[name] = _unpack_fragments(f)
        pad = torch.zeros(packed[name][0].shape)
        pad[:w.shape[0], :w.shape[1]] = torch.tensor(w)
        for got, want in zip(packed[name], signal.split_pieces(pad, n)):
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    pieces = packed["fb"]
    spec = torch.from_numpy(_spectrum_rows(jcfg, 70, seed=11))
    x = torch.zeros(70, pieces[0].shape[0])
    x[:, :cfg.n_bins] = spec
    xs = [t.float() for t in signal.split_pieces(x, n)]
    mel = 0
    for i, j in signal.PASS_ORDER[:signal.passes(cfg)]:
        mel = mel + xs[i] @ pieces[j].float()
    out = signal.log_tail(mel[:, :cfg.n_mels], None, cfg)
    if dct is not None:
        lm = torch.zeros(70, packed["dct"][0].shape[0])
        lm[:, :cfg.n_mels] = out
        ls = [t.float() for t in signal.split_pieces(lm, n)]
        out = 0
        for i, j in signal.PASS_ORDER[:signal.passes(cfg)]:
            out = out + ls[i] @ packed["dct"][j].float()
        out = out[:, :dct.shape[1]]
    want = staged.mel_log_dct_reference(spec, cfg)
    tolerance.compare_to_twin(out, want, spec, cfg, what=name,
                              spectrum=True)
