"""Kaldi-39 offline in the port: deltas, CMVN (per utterance, sliding,
Kaldi online), ``extract`` on ``KALDI39`` and its variants, against
``tpufeat`` and the float64 golden; ``extract_chunked`` and
``make_extractor``; and the precision pins (the TF32 guard under torch's
``fp32_precision`` API, every product of the plain path in fp32).

Tolerances:
- the operators (deltas, cmvn, sliding_cmvn, online_cmvn) against the JAX
  package on the same f32 input: <= 1e-5 relative to max(1, |want|.max())
  (the same f32 arithmetic, cumulative sums and reductions in another
  order); against the float64 golden the JAX package's own tests' limits:
  2e-5 abs for sliding CMVN (``tests/test_sliding_cmvn.py``), 2e-4 abs for
  online CMVN (``tests/test_online_cmvn.py``), 1e-5 for deltas and
  per-utterance CMVN;
- ``extract`` against ``tpufeat.extract`` with the same flags: masks and
  frame counts exact, valid frames <= 1e-4 relative to max(1, |want|)
  (``tests/test_torch_extract.py``'s); against the golden, absolute, the
  JAX package's limits (``tests/test_extract_parity.py``: 2e-3, 5e-3 with
  ``meanvar``, whose division by a small standard deviation on a
  near-constant column amplifies f32 noise; ``tests/test_sliding_cmvn.py``
  2e-3 for sliding CMVN);
- ``out_dtype="bfloat16"``: within the f32 tolerance above plus one bf16
  ulp (at most 2^-7 relative) of the JAX package's: the f32 values differ
  by the former and may then round to neighbouring bf16 values;
- ``extract_chunked`` and ``make_extractor`` against ``extract``: bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpufeat import data as jdata
from tpufeat import features as jfeat
from tpufeat.config import PRESETS as JPRESETS
from tpufeat.reference import cpu as jcpu

import tpufeat_torch
from tpufeat_torch import data, features, streaming
from tpufeat_torch.config import from_reference
from tpufeat_torch.kernels import signal

from conftest import make_signal

FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True)
FLAGS = {"plain": {}, "fused": FUSED}
TOL_OP = 1e-5
JKALDI39 = JPRESETS["kaldi39"]


def _port(jcfg):
    return from_reference(dataclasses.asdict(jcfg))


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _feats(B, T, D=13, seed=0):
    """[B, T, D] f32 rows with a per-column offset, the CMVN case."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, D)) * 3
            + rng.standard_normal(D) * 5).astype(np.float32)


# ---------------------------------------------------------------------------
# deltas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [1, 2, 3])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_deltas_match_tpufeat_and_golden(order, window):
    """Chained ``order`` times over a ragged batch whose rows hold fewer
    frames than the window and none at all (an all-padding row)."""
    x = _feats(5, 12, seed=order * 10 + window)
    nf = np.array([12, 7, window - 1 if window > 1 else 1, 1, 0], np.int32)
    x[1, 7:] = 1e4                     # padding never reaches a valid frame
    want, got = x, torch.from_numpy(x)
    for _ in range(order):
        want = np.asarray(jfeat.deltas(want, nf, window))
        got = features.deltas(got, torch.from_numpy(nf), window)
        assert got.shape == want.shape
        for b, n in enumerate(nf):
            assert _scaled(got[b, :n], want[b, :n]) <= TOL_OP
    gold = x[0]
    for _ in range(order):
        gold = jcpu.deltas(gold.astype(np.float64), window)
    assert _scaled(got[0], gold) <= TOL_OP


@pytest.mark.parametrize("F", [1, 2])
def test_deltas_of_fewer_frames_than_the_window(F):
    """A whole batch of F < window frames (the ``min(i, F)`` guard)."""
    x = _feats(2, F, seed=F)
    nf = np.array([F, F - 1], np.int32)
    want = np.asarray(jfeat.deltas(x, nf, 3))
    got = features.deltas(torch.from_numpy(x), torch.from_numpy(nf), 3)
    assert got.shape == want.shape
    assert _scaled(got[0], want[0]) <= TOL_OP
    assert _scaled(got[0], jcpu.deltas(x[0].astype(np.float64), 3)) <= TOL_OP


# ---------------------------------------------------------------------------
# CMVN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mean", "meanvar"])
def test_cmvn_matches_tpufeat_and_golden(mode):
    x = _feats(3, 40, seed=3)
    mask = np.zeros((3, 40), bool)
    mask[0], mask[1, :17] = True, True          # row 2: all padding
    x[1, 17:] = -1e4
    want = np.asarray(jfeat.cmvn(x, mask, mode))
    got = features.cmvn(torch.from_numpy(x), torch.from_numpy(mask), mode)
    assert _scaled(got.numpy()[mask], want[mask]) <= TOL_OP
    for b, n in ((0, 40), (1, 17)):
        gold = jcpu.cmvn(x[b, :n].astype(np.float64), mode)
        assert _scaled(got[b, :n], gold) <= TOL_OP


@pytest.mark.parametrize("T", [50, 150], ids=["T<window", "T>window"])
@pytest.mark.parametrize("windows", [(80, 30), (80, 120)],
                         ids=["min<window", "min>window"])
@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("center", [False, True])
def test_sliding_cmvn_matches_tpufeat_and_golden(center, norm_vars, windows,
                                                 T):
    window, min_window = windows
    x = _feats(2, T, seed=T + window)
    nf = np.array([T, T // 3], np.int32)
    x[1, T // 3:] = 1e6
    kw = dict(window=window, min_window=min_window, center=center,
              norm_vars=norm_vars)
    want = np.asarray(jfeat.sliding_cmvn(x, nf, **kw))
    got = features.sliding_cmvn(torch.from_numpy(x), torch.from_numpy(nf),
                                **kw)
    for b, n in enumerate(nf):
        assert _scaled(got[b, :n], want[b, :n]) <= TOL_OP
        gold = jcpu.sliding_cmvn(x[b, :n], **kw)
        assert np.abs(got[b, :n].numpy() - gold).max() <= 2e-5


def _jstats(rows):
    st = jdata.CmvnStats(rows.shape[-1])
    st.accumulate(rows)
    return st


def _tstats(rows):
    st = data.CmvnStats(rows.shape[-1])
    st.accumulate(torch.from_numpy(rows))
    return st


@pytest.mark.parametrize("priors", ["none", "speaker", "both"])
@pytest.mark.parametrize("norm_vars", [False, True])
def test_online_cmvn_matches_tpufeat_and_golden(priors, norm_vars):
    """The priors are ``CmvnStats`` built on each side from the same
    frames: 150 for the speaker, 900 for the global one."""
    x = _feats(2, 90, seed=5)
    nf = np.array([90, 40], np.int32)
    pool = _feats(1, 1050, seed=6)[0] * 0.5 + 1.0
    kw = dict(window=120, speaker_frames=100, global_frames=60,
              norm_vars=norm_vars)
    jkw, tkw = dict(kw), dict(kw)
    if priors != "none":
        jkw["speaker_stats"] = _jstats(pool[:150])
        tkw["speaker_stats"] = _tstats(pool[:150])
    if priors == "both":
        jkw["global_stats"] = _jstats(pool[150:])
        tkw["global_stats"] = _tstats(pool[150:])
    want = np.asarray(jfeat.online_cmvn(x, nf, **jkw))
    got = features.online_cmvn(torch.from_numpy(x), torch.from_numpy(nf),
                               **tkw)
    for b, n in enumerate(nf):
        assert _scaled(got[b, :n], want[b, :n]) <= TOL_OP
        gold = jcpu.online_cmvn(x[b, :n], **tkw)
        assert np.abs(got[b, :n].numpy() - gold).max() <= 2e-4
    one = features.online_cmvn(torch.from_numpy(x[1, :40]), **tkw)
    assert _scaled(one, want[1, :40]) <= TOL_OP       # [T, D] input


def test_cmvn_stats_match_tpufeat():
    rows = _feats(3, 20, seed=7)
    a, b = _jstats(rows), _tstats(rows)
    assert a.count == b.count == 60.0
    np.testing.assert_array_equal(b.to_kaldi(), a.to_kaldi())
    np.testing.assert_array_equal(b.var, a.var)
    np.testing.assert_array_equal(b.apply(rows[0], norm_vars=True),
                                  a.apply(rows[0], norm_vars=True))
    back = data.CmvnStats.from_kaldi(a.to_kaldi())
    np.testing.assert_array_equal(back.mean, a.mean)
    with pytest.raises(ValueError, match="2, D"):
        data.CmvnStats.from_kaldi(np.zeros((3, 4)))


# ---------------------------------------------------------------------------
# extract on Kaldi-39
# ---------------------------------------------------------------------------

LENGTHS = np.array([16000, 5555, 11111])
KNOBS = dict(kaldi_mode=True, dc_offset=True, window="povey", deltas=True,
             cmvn="mean")
VARIANTS = {
    "kaldi39": ({}, 2e-3),
    "meanvar": (dict(cmvn="meanvar"), 5e-3),
    "knobs": (KNOBS, 2e-3),
    "order1": (dict(delta_order=1), 2e-3),
    "order3": (dict(delta_order=3), 2e-3),
    "sliding": (dict(cmvn="sliding", cmvn_window=60, cmvn_min_window=20),
                2e-3),
    "sliding_centred": (dict(cmvn="sliding", cmvn_window=60,
                             cmvn_min_window=20, cmvn_center=True), 2e-3),
    "sliding_meanvar": (dict(cmvn="sliding-meanvar", cmvn_window=60,
                             cmvn_min_window=20), 5e-3),
}


def _batch(lengths=LENGTHS, seed=20):
    """make_signal rows (tones + noise) over loud garbage padding."""
    x = np.zeros((len(lengths), int(lengths.max())), np.float32)
    rng = np.random.default_rng(99)
    for b, n in enumerate(lengths):
        x[b, :n] = make_signal(int(n), seed=seed + b)
        x[b, n:] = rng.standard_normal(x.shape[1] - n) * 10
    return x


def _jcfg(name, flags):
    change, _ = VARIANTS[name]
    base = JPRESETS["mfcc13"] if name == "knobs" else JKALDI39
    return dataclasses.replace(base, **change, **flags)


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_extract_matches_tpufeat_and_golden(name, flags):
    """Plain, and with the kernel flags (K1's twin here), at the configs'
    "highest"; the JAX side runs Pallas in interpret mode."""
    jcfg = _jcfg(name, FLAGS[flags])
    x = _batch()
    want = jfeat.extract(x, LENGTHS, jcfg)
    got = features.extract(x, LENGTHS, _port(jcfg), device="cpu")
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.num_frames.numpy(),
                                  np.asarray(want.num_frames))
    assert got.features.shape == want.features.shape
    assert got.features.shape[-1] == jcfg.feature_dim
    wf = np.asarray(want.features)
    for b, n in enumerate(got.num_frames.tolist()):
        assert _scaled(got.features[b, :n], wf[b, :n]) <= 1e-4
        gold = jcpu.extract(x[b, :LENGTHS[b]].astype(np.float64), jcfg)
        assert gold.shape == (n, jcfg.feature_dim)
        assert np.abs(got.features[b, :n].numpy() - gold).max() \
            < VARIANTS[name][1]


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_bfloat16_output_matches_tpufeat(flags):
    jcfg = dataclasses.replace(JKALDI39, out_dtype="bfloat16", **FLAGS[flags])
    x = _batch(seed=30)
    want = jfeat.extract(x, LENGTHS, jcfg)
    got = features.extract(x, LENGTHS, _port(jcfg), device="cpu")
    assert got.features.dtype == torch.bfloat16
    wf = np.asarray(want.features).astype(np.float32)
    gf = got.features.float().numpy()
    for b, n in enumerate(got.num_frames.tolist()):
        err = np.abs(gf[b, :n] - wf[b, :n])
        ulp = 2.0 ** -7 * np.maximum(np.abs(gf[b, :n]), np.abs(wf[b, :n]))
        f32 = 1e-4 * max(1.0, np.abs(wf[b, :n]).max())
        assert (err <= f32 + ulp).all()


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_extract_chunked_is_extract(flags):
    cfg = dataclasses.replace(_port(JKALDI39), **FLAGS[flags])
    x = _batch(seed=40)
    whole = features.extract(x, LENGTHS, cfg, device="cpu")
    parts = features.extract_chunked(x, LENGTHS, cfg, rows_per_dispatch=2,
                                     device="cpu")
    for a, b in zip(parts, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    one = tpufeat_torch.extract_chunked(x[1, :LENGTHS[1]], cfg=cfg,
                                        device="cpu")
    alone = features.extract(x[1, :LENGTHS[1]], cfg=cfg, device="cpu")
    torch.testing.assert_close(one.features, alone.features, rtol=0, atol=0)
    assert one.features.dim() == 2 and one.num_frames.dim() == 0


def test_make_extractor_is_extract():
    cfg = _port(JKALDI39)
    run = tpufeat_torch.make_extractor(cfg, "cpu")
    x = _batch(seed=41)
    got, want = run(x, LENGTHS), features.extract(x, LENGTHS, cfg,
                                                  device="cpu")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mfcc_strips_deltas_and_cmvn():
    x = _batch(seed=42)
    got, mask = features.mfcc(x, LENGTHS, _port(JKALDI39), device="cpu")
    base = dataclasses.replace(_port(JKALDI39), deltas=False, cmvn="none")
    want = features.extract(x, LENGTHS, base, device="cpu")
    assert got.shape[-1] == 13
    torch.testing.assert_close(got, want.features, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# precision: the TF32 guard and the plain path's products
# ---------------------------------------------------------------------------

@pytest.fixture
def tf32_setting():
    """Puts torch's TF32 setting back as it was after the test: the legacy
    store first, then ``fp32_precision`` from the parents down (a parent's
    assignment resets its children), so that neither API reads as mixed."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    legacy = torch.get_float32_matmul_precision(), cudnn.allow_tf32
    new = (torch.backends.fp32_precision, cudnn.fp32_precision,
           matmul.fp32_precision, cudnn.conv.fp32_precision)
    yield
    torch.set_float32_matmul_precision(legacy[0])
    cudnn.allow_tf32 = legacy[1]
    (torch.backends.fp32_precision, cudnn.fp32_precision,
     matmul.fp32_precision, cudnn.conv.fp32_precision) = new


@pytest.mark.parametrize("name", ["mfcc13", "kaldi39"])
def test_kernel_flags_under_fp32_precision_api(name, tf32_setting):
    """A caller of torch's ``fp32_precision`` API (after which torch
    refuses to read the legacy flags) runs ``extract`` with the kernel
    flags, whose twin enters the guard, and gets its setting back."""
    matmul = torch.backends.cuda.matmul
    cfg = dataclasses.replace(_port(JPRESETS[name]), **FUSED)
    x = _batch(seed=43)
    want = features.extract(x, LENGTHS, cfg, device="cpu").features
    matmul.fp32_precision = "tf32"
    with pytest.raises(RuntimeError):
        matmul.allow_tf32          # torch's own refusal: the fault's cause
    got = features.extract(x, LENGTHS, cfg, device="cpu").features
    assert matmul.fp32_precision == "tf32"
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("setting", [
    lambda m, c: setattr(m, "allow_tf32", True),
    lambda m, c: setattr(m, "fp32_precision", "tf32"),
    lambda m, c: torch.set_float32_matmul_precision("high"),
    lambda m, c: setattr(c.conv, "fp32_precision", "tf32"),
    lambda m, c: setattr(c, "fp32_precision", "tf32"),
    lambda m, c: setattr(torch.backends, "fp32_precision", "tf32"),
], ids=["legacy", "matmul_api", "matmul_precision", "conv_api",
        "cudnn_api", "generic_api"])
def test_guard_restores_every_api(setting, tf32_setting):
    """Inside the guard cuBLAS and cuDNN keep fp32, however the caller set
    them; outside they are the caller's again, readable as before."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn

    def read():
        out = []
        for get in (lambda: matmul.allow_tf32, lambda: cudnn.allow_tf32,
                    lambda: matmul.fp32_precision,
                    lambda: cudnn.conv.fp32_precision,
                    lambda: cudnn.fp32_precision,
                    lambda: torch.backends.fp32_precision):
            try:
                out.append(get())
            except RuntimeError:
                out.append("refused")
        return out

    def fp32(leaf):
        """``leaf``'s setting keeps fp32: its own, or its parents' when it
        has none."""
        return leaf.fp32_precision == "ieee" or \
            leaf.fp32_precision == "none" and \
            cudnn.fp32_precision in ("ieee", "none") and \
            torch.backends.fp32_precision in ("ieee", "none")

    setting(matmul, cudnn)
    before = read()
    with signal.no_tf32():
        assert fp32(matmul) and fp32(cudnn.conv)
    assert read() == before


def _whisper_dct(jcfg):
    return dataclasses.replace(jcfg, n_mfcc=13, log="whisper", n_mels=40)


PRODUCTS = {
    "extract_rfft": lambda x, c: features.extract(x, LENGTHS, c,
                                                  device="cpu"),
    "extract_gemm": lambda x, c: features.extract(
        x, LENGTHS, dataclasses.replace(c, gemm_dft=True), device="cpu"),
    "whisper_dct_after_k1": lambda x, c: features.extract(
        x, LENGTHS, dataclasses.replace(_whisper_dct(c), **FUSED),
        device="cpu"),
    "mel_spectrogram": lambda x, c: features.mel_spectrogram(
        x, LENGTHS, c, device="cpu"),
    "logmel": lambda x, c: features.logmel(x, LENGTHS, c, device="cpu"),
    "pipeline_transform": lambda x, c: streaming.StreamingPipeline(
        c, 3, transform=np.eye(39, dtype=np.float32), device="cpu"
    ).process(x),
}


@pytest.mark.parametrize("path", sorted(PRODUCTS))
def test_plain_products_run_in_fp32(path, monkeypatch):
    """Every matrix product of the plain path, and the pipeline's
    transform, runs with TF32 off while the caller has it on (the card
    test holds the values under ``set_float32_matmul_precision("high")``)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    PRODUCTS[path](_batch(seed=44), _port(JKALDI39))
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32
