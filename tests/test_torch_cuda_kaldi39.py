"""Kaldi-39 on the card: offline ``extract``, the operators and the online
``StreamingPipeline`` held against the CPU path of the same call (the plain
twin in place of K1), and the plain path's products pinned to fp32.

Marked ``cuda``: run with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kaldi39.py`` on a machine with an H100 and nvcc
(``--noconftest`` because ``tests/conftest.py`` imports jax; this file
imports no jax). Without a card every test skips inside the ``cuda``
fixture.

Tolerances, relative to max(1, |CPU|.max()):
- the operators (deltas, cmvn, sliding and online CMVN) on the card
  against the CPU: <= 1e-5 (f32, reductions and cumulative sums in another
  order);
- ``extract`` on the card against the CPU path: <= 1e-4 on the plain path
  (cuFFT and cuBLAS against MKL); with the kernel flags <= 1e-3, the
  repo's budget: the kernel and its twin sum in other orders, by up to the
  sum-order bound of ``kernels/_tolerance.py`` on near-silent bands, which
  deltas do not grow and CMVN moves only by a mean; against the float64
  golden, the JAX package's limits (2e-3 abs, 5e-3 with ``meanvar``);
- the pipeline's base columns against ``extract_scan`` on the card:
  bitwise on every hop-aligned plan with the kernel flags (K1's fixed tile
  and sum order), <= 1e-5 on the plain path, whose cuFFT plans and cuBLAS
  algorithms follow the step's row count; its rows against the CPU
  pipeline: <= 1e-4 plain, <= 1e-3 with the kernel flags, as ``extract``;
- the plain path's products under ``set_float32_matmul_precision("high")``
  against the same call under "highest": <= 1e-6 (both fp32), where an
  unpinned product moves by TF32's 2^-11.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpufeat_torch import data, features, streaming
from tpufeat_torch.config import KALDI39, MFCC13_HTK, WHISPER80
from tpufeat_torch.kernels import signal
from tpufeat_torch.reference import cpu

pytestmark = pytest.mark.cuda

FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True)
FLAGS = {"plain": {}, "fused": FUSED,
         "fused_bf16x3": dict(FUSED, matmul_precision="bf16x3")}
VARIANTS = {
    "kaldi39": ({}, 2e-3),
    "meanvar": (dict(cmvn="meanvar"), 5e-3),
    "knobs": (dict(kaldi_mode=True, dc_offset=True, window="povey"), 2e-3),
    "order1": (dict(delta_order=1), 2e-3),
    "order3": (dict(delta_order=3), 2e-3),
    "sliding": (dict(cmvn="sliding", cmvn_window=60, cmvn_min_window=20),
                2e-3),
    "sliding_centred": (dict(cmvn="sliding", cmvn_window=60,
                             cmvn_min_window=20, cmvn_center=True), 2e-3),
    "sliding_meanvar": (dict(cmvn="sliding-meanvar", cmvn_window=60,
                             cmvn_min_window=20), 5e-3),
    "bf16_out": (dict(out_dtype="bfloat16"), None),
}
LENGTHS = np.array([48000, 30001, 7777, 300])   # the last: no frame at all


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scaled(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape
    if got.numel() == 0:
        return 0.0
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())
            ).item()


def _batch(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(lengths.max())) / 16000.0
    x = np.zeros((len(lengths), int(lengths.max())), np.float32)
    for b, n in enumerate(lengths):
        tone = 0.5 * np.sin(2 * np.pi * (220.0 + 110 * b) * t[:n])
        x[b, :n] = tone + 0.1 * rng.standard_normal(n)
        x[b, n:] = rng.standard_normal(x.shape[1] - n) * 10
    return x


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_extract_on_card_matches_cpu_and_golden(cuda, name, flags):
    change, gold_tol = VARIANTS[name]
    cfg = dataclasses.replace(KALDI39, **change, **FLAGS[flags])
    x = _batch()
    before = signal.mma_launches
    got = features.extract(x, LENGTHS, cfg, device="cuda")
    torch.cuda.synchronize()
    assert signal.mma_launches == before + (flags != "plain")
    want = features.extract(x, LENGTHS, cfg, device="cpu")
    assert torch.equal(got.mask.cpu(), want.mask)
    assert torch.equal(got.num_frames.cpu(), want.num_frames)
    assert got.features.dtype == want.features.dtype
    tol = 1e-4 if flags == "plain" else 1e-3
    if cfg.out_dtype == "bfloat16":
        tol += 2.0 ** -7
    for b, n in enumerate(want.num_frames.tolist()):
        assert _scaled(got.features[b, :n], want.features[b, :n]) <= tol
        if gold_tol is None or flags == "fused_bf16x3" or not n:
            continue
        gold = cpu.extract(x[b, :LENGTHS[b]].astype(np.float64), cfg)
        err = np.abs(got.features[b, :n].double().cpu().numpy() - gold)
        assert err.max() < gold_tol


@pytest.mark.parametrize("op", ["deltas", "cmvn", "sliding", "centred",
                                "online"])
def test_operators_on_card_match_cpu(cuda, op):
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((3, 700, 39)) * 3
                          + rng.standard_normal(39) * 5).astype(np.float32))
    nf = torch.tensor([700, 333, 1])
    mask = torch.arange(700)[None] < nf[:, None]
    prior = data.CmvnStats(39)
    prior.accumulate(x[0, :200])

    def run(t, n, m):
        if op == "deltas":
            return features.deltas(features.deltas(t, n), n)
        if op == "cmvn":
            return features.cmvn(t, m, "meanvar")
        if op in ("sliding", "centred"):
            return features.sliding_cmvn(t, n, window=600, min_window=100,
                                         center=op == "centred",
                                         norm_vars=True)
        return features.online_cmvn(t, n, window=600, speaker_stats=prior,
                                    norm_vars=True)

    got = run(x.to(cuda), nf.to(cuda), mask.to(cuda))
    want = run(x, nf, mask)
    for b, n in enumerate(nf.tolist()):
        assert _scaled(got[b, :n], want[b, :n]) <= 1e-5


PLANS = {"steady": [1600] * 10, "ragged": [4800, 1600, 160, 8000, 1440],
         "one_frame": [160] * 100}


def _run(pipe, x, plan):
    outs, pos = [], 0
    for c in plan:
        outs.append(pipe.process(x[:, pos: pos + c]))
        pos += c
    outs.append(pipe.flush())
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("flags", ["plain", "fused"])
@pytest.mark.parametrize("cmvn", ["none", "mean", "sliding"])
def test_pipeline_on_card(cuda, cmvn, flags, plan):
    change = dict(cmvn=cmvn, cmvn_window=60, cmvn_min_window=20) \
        if cmvn == "sliding" else dict(cmvn=cmvn)
    cfg = dataclasses.replace(KALDI39, **change, **FLAGS[flags])
    x = _batch(np.array([16000] * 3), seed=4)
    xc = torch.from_numpy(x).to(cuda)
    got = _run(streaming.StreamingPipeline(cfg, 3, device="cuda"), xc,
               PLANS[plan])
    want = _run(streaming.StreamingPipeline(cfg, 3, device="cpu"), x,
                PLANS[plan])
    assert _scaled(got, want) <= (1e-4 if flags == "plain" else 1e-3)
    if cmvn == "none":
        base_cfg = dataclasses.replace(cfg, deltas=False, cmvn="none")
        scan = streaming.extract_scan(xc, base_cfg, chunk_len=1600)
        if flags == "plain":
            assert _scaled(got[..., :13], scan) <= 1e-5
            return
        assert torch.equal(got[..., :13], scan)
        nf = torch.full((3,), scan.shape[1], device=cuda)
        d1 = features.deltas(scan, nf)
        want = torch.cat([scan, d1, features.deltas(d1, nf)], dim=-1)
        assert _scaled(got, want) <= 1e-6
    if cmvn == "sliding":
        offline = features.extract(xc, cfg=cfg).features
        assert _scaled(got, offline) <= 1e-5


def test_pipeline_resumes_on_card(cuda, tmp_path):
    cfg = dataclasses.replace(KALDI39, cmvn="sliding", cmvn_window=60,
                              cmvn_min_window=20, **FUSED)
    x = torch.from_numpy(_batch(np.array([16000] * 2), seed=5)).to(cuda)
    plan = PLANS["ragged"]
    want = _run(streaming.StreamingPipeline(cfg, 2, device="cuda"), x, plan)
    a = streaming.StreamingPipeline(cfg, 2, device="cuda")
    head = [a.process(x[:, :4800]), a.process(x[:, 4800:6400])]
    path = str(tmp_path / "pipe.npz")
    streaming.save_state(path, a.state())
    b = streaming.StreamingPipeline(cfg, 2, device="cuda")
    b.set_state(streaming.load_state(path, b.state()))
    assert b.state()["fifos"][0].device.type == "cuda"
    got = torch.cat(head + [_run(b, x[:, 6400:], plan[2:])], dim=1)
    assert torch.equal(got, want)


def _whisper_dct():
    return dataclasses.replace(WHISPER80, n_mfcc=13, **FUSED)


PRODUCTS = {
    "mel_spectrogram": lambda x: features.mel_spectrogram(
        x, cfg=MFCC13_HTK)[0],
    "logmel": lambda x: features.logmel(x, cfg=WHISPER80)[0],
    "extract_plain": lambda x: features.extract(x, cfg=MFCC13_HTK).features,
    "extract_plain_gemm": lambda x: features.extract(
        x, cfg=dataclasses.replace(MFCC13_HTK, gemm_dft=True)).features,
    "kaldi39_plain": lambda x: features.extract(x, cfg=KALDI39).features,
    "whisper_dct_after_k1": lambda x: features.extract(
        x, cfg=_whisper_dct()).features,
    "pipeline_transform": lambda x: _run(streaming.StreamingPipeline(
        KALDI39, x.shape[0], transform=np.random.default_rng(6)
        .standard_normal((20, 40)).astype(np.float32), device="cuda"),
        x, [1600] * 10),
}


@pytest.mark.parametrize("path", sorted(PRODUCTS))
def test_plain_products_keep_fp32_under_high_precision(cuda, path):
    x = torch.from_numpy(_batch(np.array([16000] * 4), seed=7)).to(cuda)
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = PRODUCTS[path](x)
        torch.set_float32_matmul_precision("high")
        got = PRODUCTS[path](x)
        assert torch.get_float32_matmul_precision() == "high"
        # the control: an unpinned product of the same operands moves
        a = torch.randn(256, 400, device=cuda)
        w = torch.randn(400, 257, device=cuda)
        tf32 = a @ w
    finally:
        torch.set_float32_matmul_precision(old)
    assert _scaled(got.float(), want.float()) <= 1e-6
    assert _scaled(tf32, a @ w) > 1e-5
