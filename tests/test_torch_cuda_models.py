"""The ASR models on the card: the encoders, ``asr_forward`` through the
signal kernel, the CTC, RNN-T and x-vector steps and the RNN-T loss,
each held against the same call on the CPU at the same weights, and the
encoders' products pinned to full fp32 whatever the caller's TF32
setting.

Marked ``cuda``: run with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_models.py`` on a machine with a card
(``--noconftest`` because ``tests/conftest.py`` imports jax; this file
imports no jax). Without a card every test skips inside the ``cuda``
fixture.

Tolerances, scaled by max(1, |CPU|.max()): encoder outputs 1e-4 (fp32
sums in cuBLAS's and cuDNN's order); ``asr_forward`` logits 1e-3 (the
signal kernel at bf16x3 against its twin, within 1e-3 of the golden,
through the encoder); the training steps (the kernel at "highest"):
losses rtol 1e-4 and gradients 1e-3 of each tensor's largest entry; the
RNN-T loss rtol 1e-5 and its gradient 1e-5; under ``allow_tf32``: bit for
bit with the default.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from tpufeat_torch.config import KALDI39, WHISPER80
from tpufeat_torch.kernels import signal
from tpufeat_torch.models import encoder, train, xvector

pytestmark = pytest.mark.cuda

CPU = "cpu"
FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True,
             matmul_precision="bf16x3")
HIGHEST = dict(FUSED, matmul_precision="highest")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _scaled(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.detach().cpu().double()
    return float((got.detach().cpu().double() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def _pair(build, cuda):
    torch.manual_seed(0)
    model = build(CPU)
    return model, copy.deepcopy(model).to(cuda)


def _audio(B, seconds, seed):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((B, seconds * 16000))).astype(np.float32)
    lengths = np.full(B, x.shape[1])
    lengths[1:] = rng.integers(x.shape[1] // 2, x.shape[1], B - 1)
    return x, lengths


@pytest.mark.parametrize("arch", ["whisper", "conformer"])
def test_encoders_match_cpu(cuda, arch):
    """Full width (whisper-tiny, conformer-small) on 400 ragged frames."""
    build = encoder.whisper_tiny if arch == "whisper" else \
        encoder.conformer_small
    cpu_m, card_m = _pair(lambda d: build(device=d), cuda)
    rng = np.random.default_rng(1)
    mel = torch.from_numpy(rng.standard_normal((2, 400, 80))
                           .astype(np.float32))
    mask = torch.arange(400)[None] < torch.tensor([[400], [257]])
    with torch.no_grad():
        want, wm = cpu_m(mel, mask)
        got, gm = card_m(mel.to(cuda), mask.to(cuda))
    assert torch.equal(gm.cpu(), wm)
    assert _scaled(got, want) < 1e-4


def test_tf32_does_not_reach_the_encoders(cuda):
    _, model = _pair(lambda d: encoder.conformer_small(device=d), cuda)
    mel = torch.randn(2, 300, 80, device=cuda)
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    try:
        with torch.no_grad():
            matmul.allow_tf32 = cudnn.allow_tf32 = False
            off, _ = model(mel)
            matmul.allow_tf32 = cudnn.allow_tf32 = True
            on, _ = model(mel)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
    assert torch.equal(on, off)


def test_asr_forward_through_the_kernel(cuda):
    cfg = dataclasses.replace(WHISPER80, **FUSED)
    cpu_m, card_m = _pair(lambda d: train.make_models(
        dim=64, layers=2, heads=2, vocab=16, device=d), cuda)
    audio, lengths = _audio(3, 4, 2)
    signal.mma_launches = 0
    with torch.no_grad():
        got, gm = train.asr_forward(card_m, audio, lengths, cfg)
        want, wm = train.asr_forward(cpu_m, audio, lengths, cfg)
    assert signal.mma_launches == 1
    assert torch.equal(gm.cpu(), wm)
    assert _scaled(got, want) < 1e-3


def _grad_gap(a: torch.nn.Module, b: torch.nn.Module) -> float:
    gap = 0.0
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        w = q.grad.cpu()
        gap = max(gap, float((p.grad.cpu() - w).abs().max()
                             / max(float(w.abs().max()), 1e-12)))
    return gap


@pytest.mark.parametrize("what", ["ctc", "transducer", "xvector"])
def test_train_steps_match_cpu(cuda, what):
    """One step of each on the card and on the CPU from the same weights
    (learning rate 0: the gradients are compared, not Adam's sign)."""
    audio, lengths = _audio(2, 2, 3)
    rng = np.random.default_rng(4)
    if what == "xvector":
        cpu_m, card_m = _pair(lambda d: xvector.xvector_model(
            6, in_dim=39, embed_dim=32, channels=64, device=d), cuda)
        feats = rng.standard_normal((4, 120, 39)).astype(np.float32)
        mask = (np.arange(120)[None] < np.array([[120], [90], [60], [120]]))
        labels = np.array([0, 3, 5, 3])
        args = (feats, mask.astype(np.float32), labels)
        step = xvector.xvector_train_step
        kw = {}
    else:
        labels = rng.integers(1, 16, (2, 6))
        args = (audio, lengths, labels, np.array([6, 4]))
        if what == "ctc":
            build = lambda d: train.make_models(          # noqa: E731
                dim=64, layers=1, heads=2, vocab=16, device=d)
            step, cfg = train.ctc_train_step, WHISPER80
        else:
            build = lambda d: train.make_transducer(      # noqa: E731
                dim=64, layers=1, heads=2, vocab=16, in_dim=39, device=d)
            step, cfg = train.transducer_train_step, KALDI39
        cpu_m, card_m = _pair(build, cuda)
        kw = dict(cfg=dataclasses.replace(cfg, **HIGHEST))
    _, want = step(train.TrainState(cpu_m, train.adamw(cpu_m, 0.0)),
                   *args, **kw)
    _, got = step(train.TrainState(card_m, train.adamw(card_m, 0.0)),
                  *args, **kw)
    assert torch.isfinite(got)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-4)
    assert _grad_gap(card_m, cpu_m) < 1e-3


def test_transducer_loss_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((3, 200, 21, 16))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(1, 16, (3, 20)))
    tlen, llen = torch.tensor([200, 150, 7]), torch.tensor([20, 11, 3])
    x_cpu = logits.clone().requires_grad_()
    x_card = logits.to(cuda).requires_grad_()
    want = train.transducer_loss(x_cpu, tlen, labels, llen)
    got = train.transducer_loss(x_card, tlen, labels, llen)
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               want.detach().numpy(), rtol=1e-5)
    want.sum().backward()
    got.sum().backward()
    assert _scaled(x_card.grad, x_cpu.grad) < 1e-5
