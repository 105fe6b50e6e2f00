"""The other front-end families on the card: K1 emitting raw filterbank
energies (log "none") for PLP13's 23 mel bands and PNCC13's 40 gammatone
bands, against its twin; PLP and PNCC behind it against the float64 golden
at the TPU's on-chip budgets; dither drawn on the card; and the stream
pool's recycled and untouched slots, bit for bit.

Marked ``cuda``: run with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_families.py`` on a machine with an H100 and nvcc
(``--noconftest`` because ``tests/conftest.py`` imports jax; this file
imports no jax). Without a card every test skips inside the ``cuda``
fixture.

Tolerances:
- K1 against its twin with log "none": ``compare_to_twin`` (its 1e-4 is
  relative to the LARGEST energy of the call, so it is loose for a band
  many decades down), and elementwise the bound that replaces it for raw
  energies: the sum-order bound (plus the one-flip bound at "default")
  plus 1e-4 of each energy itself. Raw energies span decades, and PLP's
  Levinson-Durbin feeds on the small ones, so each band is held relative
  to itself;
- PLP13 at bf16x3 behind K1 against the golden: max 5e-3, median 2e-4
  (``tests/test_tpu_smoke.py:317-345``); at "highest" 2e-3
  (``tests/test_plp.py``'s CPU budget); PNCC13 at bf16x3 5e-3, at
  "highest" and on the plain path 2e-3 (``tests/test_tpu_smoke.py:
  1060-1070``);
- the families' ``extract`` on the card against the CPU path: <= 1e-4
  scaled plain, <= 1e-3 with the kernel flags, fused or staged
  (``test_torch_cuda_kaldi39``);
- the pool: bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpufeat_torch import features, framing, streaming
from tpufeat_torch.config import (FBANK80, GFCC13, KALDI39, PLP13, PNCC13,
                                  SPEC257, WHISPER128)
from tpufeat_torch.kernels import _tolerance as tolerance
from tpufeat_torch.kernels import signal, staged
from tpufeat_torch.reference import cpu

pytestmark = pytest.mark.cuda

FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True)
PRECISIONS = ("highest", "bf16x3", "default")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _signal(n, seed):
    """Deterministic tones + noise in [-1, 1] (``tests/conftest.py``'s)."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.5 * np.sin(2 * np.pi * 440.0 * t) \
        + 0.2 * np.sin(2 * np.pi * 1333.0 * t + 0.3) \
        + 0.1 * r.standard_normal(n)
    return (sig / np.abs(sig).max() * 0.9).astype(np.float32)


def _scaled(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())
            ).item()


def raw_energy_tolerance(want: torch.Tensor, frames: torch.Tensor,
                         cfg) -> torch.Tensor:
    """Elementwise bound on |K1 - twin| for raw energies (log "none"):
    the sum-order bound (plus the one-flip bound at "default") plus
    TOL_TWIN of each energy itself."""
    flat = frames.reshape(-1, frames.shape[-1])
    t = tolerance.twin_stages(flat, cfg, True)
    bound = tolerance.sum_order_bound(t, cfg)
    if signal.passes(cfg) == 1:
        bound = bound + tolerance.one_pass_bound(t["mel"], cfg)
    return (bound.reshape(want.shape)
            + tolerance.TOL_TWIN * want.double().abs())


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("base", [PLP13, PNCC13], ids=["plp23", "pncc40"])
@pytest.mark.parametrize("n_frames", [1, 63, 64, 65, 500])
def test_k1_raw_energies_match_twin(cuda, base, prec, n_frames):
    cfg = dataclasses.replace(base, **FUSED, matmul_precision=prec)
    rng = np.random.default_rng(n_frames)
    M = (n_frames - 1) * cfg.hop_length + cfg.frame_length - 3
    buf = torch.tensor(rng.standard_normal((3, M)) * 0.1,
                       dtype=torch.float32, device=cuda)
    before = signal.mma_launches
    got = signal.signal_features(buf, n_frames, cfg)
    torch.cuda.synchronize()
    assert signal.mma_launches == before + 1
    want = signal.signal_features_reference(buf, n_frames, cfg)
    frames = framing.frames_from_buffer(buf, n_frames, cfg.frame_length,
                                        cfg.hop_length)
    assert got.shape == (3, n_frames, cfg.n_mels)
    tolerance.compare_to_twin(got, want, frames, cfg,
                              what=f"{cfg.n_mels} bands at {prec}")
    err = (got.double() - want.double()).abs()
    assert bool((err <= raw_energy_tolerance(want, frames, cfg)).all())


@pytest.mark.parametrize("prec,budget", [("bf16x3", (5e-3, 2e-4)),
                                         ("highest", (2e-3, None))])
def test_plp_behind_k1_within_the_on_chip_budget(cuda, prec, budget):
    cfg = dataclasses.replace(PLP13, **FUSED, matmul_precision=prec)
    for sig in (_signal(32000, 305), (0.1 * np.random.default_rng(305)
                                      .standard_normal(32000))
                .astype(np.float32)):
        got = features.extract(sig, cfg=cfg, device="cuda").features.cpu()
        d = np.abs(got.numpy() - cpu.plp(sig.astype(np.float64), PLP13))
        assert d.max() < budget[0]
        if budget[1] is not None:
            assert np.median(d) < budget[1]


@pytest.mark.parametrize("flags,budget", [
    ({}, 2e-3), (dict(FUSED, matmul_precision="highest"), 2e-3),
    (dict(FUSED, matmul_precision="bf16x3"), 5e-3)],
    ids=["plain", "fused_highest", "fused_bf16x3"])
def test_pncc_on_card_within_the_on_chip_budget(cuda, flags, budget):
    cfg = dataclasses.replace(PNCC13, **flags)
    sig = _signal(32000, 380)
    got = features.extract(sig, cfg=cfg, device="cuda").features.cpu()
    gold = cpu.extract(sig.astype(np.float64), PNCC13)
    assert np.abs(got.numpy() - gold).max() < budget


@pytest.mark.parametrize("flags", [{}, FUSED], ids=["plain", "fused"])
@pytest.mark.parametrize("base", [
    PLP13, PNCC13, SPEC257, FBANK80, WHISPER128, GFCC13,
    dataclasses.replace(FBANK80, vtln_warp=1.1)],
    ids=["plp13", "pncc13", "spec257", "fbank80", "whisper128", "gfcc13",
         "vtln"])
def test_families_on_card_match_cpu(cuda, base, flags):
    if base.n_mels == 0 and flags:
        pytest.skip("spectrogram features have no kernel route")
    cfg = dataclasses.replace(base, **flags)
    lengths = np.array([32000, 20001, 7777])
    x = np.stack([np.pad(_signal(n, 400 + b), (0, 32000 - n))
                  for b, n in enumerate(lengths)])
    before = signal.mma_launches
    got = features.extract(x, lengths, cfg, device="cuda")
    torch.cuda.synchronize()
    assert signal.mma_launches == before + bool(flags)
    want = features.extract(x, lengths, cfg, device="cpu")
    assert torch.equal(got.num_frames.cpu(), want.num_frames)
    tol = 1e-3 if flags else 1e-4
    for b, n in enumerate(want.num_frames.tolist()):
        assert _scaled(got.features[b, :n], want.features[b, :n]) <= tol


@pytest.mark.parametrize("flags,counter", [
    (dict(use_pallas=True, gemm_dft=True), "dft_mel_log_dct_mma_launches"),
    (dict(use_pallas=True), "mel_log_dct_launches")], ids=["k3", "k4"])
@pytest.mark.parametrize("base", [PLP13, PNCC13], ids=["plp13", "pncc13"])
def test_plp_pncc_on_staged_kernels_match_cpu(cuda, base, flags, counter):
    """The staged routes emit raw energies too (log "none"): K3 over the
    frames, or cuFFT and K4, then the PLP or PNCC tail."""
    cfg = dataclasses.replace(base, **flags)
    lengths = np.array([32000, 20001])
    x = np.stack([np.pad(_signal(n, 500 + b), (0, 32000 - n))
                  for b, n in enumerate(lengths)])
    before = getattr(staged, counter)
    got = features.extract(x, lengths, cfg, device="cuda")
    torch.cuda.synchronize()
    assert getattr(staged, counter) == before + 1
    want = features.extract(x, lengths, cfg, device="cpu")
    for b, n in enumerate(want.num_frames.tolist()):
        assert _scaled(got.features[b, :n], want.features[b, :n]) <= 1e-3


def test_dither_on_card(cuda):
    """The noise is drawn on the card from the caller's generator: the
    same seed gives the same bits, and the result is extract of x + d n
    with n from a clone of the generator."""
    cfg = dataclasses.replace(FBANK80, dither=0.5, **FUSED)
    x = torch.from_numpy(np.stack([_signal(16000, 1), _signal(16000, 2)])
                         ).to(cuda)

    def gen(seed):
        return torch.Generator(device=cuda).manual_seed(seed)
    a = features.extract(x, cfg=cfg, generator=gen(7)).features
    b = features.extract(x, cfg=cfg, generator=gen(7)).features
    assert torch.equal(a, b)
    noisy = x + 0.5 * torch.randn(x.shape, generator=gen(7), device=cuda)
    plain = dataclasses.replace(cfg, dither=0.0)
    assert torch.equal(a, features.extract(noisy, cfg=plain).features)
    with pytest.raises(ValueError, match="generator"):
        features.extract(x, cfg=cfg)
    with pytest.raises(RuntimeError):
        features.extract(x, cfg=cfg, generator=torch.Generator())


@pytest.mark.parametrize("sliding", [False, True], ids=["nocmvn", "sliding"])
def test_pool_recycled_and_untouched_slots_bitwise(cuda, sliding):
    """K1's fixed tile gives a frame's bits wherever it falls in the call:
    a recycled slot equals a zeros-prefix stream of the same batch after
    warmup_rows (with sliding CMVN from the first tick wholly past them),
    and every other slot keeps its bits."""
    change = dict(cmvn="sliding", cmvn_window=60, cmvn_min_window=20) \
        if sliding else dict(cmvn="none")
    cfg = dataclasses.replace(KALDI39, **FUSED, matmul_precision="highest",
                              **change)
    b, c, ticks, at = 8, 1600, 16, 3
    x = torch.randn(b, ticks * c, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    x = x * 0.1
    xz = x.clone()
    xz[2:4, :at * c] = 0.0                   # slots 2 and 3 recycled at `at`
    pipe = streaming.StreamingPipeline(cfg, b, device=cuda)
    pool = streaming.StreamPool(pipe)
    oracle = streaming.StreamingPipeline(cfg, b, device=cuda)
    for _ in range(b):
        pool.attach()
    checked = 0
    for k in range(ticks):
        if k == at:
            for s in (2, 3):
                pool.detach(s)
            assert sorted(pool.attach() for _ in range(2)) == [2, 3]
        rows = pool.process_batch(x[:, k * c:(k + 1) * c])
        want = oracle.process(xz[:, k * c:(k + 1) * c])
        for s in rows:
            n = rows[s].shape[0]
            crossing = s in (2, 3) and 0 < n < want.shape[1] and sliding
            if n and not crossing and (s not in (2, 3) or k >= at):
                assert torch.equal(rows[s], want[s, -n:]), (k, s)
                checked += s in (2, 3)
    assert checked
