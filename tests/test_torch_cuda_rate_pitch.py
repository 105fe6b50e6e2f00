"""Resampling and pitch on the card: the resampler's exactness contract,
the pitch tracker and ``StreamingPipeline(input_rate=, pitch=)`` held
against the CPU run of the same call, and the fp32 products pinned
whatever the caller's TF32 setting.

Marked ``cuda``: run with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_rate_pitch.py`` on a machine with a card
(``--noconftest`` because ``tests/conftest.py`` imports jax; this file
imports no jax). Without a card every test skips inside the ``cuda``
fixture.

Tolerances:
- the streaming resampler against ``resample(whole)`` on the card:
  bitwise, every rate pair and chunk plan (the fixed-order tap sum);
  against the CPU: bitwise too (IEEE multiplies and adds, one rounding
  each, in the same order);
- ``block=256`` on the card against the CPU: 1e-6 scaled (cuBLAS and
  the CPU's BLAS sum in other orders);
- the pitch tracker on the card against the CPU: the same decisions on
  voiced rows (integer lags equal), hz rtol 1e-5 and POV 1e-5 abs there;
- the pipeline's 39 spectral columns on the card against the CPU: 1e-4
  scaled on the plain path, 1e-3 with the kernel flags (the K1 tolerance
  of ``tests/test_torch_cuda_kaldi39.py``); its pitch columns 1e-4 abs
  where the CPU's decisions agree;
- under ``set_float32_matmul_precision("high")`` against "highest":
  1e-6 scaled, and the same decisions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpufeat_torch import pitch, resampling, streaming
from tpufeat_torch.config import KALDI39

pytestmark = pytest.mark.cuda

RATES = [(8000, 16000), (16000, 8000), (48000, 16000), (44100, 16000),
         (22050, 16000), (16000, 2000)]
FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scaled(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape
    if got.numel() == 0:
        return 0.0
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())
            ).item()


def _voiced(b, n, seed, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 100.0 + 13.0 * np.arange(b)[:, None]
    x = 0.4 * np.sin(2 * np.pi * f0 * t[None, :]) \
        + 0.1 * np.sin(2 * np.pi * 2 * f0 * t[None, :] + 0.3)
    return (x + 0.01 * rng.standard_normal((b, n))).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_streaming_resampler_is_exact_on_the_card(cuda, sr_in, sr_out):
    x = torch.randn(5, sr_in // 2 + 137, generator=torch.Generator(
        ).manual_seed(sr_in), dtype=torch.float32)
    want = resampling.resample(x.to(cuda), sr_in, sr_out)
    r = resampling.StreamingResampler(sr_in, sr_out, 5, device=cuda)
    outs, i = [], 0
    for step in (160, 1, 1601, 7, 4800, x.shape[1]):
        step = min(step, x.shape[1] - i)
        outs.append(r.process(x[:, i:i + step].to(cuda)))
        i += step
    outs.append(r.flush())
    got = torch.cat(outs, dim=1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), resampling.resample(x, sr_in, sr_out))


def test_blocked_resampler_on_the_card(cuda):
    x = torch.randn(8, 48000, generator=torch.Generator().manual_seed(3))
    got = resampling.resample(x.to(cuda), 16000, 2000, block=256)
    assert _scaled(got, resampling.resample(x, 16000, 2000, block=256)) \
        <= 1e-6
    assert _scaled(got, resampling.resample(x, 16000, 2000)) <= 1e-6


def test_pitch_track_on_the_card(cuda):
    x = _voiced(16, 32000, 5)
    lens = np.full(16, 32000)
    lens[3], lens[9] = 20000, 12345
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    cfg = dataclasses.replace(pitch.PitchConfig(), refine=False)
    hz_c, pov_c, v_c = pitch.track(x, lens, cfg, device="cpu")
    hz_g, pov_g, v_g = (t.cpu() for t in pitch.track(x, lens, cfg,
                                                     device=cuda))
    assert torch.equal(v_c, v_g)
    assert torch.equal(hz_c[v_c], hz_g[v_g])          # the same lags
    torch.testing.assert_close(pov_g[v_g], pov_c[v_c], rtol=0, atol=1e-5)
    hz_c, _, _ = pitch.track(x, lens, device="cpu")
    hz_g, _, _ = pitch.track(x, lens, device=cuda)
    torch.testing.assert_close(hz_g.cpu()[v_c], hz_c[v_c], rtol=1e-5,
                               atol=0)


def test_tf32_does_not_move_pitch(cuda):
    x = torch.from_numpy(_voiced(8, 24000, 6)).to(cuda)
    torch.set_float32_matmul_precision("highest")
    want = pitch.pitch_features(x, device=cuda)[0]
    s_want, _ = pitch.nccf(x, torch.full((8,), 24000, device=cuda),
                           pitch.PitchConfig())
    try:
        torch.set_float32_matmul_precision("high")
        got = pitch.pitch_features(x, device=cuda)[0]
        s_got, _ = pitch.nccf(x, torch.full((8,), 24000, device=cuda),
                              pitch.PitchConfig())
    finally:
        torch.set_float32_matmul_precision("highest")
    assert _scaled(s_got, s_want) <= 1e-6
    assert _scaled(got, want) <= 1e-6


@pytest.mark.parametrize("flags", ["plain", "fused"])
def test_pipeline_with_rate_and_pitch_matches_the_cpu(cuda, flags):
    S, steps, C = 256, 12, 4800
    cfg = dataclasses.replace(KALDI39, cmvn="sliding", cmvn_window=60,
                              cmvn_min_window=20,
                              **(FUSED if flags == "fused" else {}))
    x = _voiced(S, steps * C, 7, sr=48000)
    outs = {}
    for dev in ("cpu", cuda):
        pipe = streaming.StreamingPipeline(cfg, S, pitch=True,
                                           input_rate=48000, device=dev)
        rows = [pipe.process(x[:, k * C:(k + 1) * C]) for k in range(steps)]
        rows.append(pipe.flush())
        outs[str(dev)] = torch.cat(rows, dim=1).cpu()
    got, want = outs["cuda"], outs["cpu"]
    assert got.shape == want.shape and got.shape[-1] == 42
    assert bool(torch.isfinite(got).all())
    tol = 1e-3 if flags == "fused" else 1e-4
    assert _scaled(got[..., :39], want[..., :39]) <= tol
    # the pitch columns where the decisions agree: the same log-pitch
    same = (got[..., 40] - want[..., 40]).abs() < 1e-3
    assert same.float().mean().item() > 0.99
    torch.testing.assert_close(got[..., 39:][same], want[..., 39:][same],
                               rtol=0, atol=1e-4)
