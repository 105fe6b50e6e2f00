"""The port's sharding on the card: a one-rank NCCL group in this process
and a 2-rank gloo group of spawned processes sharing ``cuda:0`` (the
machine's one card: NCCL refuses two ranks on one GPU), each held
against the unsharded ``extract`` on the card, with the signal kernel's
launches counted in every rank.

Marked ``cuda``: run with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_sharding.py`` on a machine with a card
(``--noconftest`` because ``tests/conftest.py`` imports jax; this file
imports no jax). Without a card every test skips inside a fixture.

Tolerances: the fused route at bf16x3 (K1) equals the unsharded
``extract`` bit for bit without CMVN (K1 computes a frame's bits from the
frame alone; the halos are exact copies; a max is order-free); KALDI39's
CMVN within 2e-5 scaled by max(1, |want|.max()) (its sums over the
ranks reassociated).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpufeat_torch import config, extract, sharding
from tpufeat_torch.kernels import signal
from tpufeat_torch.multichip import spawn

import _torch_dist_cases

pytestmark = pytest.mark.cuda

FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True,
             matmul_precision="bf16x3")
CONFIGS = {name: dataclasses.replace(getattr(config, name), **FUSED)
           for name in ("WHISPER80", "MFCC13_HTK", "KALDI39")}
TOL_CMVN = 2e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="module")
def nccl(cuda, tmp_path_factory):
    """A one-rank NCCL group in this process."""
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _signal(seconds: int, ranks: int, seed: int) -> np.ndarray:
    n = sharding.shardable_length(seconds * 16000, config.WHISPER80, ranks)
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(
        np.float32)


def _batch(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, 10 * 16000)) * 0.1).astype(np.float32)
    return x, np.concatenate([[10 * 16000], rng.integers(
        16000, 10 * 16000, rows - 1)])


def _same(got, want, cfg):
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    assert got.shape == want.shape
    if cfg.cmvn == "none":
        assert torch.equal(got, want)
    else:
        err = (got.double() - want.double()).abs().max().item()
        assert err / max(1.0, want.abs().max().item()) <= TOL_CMVN


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_rank_nccl(nccl, cuda, name):
    cfg = CONFIGS[name]
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    sig = _signal(120, 1, 1)
    x, lengths = _batch(8, 2)
    signal.mma_launches = 0
    got_t = sharding.extract_time_sharded(sig, cfg, device=cuda)
    got_d = sharding.extract_data_parallel(x, lengths, cfg, device=cuda)
    torch.cuda.synchronize()
    assert signal.mma_launches == 2
    assert got_t.device.type == "cuda"
    _same(got_t, extract(sig, cfg=cfg, device=cuda).features, cfg)
    want = extract(x, lengths, cfg, device=cuda)
    assert torch.equal(got_d.mask, want.mask)
    _same(got_d.features, want.features, cfg)


@pytest.fixture(scope="module")
def two_ranks(cuda):
    """Every config time-sharded and data-parallel over 2 gloo ranks on
    cuda:0: rank 0's results and each rank's K1 launches."""
    sig, (x, lengths) = _signal(120, 2, 3), _batch(8, 4)
    cases = {}
    for name, cfg in CONFIGS.items():
        cases[f"time {name}"] = ("time", (sig,), dict(cfg=cfg))
        cases[f"dp {name}"] = ("dp", (x, lengths), dict(cfg=cfg))
    out, launches = spawn(_torch_dist_cases.counted_cases, 2, cases, cuda,
                          device=cuda)[0]
    return sig, x, lengths, out, launches


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_gloo_ranks_share_the_card(two_ranks, cuda, name):
    sig, x, lengths, out, launches = two_ranks
    cfg = CONFIGS[name]
    assert launches == [2 * len(CONFIGS)] * 2     # K1 in every rank
    _same(out[f"time {name}"], extract(sig, cfg=cfg, device=cuda).features,
          cfg)
    feats, mask = out[f"dp {name}"]
    want = extract(x, lengths, cfg, device=cuda)
    np.testing.assert_array_equal(mask, want.mask.cpu().numpy())
    _same(feats, want.features, cfg)


def test_collective_helper_on_gloo(cuda):
    """On a gloo group a device tensor's all_gather crosses through the
    host and comes back on the card; all_reduce takes it as it is."""
    got = spawn(_torch_dist_cases.collectives_on_card, 2, device=cuda)[0]
    assert got == {"gather": [[0.0, 1.0], "cuda"], "reduce": [1.0, "cuda"]}
