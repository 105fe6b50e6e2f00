"""Rank-side halves of the port's multi-rank CPU tests: module-level
functions that ``tpufeat_torch.multichip.spawn`` runs in every rank of a
gloo group on the CPU. They import numpy, torch and the port only (a rank
never imports jax), take numpy inputs made in the test process and return
numpy results from rank 0 (None from the others)."""

import numpy as np
import torch


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple):
        return tuple(_host(v) for v in value)
    return value


def sharding_cases(cases: dict, device: str = "cpu") -> dict | None:
    """Each case ``name -> (kind, args, kwargs)`` through the port's
    sharding on ``device``: kind "time" (extract_time_sharded), "dp"
    (extract_data_parallel, features and mask), "pitch_dp"
    (pitch_features_data_parallel) or "batch_time"
    (extract_batch_time_sharded on a (2, ranks / 2) ("dp", "time") mesh,
    features and mask) or "corpus" (``pipeline.extract_corpus(dp=True)``:
    rank 0's rows by key, and how many rows each rank yielded)."""
    from torch.distributed.device_mesh import DeviceMesh

    from tpufeat_torch import pipeline, sharding
    rank, ranks = sharding.rank_and_size()
    mesh = DeviceMesh("cpu", torch.arange(ranks).reshape(2, -1),
                      mesh_dim_names=("dp", "time"))
    out = {}
    for name, (kind, args, kw) in cases.items():
        if kind == "time":
            got = sharding.extract_time_sharded(*args, device=device, **kw)
        elif kind == "corpus":
            rows = dict(pipeline.extract_corpus(*args, dp=True,
                                                device=device, **kw))
            got = (rows, sharding._gather_rows(
                [torch.tensor([len(rows)])])[0].tolist())
        elif kind == "pitch_dp":
            got = sharding.pitch_features_data_parallel(*args, device=device,
                                                        **kw)
        else:
            if kind == "batch_time":
                res = sharding.extract_batch_time_sharded(
                    *args, mesh=mesh, device=device, **kw)
            else:
                res = sharding.extract_data_parallel(*args, device=device,
                                                     **kw)
            got = (res.features, res.mask)
        out[name] = _host(got)
    return out if rank == 0 else None


def counted_cases(cases: dict, device: str) -> tuple | None:
    """:func:`sharding_cases` on ``device`` with the signal kernel's launch
    count set to 0 first: (rank 0's results, every rank's launches)."""
    from tpufeat_torch import sharding
    from tpufeat_torch.kernels import signal
    signal.mma_launches = 0
    out = sharding_cases(cases, device)
    launches = sharding._gather_rows([torch.tensor([signal.mma_launches])])
    return (out, launches[0].tolist()) if out is not None else None


def xvector_dp_step(state_dict: dict, feats, mask, labels,
                    channels: int) -> dict | None:
    """One data-parallel x-vector step with Adam at 1e-3 (optax.adam's
    defaults) from ``state_dict``, each rank on its rows of the batch."""
    from tpufeat_torch import sharding
    from tpufeat_torch.models import xvector as xv
    rank, _ = sharding.rank_and_size()
    rows = sharding._own_rows(len(feats), None, "xvector_dp_step")
    model = xv.xvector_model(4, in_dim=feats.shape[-1], embed_dim=16,
                             channels=channels, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in state_dict.items()})
    state = xv.XvectorState(model, torch.optim.Adam(model.parameters(),
                                                    lr=1e-3))
    _, loss = xv.xvector_train_step(state, feats[rows], mask[rows],
                                    labels[rows])
    if rank:
        return None
    return {"loss": loss.item(),
            "params": {k: v.detach().numpy()
                       for k, v in model.state_dict().items()}}


def collectives_on_card() -> dict | None:
    """An all_gather and an all_reduce of a tensor on the card through the
    port's collective helper: their values and devices."""
    from tpufeat_torch import sharding
    rank, _ = sharding.rank_and_size()
    t = torch.tensor([float(rank)], device="cuda")
    parts = sharding._collective("all_gather", t)
    total = sharding._collective("all_reduce", t.clone())
    if rank:
        return None
    return {"gather": [[p.item() for p in parts], parts[0].device.type],
            "reduce": [total.item(), total.device.type]}


def fail_on_rank(rank: int, how: str) -> None:
    """Rank ``rank`` raises (``how="raise"``) or exits without a result
    (``how="exit"``); the others wait for the parent to end them."""
    import os
    import time

    from tpufeat_torch import sharding
    if sharding.rank_and_size()[0] == rank:
        if how == "raise":
            raise ValueError(f"rank {rank} failed on purpose")
        os._exit(3)
    time.sleep(120)
