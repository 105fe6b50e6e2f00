"""Multi-rank runs on one host, and the multi-device dry run — counterpart
of ``__graft_entry__.dryrun_multichip``.

:func:`spawn` runs a function in ``world_size`` fresh processes (the
``spawn`` start method: a rank never inherits its parent's CUDA context),
each a rank of a process group that meets over a file store in a temporary
directory, and returns each rank's result. Each rank computes on
``device``: with a card for every rank, rank r on ``cuda:r`` over NCCL;
with fewer cards than ranks, every rank on the current card over gloo
(NCCL refuses two ranks on one GPU); on the CPU over gloo.

:func:`dryrun_multichip` drives the reference's four parts with numeric
parity against the unsharded paths: data parallelism on ``MFCC13_HTK`` and
``GFCC13``, time sharding on ``KALDI39`` and ``WHISPER80``, the 2-D
``(dp, time)`` mesh when ``world_size >= 4`` and even, the CTC, RNN-T and
x-vector steps data-parallel, and dp-split utterance i-vectors and PLDA
trial scores.

    python -m tpufeat_torch.multichip 8 --device cpu
"""

from __future__ import annotations

import argparse
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tpufeat_torch import sharding

#: the dry run's bound on a sharded result against the unsharded one,
#: scaled by max(1, |want|.max()): CMVN's sums and the gradient's
#: all-reduce reassociate f32 sums (__graft_entry__.py's bound)
TOL = 2e-5
#: a dp step's parameters after one update against the unsharded step's:
#: the averaged gradient differs from the whole batch's by f32 sum order,
#: and one Adam(W) step moves a parameter by at most about its learning
#: rate, the first step's normalised update being near +-1 wherever the
#: gradient is far from 0
TOL_PARAMS = 1e-6


def _rank_main(rank: int, world_size: int, store: str, device: str,
               fn, args: tuple, results) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // world_size))
        dist.init_process_group(sharding.backend_for(device, world_size),
                                init_method=f"file://{store}", rank=rank,
                                world_size=world_size)
        results.put((rank, True, fn(*args)))
    except Exception:              # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, device="cuda",
          timeout: float = 900.0) -> list:
    """``fn(*args)`` on every rank of a fresh ``world_size``-rank process
    group (see the module's notes); returns the ranks' results in rank
    order. ``fn`` and its arguments are pickled by reference, so ``fn`` is
    a module-level function. If a rank raises, the others are terminated
    and RuntimeError carries its traceback; so when a rank dies without a
    result, or after ``timeout`` seconds without all of them."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world_size, store, str(device), fn, args, results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    # a rank that reported exits 0; a non-zero exit
                    # without a result (a signal, an interrupt) is a death
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    missing = sorted(set(range(world_size)) - set(got))
                    if dead:
                        raise RuntimeError(f"spawn: ranks {dead} exited "
                                           "without a result") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"spawn: no result from ranks "
                                           f"{missing} in {timeout} s"
                                           ) from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                if len(got) < world_size and p.is_alive():
                    p.terminate()
                p.join(60)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world_size)]


def scaled_err(got, want) -> float:
    """max |got - want| / max(1, |want|.max()), float64, on the host."""
    got = torch.as_tensor(got).detach().cpu().double()
    want = torch.as_tensor(want).detach().cpu().double()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    return (got - want).abs().max().item() / max(1.0,
                                                 want.abs().max().item())


def _close(got, want, tol: float, what: str) -> float:
    err = scaled_err(got, want)
    if not err <= tol:
        raise AssertionError(f"{what}: sharded vs unsharded {err:.3e} "
                             f"(limit {tol})")
    return err


def xvector_step(group=None, device=None, batch: int | None = None
                 ) -> dict:
    """The dry run's x-vector step (``__graft_entry__.py``'s shapes: 4
    speakers, embedding 16, 16 channels, 50 frames of 13 dims, Adam at
    1e-3), data-parallel over ``group``: the batch (default two rows a
    rank) from seed 1 and split over the ranks, the net seeded (torch seed
    0). Returns {"loss": the whole batch's mean, "params": by name}."""
    from tpufeat_torch.models import xvector as xv
    _, ranks = sharding.rank_and_size(group)
    batch = 2 * ranks if batch is None else batch
    rng = np.random.default_rng(1)
    feats = (rng.standard_normal((batch, 50, 13)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 4, size=batch)
    rows = sharding._own_rows(batch, group, "xvector_step")
    torch.manual_seed(0)
    model = xv.xvector_model(4, in_dim=13, embed_dim=16, channels=16,
                             device=device)
    state = xv.XvectorState(model, torch.optim.Adam(model.parameters(),
                                                    lr=1e-3))
    _, loss = xv.xvector_train_step(state, feats[rows],
                                    np.ones((rows.stop - rows.start, 50),
                                            np.float32),
                                    labels[rows], group=group)
    return {"loss": loss.item(),
            "params": {k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()}}


def _speaker_model(rng, G: int = 8, D: int = 13, K: int = 6):
    """A seeded random i-vector extractor (``G`` gaussians over ``D``-dim
    features, ``K``-dim i-vectors) and PLDA model."""
    from tpufeat_torch import ivector as iv
    from tpufeat_torch import plda as pl
    ubm = iv.DiagUbm(np.full(G, 1.0 / G), rng.standard_normal((G, D)),
                     np.abs(rng.standard_normal((G, D))) + 0.5)
    ext = iv.IvectorExtractor(ubm, rng.standard_normal((G, D, K)) * 0.1)
    plda = pl.Plda(rng.standard_normal(K), rng.standard_normal((K, K)),
                   np.abs(rng.standard_normal(K)) + 0.5)
    return ext, plda


def _dryrun_rank(world_size: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`: every part but the training
    steps' unsharded references, checked in the rank; returns the errors
    and the steps' results."""
    from tpufeat_torch import extract
    from tpufeat_torch import ivector as iv
    from tpufeat_torch.config import GFCC13, KALDI39, MFCC13_HTK, WHISPER80
    from tpufeat_torch.models import train
    rank, _ = sharding.rank_and_size()
    rng = np.random.default_rng(0)
    errs = {}
    B = world_size * 2

    # data parallelism over the batch axis (MFCC and the GFCC family)
    sigs = (rng.standard_normal((B, 4000)) * 0.1).astype(np.float32)
    lengths = np.full((B,), 4000)
    for name, cfg in (("MFCC13_HTK", MFCC13_HTK), ("GFCC13", GFCC13)):
        res = sharding.extract_data_parallel(sigs, lengths, cfg,
                                             device=device)
        if tuple(res.features.shape) != (B, 23, 13):
            raise AssertionError(f"dp {name}: {tuple(res.features.shape)}")
        errs[f"dp {name}"] = _close(res.features, extract(
            sigs, lengths, cfg, device=device).features, TOL, f"dp {name}")

    # time sharding: halos, CMVN's all_reduce(SUM), deltas; Whisper's
    # all_reduce(MAX) and the reflect at the global edges
    for name, cfg in (("KALDI39", KALDI39), ("WHISPER80", WHISPER80)):
        n = sharding.shardable_length(world_size * 3200, cfg, world_size)
        sig = (rng.standard_normal(n) * 0.1).astype(np.float32)
        out = sharding.extract_time_sharded(sig, cfg, device=device)
        if out.shape[0] != cfg.num_frames(n):
            raise AssertionError(f"time {name}: {out.shape[0]} frames")
        errs[f"time {name}"] = _close(out, extract(
            sig, cfg=cfg, device=device).features, TOL, f"time {name}")

    # the 2-D mesh: dp x time at once
    if world_size >= 4 and world_size % 2 == 0:
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh("cpu", torch.arange(world_size).reshape(2, -1),
                          mesh_dim_names=("dp", "time"))
        n_time = world_size // 2
        n = sharding.shardable_length(n_time * 3200, KALDI39, n_time)
        xb = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
        res = sharding.extract_batch_time_sharded(
            xb, np.full((2,), n), KALDI39, mesh, device=device)
        for b in range(2):
            errs[f"2-D row {b}"] = _close(
                res.features[b][res.mask[b]],
                extract(xb[b], cfg=KALDI39, device=device).features, TOL,
                f"2-D row {b}")

    # the training steps, batch split over the ranks, parameters replicated
    steps = {"asr": train.dryrun_train_step(device=device),
             "xvector": xvector_step(device=device)}

    # the speaker stack: dp-split utterance i-vectors, then PLDA trials
    ext, plda = _speaker_model(rng)
    sfeats = rng.standard_normal((B, 40, 13)).astype(np.float32)
    rows = sharding._own_rows(B, None, "i-vectors")
    ivecs, = sharding._gather_rows([iv.utterance_ivector(
        ext, sfeats[rows], device=device)])
    want = iv.utterance_ivector(ext, sfeats, device=device)
    errs["i-vectors"] = _close(ivecs, want, 1e-4, "i-vectors")
    scores, = sharding._gather_rows([plda.score(
        ivecs[: B // 2], ivecs[rows], device=device)], dim=1)
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError("PLDA scores not finite")
    errs["PLDA scores"] = _close(
        scores, plda.score(want[: B // 2], want, device=device), 1e-4,
        "PLDA scores")
    if rank == 0:
        print(f"dryrun x-vector train step ({world_size} ranks): loss "
              f"{steps['xvector']['loss']:.3f}")
        print(f"dryrun speaker stack ({world_size} ranks): "
              f"{scores.shape[0]}x{scores.shape[1]} PLDA trials OK",
              flush=True)
    return {"errors": errs, "steps": steps}


def dryrun_multichip(world_size: int, device=None) -> dict:
    """Spawn ``world_size`` ranks (:func:`spawn`) and run the reference's
    multi-device dry run on ``device`` (default the card), each part held
    against its unsharded counterpart; the training steps against the same
    steps on the whole batch in this process. Returns rank 0's errors by
    part; raises on any failure."""
    from tpufeat_torch import features
    from tpufeat_torch.models import train
    device = str(features.default_device(device))
    if torch.device(device).type == "cuda":
        # build the kernel library once, before the ranks need it
        from tpufeat_torch.kernels import _build
        _build.load(str(_build.CSRC))
    ranks = spawn(_dryrun_rank, world_size, world_size, device,
                  device=device)
    errs = dict(ranks[0]["errors"])
    steps = ranks[0]["steps"]
    whole = {"asr": train.dryrun_train_step(device=device,
                                            batch=2 * world_size),
             "xvector": xvector_step(device=device, batch=2 * world_size)}
    for part, keys in (("asr", (("ctc", "ctc_params"),
                                ("rnnt", "rnnt_params"))),
                       ("xvector", (("loss", "params"),))):
        for loss, params in keys:
            got, want = steps[part][loss], whole[part][loss]
            what = part if loss == "loss" else f"{part} {loss}"
            errs[f"{what} loss"] = _close(got, want, TOL, f"{what} loss")
            gap = max(float(np.abs(steps[part][params][k]
                                   - whole[part][params][k]).max())
                      for k in whole[part][params])
            if not gap <= TOL_PARAMS:
                raise AssertionError(f"{what} parameters after one step: "
                                     f"{gap:.3e} (limit {TOL_PARAMS})")
            errs[f"{what} params"] = gap
    for part, err in errs.items():
        print(f"dryrun {part}: {err:.3e}")
    print(f"dryrun_multichip({world_size}): OK", flush=True)
    return errs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tpufeat_torch.multichip",
        description="the multi-device dry run over torch.distributed")
    p.add_argument("world_size", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; refuses to run without a card) or "
                        "cpu")
    args = p.parse_args(argv)
    from tpufeat_torch import cli
    dryrun_multichip(args.world_size, cli.device_of(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
