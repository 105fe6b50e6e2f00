"""Device-time breakdown of the streaming steps and the staged extracts on
one CUDA card, with torch.profiler.

    python -m tpufeat_torch.profile_stream [--steps 10]

Drives S = 4096 streams of 100 ms MFCC-13 chunks (the chunk of
``benchmarks/serving.py``) through four steps: the static fused step (the
signal kernel), the dynamic step with the staged flags (K3) and with
``gemm_dft`` off (K4), and the static step with ``use_energy`` (K3). Each
runs with its kernel and with the kernel replaced by its plain twin. Then
the steady step of ``StreamingPipeline`` on Kaldi-39 with sliding CMVN (K1
at "highest", then deltas and the sliding-CMVN ring). Then it times K1 and
K3 alone on one step's frames with CUDA events, and profiles the one-shot
extract of B = 128 x 30 s: staged through K3 and K4, and Kaldi-39 through
K1 with mean and with sliding CMVN.

Each profiled line gives, per call:

- wall ms: the host clock around ``--steps`` calls, ended by a synchronize
  (the profiler adds host time, so this is above an unprofiled run's);
- device ms: the summed self device time of the kernel rows of
  ``key_averages()`` (device type CUDA; operator rows, which repeat their
  kernels' time, are not counted);
- idle share: 1 - device / wall;
- the largest kernels.

The first line is the card's name, power limit and SM clocks. Imports
nothing of jax.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import statistics
import subprocess
import time
from unittest import mock

import torch

from tpufeat_torch import (KALDI39, MFCC13_HTK, StreamingPipeline, extract,
                           framing, streaming)
from tpufeat_torch.kernels import signal, staged

STREAMS, CHUNK, STEPS = 4096, 1600, 30      # benchmarks/serving.py's 100 ms
FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True,
             matmul_precision="bf16x3")
STAGED_K3 = dict(use_pallas=True, gemm_dft=True, matmul_precision="bf16x3")
STAGED_K4 = dict(use_pallas=True, matmul_precision="bf16x3")
TOP = 7                                     # kernels listed per line


def breakdown(name: str, fn, calls: int) -> None:
    """Profile ``calls`` calls of ``fn`` after two warm ones; print one
    line of per-call wall ms, device ms and idle share, then the largest
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    device = sum(e.self_device_time_total for e in rows) / 1e3 / calls
    print(f"{name}: wall {wall:.3f} ms per call, device {device:.3f} ms per "
          f"call, idle share {1 - device / wall:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"    {e.self_device_time_total / 1e3 / calls:8.3f} ms  "
              f"x{e.count // calls:<3d} {e.key[:90]}")


def event_ms(fn, reps: int) -> float:
    """Median CUDA-event ms of ``reps`` calls of ``fn`` after a warm one."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stepper(cfg, dynamic: bool, module, kernel: str, twin: bool, chunks):
    """One steady-state streaming step per call (the first, which fills
    the carry, runs here)."""
    fe = streaming.StreamingFrontend(cfg, STREAMS, device="cuda")
    state = streaming.init_state(STREAMS, cfg, device="cuda")
    k = 0

    def step():
        nonlocal state, k
        chunk = chunks[k % len(chunks)]
        k += 1
        with mock.patch.object(module, kernel,
                               getattr(module, f"{kernel}_reference")) \
                if twin else contextlib.nullcontext():
            if dynamic:
                state, _ = streaming.process_chunk(state, chunk, cfg)
            else:
                fe.process(chunk)
    step()
    return step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10,
                    help="profiled calls per streaming step (default 10)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(STREAMS, STEPS * CHUNK, generator=gen, device="cuda") * 0.1
    chunks = [x[:, k * CHUNK:(k + 1) * CHUNK].contiguous()
              for k in range(STEPS)]
    cfg_fused = dataclasses.replace(MFCC13_HTK, **FUSED)
    steps = {
        "static_fused": (cfg_fused, False, signal, "signal_features"),
        "dynamic_k3": (dataclasses.replace(MFCC13_HTK, **STAGED_K3), True,
                       staged, "dft_mel_log_dct"),
        "dynamic_k4": (dataclasses.replace(MFCC13_HTK, **STAGED_K4), True,
                       staged, "mel_log_dct"),
        "static_energy": (dataclasses.replace(cfg_fused, use_energy=True),
                          False, staged, "dft_mel_log_dct"),
    }
    for name, (cfg, dynamic, module, kernel) in steps.items():
        for twin in (False, True):
            breakdown(f"step {name} {'twin' if twin else 'kernel'}",
                      stepper(cfg, dynamic, module, kernel, twin, chunks),
                      args.steps)

    cfg_k39 = dataclasses.replace(KALDI39, cmvn="sliding",
                                  **dict(FUSED, matmul_precision="highest"))
    pipe = StreamingPipeline(cfg_k39, STREAMS, device="cuda")
    for chunk in chunks[:12]:            # past the 100-frame start-up
        pipe.process(chunk)
    k = 12

    def pipeline_step():
        nonlocal k
        pipe.process(chunks[k % STEPS])
        k += 1
    breakdown("step pipeline_kaldi39_sliding", pipeline_step, args.steps)

    # K1 and K3 alone on one steady step's frames: the buffer of
    # frame_length - 1 carried samples plus one chunk, 10 frames a stream
    fl, hop = cfg_fused.frame_length, cfg_fused.hop_length
    n = CHUNK // hop
    buf = torch.randn(STREAMS, fl - 1 + CHUNK, generator=gen,
                      device="cuda") * 0.1
    rows = framing.frames_from_buffer(buf, n, fl, hop).reshape(-1, fl)
    rows = rows.contiguous()
    k1 = event_ms(lambda: signal.signal_features(buf, n, cfg_fused), 21)
    k3 = event_ms(lambda: staged.dft_mel_log_dct(rows, cfg_fused), 21)
    twin = event_ms(
        lambda: signal.signal_features_reference(buf, n, cfg_fused), 21)
    print(f"signal kernel on [{STREAMS}, {fl - 1 + CHUNK}] x {n} frames: "
          f"{k1:.3f} ms")
    print(f"K3 on the same {rows.shape[0]} frames as rows: {k3:.3f} ms")
    print(f"signal twin on the same: {twin:.3f} ms")
    sig = torch.randn(128, 30 * 16000, generator=gen, device="cuda") * 0.1
    nf = cfg_fused.num_frames(sig.shape[1])
    k1 = event_ms(lambda: signal.signal_features(sig, nf, cfg_fused), 11)
    print(f"signal kernel on [128, {sig.shape[1]}] x {nf} frames: "
          f"{k1:.3f} ms")

    for name, cfg in (
            ("extract_k3", dataclasses.replace(MFCC13_HTK, **STAGED_K3)),
            ("extract_k4", dataclasses.replace(MFCC13_HTK, **STAGED_K4)),
            ("extract_kaldi39", dataclasses.replace(cfg_k39, cmvn="mean")),
            ("extract_kaldi39_sliding", cfg_k39)):
        breakdown(name, lambda: extract(sig, cfg=cfg), 3)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
