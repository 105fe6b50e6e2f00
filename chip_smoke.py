"""Smoke run of tpufeat_torch on one NVIDIA GPU — the quickest proof that the
port builds and runs its main path on the card.

    python3 chip_smoke.py

In order: the card and toolchain; the CUDA build of every kernel of the main
path (with nvcc's -Xptxas -v resource lines); each kernel against its plain
twin on the card; the main path — batched Whisper-80 + MFCC-13 extraction
of B=128 x 30 s of 16 kHz audio through ``tpufeat_torch.extract`` with the
fused flags — with its launch counts and its error against the float64
golden; and the timing of that dual call, kernel path and twin path in
turns. Any failure exits non-zero; nothing is caught. Needs one CUDA card
and nvcc; imports nothing of jax or tpufeat. The last line of stdout is one
JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

SR = 16000
BATCH, SECONDS = 128, 30            # the main path's batch (bench.py)
TOL_KERNEL = 1e-4   # kernel vs twin, relative to max(1, |twin|.max()):
#                     fp32 in both, sums in another order
TOL_GOLDEN = 1e-3   # features vs the float64 golden, same scaling: the
#                     repo's fidelity budget
REPS = 11           # timed runs per path (median)
FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True,
             matmul_precision="bf16x3")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max(1, |want|.max()))."""
    err = (got.double() - want.double()).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def cuda_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from tpufeat_torch import WHISPER80, MFCC13_HTK, extract
    from tpufeat_torch import framing
    from tpufeat_torch.kernels import _build, signal
    from tpufeat_torch.reference import cpu

    # 1. the card and the toolchain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build every kernel of the path from the checkout's sources
    built = _build.load(str(_build.CSRC))
    how = "ran" if built.build_seconds else "reused an earlier build"
    print(f"build: {built.path.name} in {built.build_seconds:.2f} s "
          f"(nvcc {how})")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())
    for cfg in (WHISPER80, MFCC13_HTK):
        smem, blocks = signal.resources(cfg)
        print(f"  launch for {cfg.n_mels}-mel: {smem} B dynamic shared "
              f"memory per block, {blocks} blocks per SM")

    # 3. kernel vs plain twin, both on the card
    tf = signal.TILE_FRAMES
    variants = {
        "whisper80": WHISPER80,
        "mfcc13": MFCC13_HTK,
        "mfcc13_kaldi_dc": dataclasses.replace(
            MFCC13_HTK, kaldi_mode=True, dc_offset=True),
        "mfcc13_magnitude": dataclasses.replace(MFCC13_HTK,
                                                spectrum="magnitude"),
        "mfcc13_lifter22": dataclasses.replace(MFCC13_HTK, lifter=22),
        "mfcc13_log10": dataclasses.replace(MFCC13_HTK, log="log10"),
    }
    rng = np.random.default_rng(1)
    worst = 0.0
    for name, cfg in variants.items():
        for n_frames in (1, tf - 1, tf, tf + 1, 127, 128, 129, 3000):
            for batch in (1, 3):
                # 3 samples short of the last frame: the zero reads past M
                M = (n_frames - 1) * cfg.hop_length + cfg.frame_length - 3
                buf = torch.tensor(rng.standard_normal((batch, M)) * 0.1,
                                   dtype=torch.float32, device="cuda")
                got = signal.signal_features(buf, n_frames, cfg)
                torch.cuda.synchronize()
                want = signal.signal_features_reference(buf, n_frames, cfg)
                torch.cuda.synchronize()
                check(got.shape == want.shape, f"{name} shape {got.shape}")
                check(bool(torch.isfinite(got).all()), f"{name} not finite")
                err, rel = scaled_err(got, want)
                worst = max(worst, rel)
                print(f"kernel vs twin {name:17s} n_frames={n_frames:4d} "
                      f"B={batch}: max_abs_err={err:.3e} scaled={rel:.3e}")
                check(rel <= TOL_KERNEL, f"{name} n_frames={n_frames} "
                      f"B={batch}: {rel:.3e} > {TOL_KERNEL}")
    print(f"kernel vs twin: every case within {TOL_KERNEL} "
          f"(worst scaled {worst:.3e})")

    # 4. the main path through the public entry point
    cfg_mel = dataclasses.replace(WHISPER80, **FUSED)
    cfg_mfcc = dataclasses.replace(MFCC13_HTK, **FUSED)
    n = SECONDS * SR
    sig = (np.random.default_rng(0).standard_normal((BATCH, n))
           * 0.1).astype(np.float32)
    lengths = np.full((BATCH,), n, dtype=np.int32)
    signal.launches = 0
    mel = extract(sig, lengths, cfg_mel, device="cuda")
    mfcc = extract(sig, lengths, cfg_mfcc, device="cuda")
    torch.cuda.synchronize()
    launches = signal.launches
    print(f"main path: whisper80 {tuple(mel.features.shape)} mfcc13 "
          f"{tuple(mfcc.features.shape)}; signal kernel launches {launches}")
    check(launches == 2, f"expected 1 launch per config, got {launches}")
    for res, cfg, base in ((mel, cfg_mel, WHISPER80),
                           (mfcc, cfg_mfcc, MFCC13_HTK)):
        check(res.features.shape == (BATCH, cfg.num_frames(n),
                                     cfg.feature_dim), "main-path shape")
        check(bool(torch.isfinite(res.features).all()), "main path finite")
        gold = cpu.extract(sig[0].astype(np.float64), base)
        err, rel = scaled_err(res.features[0].cpu(), torch.from_numpy(gold))
        print(f"main path row 0 vs float64 golden, {base.n_mels}-mel: "
              f"max_abs_err={err:.3e} scaled={rel:.3e}")
        check(rel <= TOL_GOLDEN, f"row 0 vs golden {rel:.3e}")

    ragged = np.array([n, 400_123, 250_000, 160_000, 96_001, 16_000, 3_201,
                       350])
    xr = np.zeros((len(ragged), n), np.float32)
    for i, L in enumerate(ragged):
        xr[i, :L] = sig[i, :L]
    for cfg, base in ((cfg_mel, WHISPER80), (cfg_mfcc, MFCC13_HTK)):
        res = extract(xr, ragged, cfg, device="cuda")
        feats, mask = res.features.cpu(), res.mask.cpu()
        worst = 0.0
        for i, L in enumerate(ragged):
            gold = cpu.extract(xr[i, :L].astype(np.float64), base)
            nf = int(res.num_frames[i])
            check(nf == gold.shape[0], f"row {i}: {nf} frames, golden "
                  f"{gold.shape[0]}")
            check(int(mask[i].sum()) == nf and bool(mask[i, :nf].all()),
                  f"row {i} mask")
            if nf:
                worst = max(worst, scaled_err(feats[i, :nf],
                                              torch.from_numpy(gold))[1])
        print(f"ragged B={len(ragged)} {base.n_mels}-mel: frame counts and "
              f"masks match the golden; worst scaled err {worst:.3e}")
        check(worst <= TOL_GOLDEN, f"ragged vs golden {worst:.3e}")

    # 5. timing on the card: the dual call, kernel path and twin path in turns
    x = torch.from_numpy(sig).cuda()
    lx = torch.from_numpy(lengths).cuda()

    def dual():
        return (extract(x, lx, cfg_mel).features,
                extract(x, lx, cfg_mfcc).features)

    def twin_dual():
        with mock.patch.object(signal, "signal_features",
                               signal.signal_features_reference):
            return dual()

    bufs = []
    for cfg in (cfg_mel, cfg_mfcc):
        xx = framing.preemphasize(x, cfg.preemphasis) \
            if cfg.preemphasis else x
        bufs.append((framing.framing_buffer(xx, lx, cfg)[0].contiguous(),
                     cfg.num_frames(n), cfg))

    def kernels():
        return [signal.signal_features(*b) for b in bufs]

    def twins():
        return [signal.signal_features_reference(*b) for b in bufs]

    got, want = kernels(), twins()
    torch.cuda.synchronize()
    main_err = max(scaled_err(g, w)[0] for g, w in zip(got, want))
    main_rel = max(scaled_err(g, w)[1] for g, w in zip(got, want))
    print(f"kernel vs twin at the main path's shapes: max_abs_err="
          f"{main_err:.3e} scaled={main_rel:.3e}")
    check(main_rel <= TOL_KERNEL, f"main-path kernel vs twin {main_rel:.3e}")
    del got, want

    paths = {"dual_kernel": dual, "dual_twin": twin_dual,
             "kernel_only": kernels, "twin_only": twins}
    peak = {}
    for name, fn in paths.items():               # warm-up + peak memory
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated()
    times = {name: [] for name in paths}
    for rep in range(REPS):
        order = list(paths) if rep % 2 == 0 else list(reversed(paths))
        for name in order:
            times[name].append(cuda_ms(paths[name]))
    ms = {name: statistics.median(t) for name, t in times.items()}
    audio = BATCH * SECONDS
    for name in paths:
        print(f"{name:12s}: median {ms[name]:.3f} ms per batch of "
              f"{BATCH} x {SECONDS} s (RTFx {audio / (ms[name] / 1e3):.0f}), "
              f"runs {['%.3f' % t for t in times[name]]}, "
              f"peak memory {peak[name] / 2**20:.0f} MiB [{card}]")

    print(json.dumps({"kernels": [{
        "name": "signal_features",
        "route": "cuda",
        "source": "tpufeat_torch/csrc/signal_features.cu",
        "replaces": "tpufeat/pallas/fused.py:669",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": ms["kernel_only"],
        "plain_ms": ms["twin_only"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
