"""Smoke run of tpufeat_torch on one NVIDIA GPU — the quickest proof that the
port builds and runs its paths on the card.

    python3 chip_smoke.py

In order: the card and toolchain; the CUDA build of every kernel (with
nvcc's -Xptxas -v resource lines and each launch's shared memory and
blocks per SM); the signal kernel against its plain twin on the card; the
main path — batched Whisper-80 + MFCC-13 extraction of B=128 x 30 s of
16 kHz audio through ``tpufeat_torch.extract`` with the fused flags — with
its launch counts and its error against the float64 golden, and the timing
of that dual call, kernel path and twin path in turns; the staged GEMM
kernel (K3) and the tail kernel (K4) against their twins over a grid of
configs and row counts; the staged one-shot extraction of the same batch
through K3 and through cuFFT + K4, checked and timed the same way; and the
streaming front-end at serving size (4096 streams of 100 ms chunks) through
``StreamingFrontend``, ``extract_scan`` and the dynamic step, checked bit
for bit across chunk plans, each path held against the same path with its
kernel replaced by the plain twin on every stream, and timed per step; and
the phase-kernel anatomy family (K5a-h): every mode of the eight runners of
``tpufeat_torch.experiments`` at its script's own shape through
``anatomy_features``, each held against its plain twin and both timed, with
the mode's bound, then every precision's pass count at the scripts' shape
(the ``dftonly`` tail, and the mel product behind an identity DFT).

Every path is driven with the launch counts set to 0 just before it and
read just after. Any failure exits non-zero; nothing is caught. Needs one
CUDA card and nvcc; imports nothing of jax or tpufeat. The line before the
last is the kernels' JSON summary (time, bound, launches, plain and library
times); the last line of stdout is one JSON object:
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import itertools
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
TOL_ROUTE = 1e-4    # one-shot staged routes vs the fused route, same scaling
TOL_STREAM = 1e-5   # streaming vs its one-shot counterpart, same scaling
REPS = 11           # timed runs per path (median)
FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True,
             matmul_precision="bf16x3")
STAGED_K3 = dict(use_pallas=True, gemm_dft=True, matmul_precision="bf16x3")
STAGED_K4 = dict(use_pallas=True, matmul_precision="bf16x3")
ROWS = (1, 31, 32, 33, 511, 512, 513, 40960)   # K3/K4 row counts
STREAMS, CHUNK, STEPS = 4096, 1600, 30  # benchmarks/serving.py's 100 ms
STEP_REPS = 15                          # timed steps per streaming path
# the bound's peaks: H100 SXM at 700 W, NVIDIA's published dense rates
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


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


def time_paths(paths: dict, reps: int) -> tuple[dict, dict, dict]:
    """Warm each path once (recording its peak memory), then time ``reps``
    runs of every path in turns, the order reversed every other round.
    Returns (median ms, every run's ms, peak bytes) per path."""
    peak = {}
    for name, fn in paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated()
    times = {name: [] for name in paths}
    for rep in range(reps):
        order = list(paths) if rep % 2 == 0 else list(reversed(paths))
        for name in order:
            times[name].append(cuda_ms(paths[name]))
    return ({name: statistics.median(t) for name, t in times.items()},
            times, peak)


def bound(flops: dict, nbytes: int) -> tuple[float, str]:
    """(least ms, "operations" or "bytes"): the larger of the FLOPs over
    the peak of their type (summed over types) and the bytes over the
    memory rate."""
    ops_ms = 1e3 * sum(f / PEAK_FLOPS[kind] for kind, f in flops.items())
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def tail_flops(rows: int, spec_rows: int, fb, dct) -> int:
    """FLOPs of the mel product and the DCT over ``rows`` spectra."""
    nm = fb.shape[1]
    return 2 * rows * (spec_rows * nm + (0 if dct is None
                                         else nm * dct.shape[1]))


def twin_of(module, name: str):
    """A context in which ``module.name`` (a kernel wrapper) is its plain
    twin ``module.name_reference``: the twin path of a timing."""
    return mock.patch.object(module, name, getattr(module, f"{name}_reference"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from tpufeat_torch import FBANK80, WHISPER80, MFCC13_HTK, extract
    from tpufeat_torch import framing, matrices, spectrum, streaming
    from tpufeat_torch.experiments import RUNNERS
    from tpufeat_torch.kernels import _build, anatomy, signal, staged
    from tpufeat_torch.reference import cpu

    counters = (("signal_features", signal, "launches"),
                ("dft_mel_log_dct", staged, "dft_mel_log_dct_launches"),
                ("mel_log_dct", staged, "mel_log_dct_launches"),
                ("anatomy_features", anatomy, "launches"))
    path_launches = {name: 0 for name, _, _ in counters}

    def reset_counts() -> None:
        for _, mod, attr in counters:
            setattr(mod, attr, 0)

    def read_counts(path: str, want: dict) -> dict:
        """The counts after a main path, which must launch ``want``'s
        kernels that many times and no other kernel."""
        got = {name: getattr(mod, attr) for name, mod, attr in counters}
        print(f"launches in {path}: {got}")
        for name in got:
            check(got[name] == want.get(name, 0),
                  f"{path}: {name} launched {got[name]} times, expected "
                  f"{want.get(name, 0)}")
            path_launches[name] += got[name]
        return got

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

    # 2. build every kernel from the checkout's sources (one nvcc call over
    # csrc/*.cu: signal_features.cu holds K1-K4, anatomy.cu K5a-h)
    built = _build.load(str(_build.CSRC))
    how = "ran" if built.build_seconds else "reused an earlier build"
    print(f"build: {built.path.name} in {built.build_seconds:.2f} s "
          f"(nvcc {how})")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line \
                or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    for cfg in (WHISPER80, MFCC13_HTK):
        smem, blocks = signal.resources(cfg)
        print(f"  signal kernel for {cfg.n_mels}-mel: {smem} B dynamic "
              f"shared memory per block, {blocks} blocks per SM")
    for name, cfg in (("mfcc13", MFCC13_HTK), ("fbank80", FBANK80),
                      ("whisper80", WHISPER80)):
        for kernel, query in (("K3", staged.dft_resources),
                              ("K4", staged.tail_resources)):
            smem, blocks = query(cfg)
            print(f"  {kernel} for {name}: {smem} B dynamic shared memory "
                  f"per block, {blocks} blocks per SM")
            check(blocks >= 1, f"{kernel} for {name} fits no block on an SM")
    for dft, mel in (("bf16x3", "bf16x3"), ("f32", "f32"), ("bf16x3", "f32"),
                     ("f32", "bf16x3")):
        smem, blocks = anatomy.resources(dft, mel)
        print(f"  anatomy kernel, {dft} DFT and {mel} mel: {smem} B dynamic "
              f"shared memory per block, {blocks} blocks per SM")
        check(blocks >= 1, f"anatomy {dft}/{mel} fits no block on an SM")

    # 3. signal kernel vs plain twin, both on the card
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
    reset_counts()
    mel = extract(sig, lengths, cfg_mel, device="cuda")
    mfcc = extract(sig, lengths, cfg_mfcc, device="cuda")
    torch.cuda.synchronize()
    launches = read_counts("the dual extract", {"signal_features": 2})
    print(f"main path: whisper80 {tuple(mel.features.shape)} mfcc13 "
          f"{tuple(mfcc.features.shape)}; signal kernel launches "
          f"{launches['signal_features']}")
    goldens = {}                        # (base config name, row) -> golden
    for res, cfg, base in ((mel, cfg_mel, WHISPER80),
                           (mfcc, cfg_mfcc, MFCC13_HTK)):
        check(res.features.shape == (BATCH, cfg.num_frames(n),
                                     cfg.feature_dim), "main-path shape")
        check(bool(torch.isfinite(res.features).all()), "main path finite")
        gold = cpu.extract(sig[0].astype(np.float64), base)
        goldens[base.n_mels, 0] = gold
        err, rel = scaled_err(res.features[0].cpu(), torch.from_numpy(gold))
        print(f"main path row 0 vs float64 golden, {base.n_mels}-mel: "
              f"max_abs_err={err:.3e} scaled={rel:.3e}")
        check(rel <= TOL_GOLDEN, f"row 0 vs golden {rel:.3e}")

    ragged = np.array([n, 400_123, 250_000, 160_000, 96_001, 16_000, 3_201,
                       350])
    xr = np.zeros((len(ragged), n), np.float32)
    for i, L in enumerate(ragged):
        xr[i, :L] = sig[i, :L]
    ragged_gold = {}

    def check_ragged(res, base, what: str) -> None:
        feats, mask = res.features.cpu(), res.mask.cpu()
        worst = 0.0
        for i, L in enumerate(ragged):
            key = (base.n_mels, i)
            if key not in ragged_gold:
                ragged_gold[key] = cpu.extract(xr[i, :L].astype(np.float64),
                                               base)
            gold = ragged_gold[key]
            nf = int(res.num_frames[i])
            check(nf == gold.shape[0], f"{what} row {i}: {nf} frames, "
                  f"golden {gold.shape[0]}")
            check(int(mask[i].sum()) == nf and bool(mask[i, :nf].all()),
                  f"{what} row {i} mask")
            if nf:
                worst = max(worst, scaled_err(feats[i, :nf],
                                              torch.from_numpy(gold))[1])
        print(f"ragged B={len(ragged)} {what}: frame counts and masks match "
              f"the golden; worst scaled err {worst:.3e}")
        check(worst <= TOL_GOLDEN, f"{what} ragged vs golden {worst:.3e}")

    for cfg, base in ((cfg_mel, WHISPER80), (cfg_mfcc, MFCC13_HTK)):
        check_ragged(extract(xr, ragged, cfg, device="cuda"), base,
                     f"{base.n_mels}-mel")

    # 5. timing on the card: the dual call, kernel path and twin path in turns
    x = torch.from_numpy(sig).cuda()
    lx = torch.from_numpy(lengths).cuda()

    def dual():
        return (extract(x, lx, cfg_mel).features,
                extract(x, lx, cfg_mfcc).features)

    def twin_dual():
        with twin_of(signal, "signal_features"):
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
    ms, times, peak = time_paths(paths, REPS)
    audio = BATCH * SECONDS
    for name in paths:
        print(f"{name:12s}: median {ms[name]:.3f} ms per batch of "
              f"{BATCH} x {SECONDS} s (RTFx {audio / (ms[name] / 1e3):.0f}), "
              f"runs {['%.3f' % t for t in times[name]]}, "
              f"peak memory {peak[name] / 2**20:.0f} MiB [{card}]")
    k1_flops, k1_bytes = 0, 0
    for buf, frames, cfg in bufs:
        cs, fb, dct = signal._device_constants(cfg, buf.device)
        rows = buf.shape[0] * frames
        k1_flops += 2 * rows * cfg.frame_length * cs.shape[1] + tail_flops(
            rows, fb.shape[0], fb, dct)
        k1_bytes += nbytes(buf, cs, fb, dct) + 4 * rows * cfg.feature_dim
    del bufs
    kernel_rows = {"signal_features": dict(
        source="tpufeat_torch/csrc/signal_features.cu",
        replaces="tpufeat/pallas/fused.py:669", max_abs_err=main_err,
        ms=ms["kernel_only"], plain_ms=ms["twin_only"],
        bound=bound({"f32": k1_flops}, k1_bytes))}

    # 6. the staged kernels (K3, K4) vs their twins, both on the card
    staged_variants = {
        "mfcc13": MFCC13_HTK,
        "fbank80": FBANK80,
        "whisper80_log10_out": WHISPER80,
        "mfcc13_magnitude": dataclasses.replace(MFCC13_HTK,
                                                spectrum="magnitude"),
        "mfcc13_lifter22": dataclasses.replace(MFCC13_HTK, lifter=22),
        "mfcc13_kaldi_dc": dataclasses.replace(
            MFCC13_HTK, kaldi_mode=True, dc_offset=True, window="povey"),
    }
    gen = torch.Generator(device="cuda").manual_seed(1)

    def spectrum_rows(frames, cfg):
        """Power (or magnitude) spectra of windowed frames: cuFFT."""
        w = torch.as_tensor(matrices.window(cfg.window, cfg.frame_length),
                            dtype=torch.float32, device="cuda")
        return spectrum.power_spectrum_rfft(frames * w, cfg)

    worst = {"dft_mel_log_dct": 0.0, "mel_log_dct": 0.0}
    for name, cfg in staged_variants.items():
        for rows in ROWS:
            frames = torch.randn(rows, cfg.frame_length, generator=gen,
                                 device="cuda") * 0.1
            for kernel, inp in (("dft_mel_log_dct", frames),
                                ("mel_log_dct", spectrum_rows(frames, cfg))):
                got = getattr(staged, kernel)(inp, cfg)
                torch.cuda.synchronize()
                want = getattr(staged, f"{kernel}_reference")(inp, cfg)
                torch.cuda.synchronize()
                check(got.shape == want.shape, f"{kernel} {name} shape")
                check(bool(torch.isfinite(got).all()),
                      f"{kernel} {name} R={rows} not finite")
                err, rel = scaled_err(got, want)
                worst[kernel] = max(worst[kernel], rel)
                print(f"{kernel:15s} vs twin {name:19s} R={rows:5d}: "
                      f"max_abs_err={err:.3e} scaled={rel:.3e}")
                check(rel <= TOL_KERNEL, f"{kernel} {name} R={rows}: "
                      f"{rel:.3e} > {TOL_KERNEL}")
    print(f"K3/K4 vs twin: every case within {TOL_KERNEL} (worst scaled "
          f"K3 {worst['dft_mel_log_dct']:.3e}, K4 {worst['mel_log_dct']:.3e})")

    # 7. staged one-shot extraction of the main batch, MFCC-13: K3, and
    # cuFFT + K4
    routes = {"dft_mel_log_dct": dataclasses.replace(MFCC13_HTK, **STAGED_K3),
              "mel_log_dct": dataclasses.replace(MFCC13_HTK, **STAGED_K4)}
    for kernel, cfg in routes.items():
        reset_counts()
        res = extract(sig, lengths, cfg, device="cuda")
        torch.cuda.synchronize()
        read_counts(f"staged extract via {kernel}", {kernel: 1})
        check(res.features.shape == mfcc.features.shape, "staged shape")
        check(bool(torch.isfinite(res.features).all()), "staged finite")
        err, rel = scaled_err(res.features[0].cpu(),
                              torch.from_numpy(goldens[MFCC13_HTK.n_mels, 0]))
        print(f"staged extract via {kernel}: row 0 vs float64 golden "
              f"max_abs_err={err:.3e} scaled={rel:.3e}")
        check(rel <= TOL_GOLDEN, f"staged {kernel} row 0 vs golden {rel:.3e}")
        err, rel = scaled_err(res.features, mfcc.features)
        print(f"staged extract via {kernel}: B={BATCH} vs the fused route "
              f"max_abs_err={err:.3e} scaled={rel:.3e}")
        check(rel <= TOL_ROUTE, f"staged {kernel} vs fused {rel:.3e}")
        del res
        check_ragged(extract(xr, ragged, cfg, device="cuda"), MFCC13_HTK,
                     f"staged via {kernel}")

    xx = framing.preemphasize(x, MFCC13_HTK.preemphasis)
    frames_main = framing.condition_frames(
        framing.frame_signal(xx, lx, MFCC13_HTK)[0], MFCC13_HTK
    ).reshape(-1, MFCC13_HTK.frame_length).contiguous()
    spec_main = spectrum_rows(frames_main, MFCC13_HTK).contiguous()
    del xx
    inputs = {"dft_mel_log_dct": frames_main, "mel_log_dct": spec_main}
    print(f"staged kernels' main-path inputs: frames "
          f"{tuple(frames_main.shape)}, spectrum {tuple(spec_main.shape)}")
    for kernel, cfg in routes.items():
        got = getattr(staged, kernel)(inputs[kernel], cfg)
        want = getattr(staged, f"{kernel}_reference")(inputs[kernel], cfg)
        torch.cuda.synchronize()
        err, rel = scaled_err(got, want)
        print(f"{kernel} vs twin at the main path's shapes: "
              f"max_abs_err={err:.3e} scaled={rel:.3e}")
        check(rel <= TOL_KERNEL, f"main-path {kernel} vs twin {rel:.3e}")
        rows, width = inputs[kernel].shape
        if kernel == "dft_mel_log_dct":
            cs, fb, dct = staged._dft_constants(cfg, got.device)
            flops = 2 * rows * width * cs.shape[1] + tail_flops(
                rows, fb.shape[0], fb, dct)
        else:
            cs, (fb, dct) = None, staged._tail_constants(cfg, got.device)
            flops = tail_flops(rows, width, fb, dct)
        kernel_rows[kernel] = dict(
            source="tpufeat_torch/csrc/signal_features.cu",
            replaces=("tpufeat/pallas/fused.py:353"
                      if kernel == "dft_mel_log_dct"
                      else "tpufeat/pallas/fused.py:336"),
            max_abs_err=err, bound=bound(
                {"f32": flops},
                nbytes(inputs[kernel], cs, fb, dct, got)))
        del got, want

    def staged_path(kernel, twin):
        cfg = routes[kernel]

        def run():
            with twin_of(staged, kernel) if twin else \
                    contextlib.nullcontext():
                return extract(x, lx, cfg).features
        return run

    paths = {}
    for kernel, short in (("dft_mel_log_dct", "k3"), ("mel_log_dct", "k4")):
        cfg = routes[kernel]
        paths[f"{short}_extract_kernel"] = staged_path(kernel, False)
        paths[f"{short}_extract_twin"] = staged_path(kernel, True)
        paths[f"{short}_only"] = functools.partial(
            getattr(staged, kernel), inputs[kernel], cfg)
        paths[f"{short}_twin_only"] = functools.partial(
            getattr(staged, f"{kernel}_reference"), inputs[kernel], cfg)
    ms, times, peak = time_paths(paths, REPS)
    for name in paths:
        print(f"{name:18s}: median {ms[name]:.3f} ms per batch of "
              f"{BATCH} x {SECONDS} s MFCC-13 "
              f"(RTFx {audio / (ms[name] / 1e3):.0f}), "
              f"runs {['%.3f' % t for t in times[name]]}, "
              f"peak memory {peak[name] / 2**20:.0f} MiB [{card}]")
    for kernel, short in (("dft_mel_log_dct", "k3"), ("mel_log_dct", "k4")):
        kernel_rows[kernel].update(ms=ms[f"{short}_only"],
                                   plain_ms=ms[f"{short}_twin_only"])
    del frames_main, spec_main, inputs

    # 8. streaming at serving size: STREAMS streams of 100 ms chunks
    cfg_s = dataclasses.replace(MFCC13_HTK, **FUSED)   # serving.py:30-34
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = torch.randn(STREAMS, STEPS * CHUNK, generator=gen,
                     device="cuda") * 0.1
    chunks = [xs[:, k * CHUNK:(k + 1) * CHUNK].contiguous()
              for k in range(STEPS)]
    n_frames = cfg_s.num_frames(STEPS * CHUNK)

    def frontend_run(cfg, sizes):
        fe = streaming.StreamingFrontend(cfg, STREAMS, device="cuda")
        outs, pos = [], 0
        for c in sizes:
            feats, mask = fe.process(xs[:, pos: pos + c])
            check(bool(mask.all()), "static step mask")
            outs.append(feats)
            pos += c
        return torch.cat(outs, dim=1)

    def dynamic_run(cfg):
        state = streaming.init_state(STREAMS, cfg, device="cuda")
        outs = []
        for chunk in chunks:
            state, (feats, mask) = streaming.process_chunk(state, chunk, cfg)
            check(bool((mask == mask[:1]).all()), "one schedule, one mask")
            outs.append(feats[:, mask[0]])
        return torch.cat(outs, dim=1)

    def against_twin(name: str, module, kernel: str, run, out) -> None:
        """Run the streaming path ``run`` again with ``kernel`` replaced by
        its plain twin (so at the shapes streaming gives the kernel), check
        that no kernel launched, and hold the kernel path's ``out`` against
        it on every stream."""
        reset_counts()
        with twin_of(module, kernel):
            want = run()
        torch.cuda.synchronize()
        check(all(getattr(mod, attr) == 0 for _, mod, attr in counters),
              f"streaming {name}: the twin run launched a kernel")
        err, rel = scaled_err(out, want)
        print(f"streaming {name}: {kernel} vs its twin on all {STREAMS} "
              f"streams: max_abs_err={err:.3e} scaled={rel:.3e}")
        check(rel <= TOL_KERNEL, f"streaming {name} kernel vs twin "
              f"{rel:.3e} > {TOL_KERNEL}")
        row = kernel_rows[kernel]
        row["max_abs_err"] = max(row["max_abs_err"], err)

    fused_run = functools.partial(frontend_run, cfg_s, [CHUNK] * STEPS)
    reset_counts()
    out = fused_run()
    torch.cuda.synchronize()
    read_counts("StreamingFrontend.process (fused static step)",
                {"signal_features": STEPS})
    against_twin("static_fused", signal, "signal_features", fused_run, out)
    check(out.shape == (STREAMS, n_frames, cfg_s.feature_dim),
          f"streaming shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "streaming finite")
    scan = streaming.extract_scan(xs, cfg_s, CHUNK)
    check(torch.equal(scan, out), "streaming != extract_scan(..., 1600)")
    other = frontend_run(cfg_s, [3 * CHUNK] * (STEPS // 3))
    check(torch.equal(other, out), "plan [4800] * 10 != plan [1600] * 30")
    print(f"streaming S={STREAMS} x {STEPS} steps of {CHUNK}: "
          f"{tuple(out.shape)} bit-identical to extract_scan(..., {CHUNK}) "
          f"and to the plan [{3 * CHUNK}] * {STEPS // 3}")
    del scan, other
    one = extract(xs, cfg=cfg_s).features
    err, rel = scaled_err(out, one)
    print(f"streaming vs one-shot extract: max_abs_err={err:.3e} "
          f"scaled={rel:.3e}")
    check(rel <= TOL_STREAM, f"streaming vs one-shot {rel:.3e}")
    del one
    xs_host = xs[:4].cpu().numpy()
    for i in range(4):
        gold = cpu.extract(xs_host[i].astype(np.float64), MFCC13_HTK)
        err, rel = scaled_err(out[i].cpu(), torch.from_numpy(gold))
        print(f"streaming row {i} vs float64 golden: max_abs_err={err:.3e} "
              f"scaled={rel:.3e}")
        check(rel <= TOL_GOLDEN, f"streaming row {i} vs golden {rel:.3e}")
    del out

    stream_cfgs = {
        "dynamic_k3": (dataclasses.replace(MFCC13_HTK, **STAGED_K3), True,
                       "dft_mel_log_dct"),
        "dynamic_k4": (dataclasses.replace(MFCC13_HTK, **STAGED_K4), True,
                       "mel_log_dct"),
        "static_energy": (dataclasses.replace(cfg_s, use_energy=True), False,
                          "dft_mel_log_dct"),
    }
    for name, (cfg, dynamic, kernel) in stream_cfgs.items():
        run = functools.partial(dynamic_run, cfg) if dynamic else \
            functools.partial(frontend_run, cfg, [CHUNK] * STEPS)
        reset_counts()
        out = run()
        torch.cuda.synchronize()
        read_counts(f"streaming {name}", {kernel: STEPS})
        against_twin(name, staged, kernel, run, out)
        check(out.shape == (STREAMS, n_frames, cfg.feature_dim),
              f"{name} shape {tuple(out.shape)}")
        one = extract(xs, cfg=cfg).features
        err, rel = scaled_err(out, one)
        print(f"streaming {name} vs its one-shot extract: max_abs_err="
              f"{err:.3e} scaled={rel:.3e}")
        check(rel <= TOL_STREAM, f"streaming {name} vs one-shot {rel:.3e}")
        del out, one

    def stepper(cfg, dynamic: bool, kernel: str, twin: bool):
        """One steady-state step of a streaming path per call."""
        module = signal if kernel == "signal_features" else staged
        fe = streaming.StreamingFrontend(cfg, STREAMS, device="cuda")
        state = streaming.init_state(STREAMS, cfg, device="cuda")
        feed = itertools.cycle(chunks)

        def step():
            nonlocal state
            with twin_of(module, kernel) if twin else \
                    contextlib.nullcontext():
                if not dynamic:
                    return fe.process(next(feed))[0]
                state, (feats, _) = streaming.process_chunk(
                    state, next(feed), cfg)
                return feats
        step()                          # the first step: fill 0 -> steady
        return step

    paths = {}
    for name, (cfg, dynamic, kernel) in {
            "static_fused": (cfg_s, False, "signal_features"),
            **stream_cfgs}.items():
        paths[f"{name}_kernel"] = stepper(cfg, dynamic, kernel, False)
        paths[f"{name}_twin"] = stepper(cfg, dynamic, kernel, True)
    ms, times, peak = time_paths(paths, STEP_REPS)
    budget_ms = 1e3 * CHUNK / SR
    for name in paths:
        print(f"step {name:20s}: median {ms[name]:.3f} ms per step of "
              f"{STREAMS} streams x {CHUNK} samples, "
              f"{100 * ms[name] / budget_ms:.2f} % of the {budget_ms:.0f} ms "
              f"real-time budget, runs {['%.3f' % t for t in times[name]]}, "
              f"peak memory {peak[name] / 2**20:.0f} MiB [{card}]")
    del paths, xs, chunks

    # 9. the anatomy family (K5a-h): each runner's every mode at its
    # script's shape through anatomy_features, then each mode against its
    # plain twin, both timed in turns, beside its bound. The tolerances are
    # tpufeat_torch.experiments._common's (the CPU and card tests use the
    # same ones)
    from tpufeat_torch.experiments import _common, phase_anatomy
    twin = anatomy.anatomy_features_reference
    for runner in RUNNERS:
        mod = importlib.import_module(f"tpufeat_torch.experiments.{runner}")
        inp = mod.inputs("cuda")
        reset_counts()
        outs = {mode: _common.call(inp, spec)()
                for mode, spec in mod.MODES.items()}
        torch.cuda.synchronize()
        read_counts(f"{runner}, every mode", {"anatomy_features":
                                              len(mod.MODES)})
        for mode, spec in mod.MODES.items():
            dft, mel, tail = spec
            got = outs.pop(mode)
            want = _common.call(inp, spec, twin)()
            torch.cuda.synchronize()
            B, R, _ = inp.main.shape
            check(got.shape == (B, R * len(inp.consts.table), _common.NM),
                  f"{runner} {mode} shape {tuple(got.shape)}")
            flip = _common.flip_tolerance(inp, dft, want, tail) \
                if _common.lossy(mel, tail) else None
            m = None if flip or tail in ("nolog", "dftonly") else twin(
                inp.main, inp.bnd, inp.consts, dft, mel, "nolog")
            err, checked, masked = _common.compare(
                got, want, tail, m, flip, f"anatomy {runner} {mode}")
            del got, want, m
            ms, _, _ = time_paths({"kernel": _common.call(inp, spec),
                                   "plain": _common.call(inp, spec, twin)},
                                  REPS)
            flops, moved = anatomy.work(inp.main, inp.bnd, inp.consts, dft,
                                        mel, tail)
            b_ms, b_by = bound(flops, moved)
            same = f" (the function of {mod.SAME[mode]})" \
                if mode in mod.SAME else ""
            print(f"anatomy {runner} {mode}{same}: {dft} DFT, "
                  f"{mel or 'no'} mel, {tail}; kernel {ms['kernel']:.3f} ms, "
                  f"plain {ms['plain']:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by}, {100 * b_ms / ms['kernel']:.1f} % of it); "
                  f"max_abs_err={err:.3e} checked={checked:.3e}"
                  f"{'' if flip is None else f' (one-flip bound {flip:.3e})'}"
                  f" masked={masked} [{card}]", flush=True)
            if (runner, mode) == ("phase_anatomy", "full"):
                kernel_rows["anatomy_features"] = dict(
                    source="tpufeat_torch/csrc/anatomy.cu",
                    replaces=", ".join(
                        f"benchmarks/experiments/{site}" for site in (
                            "nopad_kernel.py:52", "repack_kernel.py:57",
                            "phase_kernel.py:85", "phase_anatomy.py:84",
                            "phase_anatomy2.py:75", "phase_anatomy3.py:83",
                            "phase_anatomy4.py:82", "phase_anatomy5.py:156")),
                    max_abs_err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                    bound=(b_ms, b_by))
        del inp, outs

    # the pass counts at the scripts' shape, where no z*z can round apart
    # in the kernel and the twin, held to the pre-log tolerance: dftonly at
    # every DFT precision, and every mel precision behind an identity DFT
    # at f32 (z is then the signal, exactly)
    inp = phase_anatomy.inputs("cuda")
    eye = anatomy.constants_from_numpy(
        [[(0, 0, np.eye(_common.NCS, dtype=np.float32))]],
        (inp.consts.fb_hi, inp.consts.fb_lo, inp.consts.fb_f32), "cuda")
    for prec in anatomy.PRECISIONS:
        for what, consts, dft, mel, tail in (
                ("dftonly", inp.consts, prec, None, "dftonly"),
                ("identity DFT, mel", eye, "f32", prec, "nolog")):
            got = anatomy.anatomy_features(inp.main, inp.bnd, consts, dft,
                                           mel, tail)
            want = twin(inp.main, inp.bnd, consts, dft, mel, tail)
            torch.cuda.synchronize()
            err, checked, _ = _common.compare(
                got, want, tail, what=f"anatomy passes, {what} at {prec}")
            print(f"anatomy passes, {what} at {prec}, main "
                  f"{tuple(inp.main.shape)}: max_abs_err={err:.3e} "
                  f"scaled={checked:.3e} (limit {_common.TOL_PRE}) [{card}]")
            del got, want
    del inp, eye

    for name, count in path_launches.items():
        check(count > 0, f"{name} was launched no time in the main paths")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": kernel_rows[name]["source"],
         "replaces": kernel_rows[name]["replaces"],
         "launches": path_launches[name],
         "max_abs_err": kernel_rows[name]["max_abs_err"],
         "ms": kernel_rows[name]["ms"],
         "plain_ms": kernel_rows[name]["plain_ms"],
         "bound_ms": kernel_rows[name]["bound"][0],
         "bound_by": kernel_rows[name]["bound"][1],
         # no single PyTorch call computes any of these fused functions
         "library_ms": None}
        for name in path_launches]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
