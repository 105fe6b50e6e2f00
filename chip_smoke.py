"""Smoke run of tpufeat_torch on one NVIDIA GPU — the quickest proof that the
port builds and runs its paths on the card.

    python3 chip_smoke.py

In order: the card and toolchain; the CUDA build of every kernel (one nvcc
per source, all at once, with nvcc's -Xptxas -v resource lines and each
launch's shared memory and blocks per SM); the tensor-core signal kernel
against its plain twin on the card at every matmul_precision (six bf16
passes per product at "highest", three at "bf16x3", one at "default", past
one 128-band mel slab too) over a grid of configs and at the main path's
shapes, with the default check's negative control (the bf16x3 kernel held
as the default one must fail it); the main path — batched Whisper-80 +
MFCC-13 extraction of B=128 x 30 s of 16 kHz audio through
``tpufeat_torch.extract`` with the fused flags at bf16x3, and again at
"highest" (within 1.2e-4 of the float64 golden) — with its launch counts
and its error against the golden, and the timing of that dual call,
kernel path and twin path in turns, beside the kernel at the other
precisions on the same batch; the staged GEMM kernel (K3, the signal
kernel over rows) and the tail kernel (K4) against their twins at every
precision over a grid of configs and row counts and at the main path's
shapes; the staged one-shot extraction of the same batch through K3 and
through cuFFT + K4, checked and timed the same way, the routes compared
at "highest"; and the streaming front-end at serving size (4096 streams
of 100 ms chunks) through ``StreamingFrontend``, ``extract_scan`` and the
dynamic step, checked bit for bit across chunk plans (at bf16x3 and at
"highest"), each path held against the same path with its kernel replaced
by the plain twin on every stream, and timed per step; Kaldi-39
(``KALDI39`` with the fused flags, :func:`kaldi39_phase`): offline
``extract`` of the same batch with ragged lengths at "highest", bf16x3
and with sliding CMVN, against the twin path on every row and the golden,
timed whole and as K1 and the deltas/CMVN tail, then the online
``StreamingPipeline`` with sliding CMVN on the 4096 streams, its base
columns bit for bit against ``extract_scan``, its deltas against the
offline ones, its rows against the offline ``extract``, its step timed;
and the phase-kernel anatomy family (K5a-h): every mode of the eight runners of
``tpufeat_torch.experiments`` at its script's own shape through
``anatomy_features``, each held against its plain twin and both timed, with
the mode's bound, ``full`` and ``allhighest`` launched twice for the same
bits, then every precision's pass count at the scripts' shape (the
``dftonly`` tail, and the mel product behind an identity DFT).

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
TOL_KERNEL = 1e-4   # K4 vs twin in the streaming run at bf16x3, where its
#                     spectrum rows are not at hand, relative to max(1,
#                     |twin|.max()): the same split products, sums in
#                     another order. Everywhere else K1, K3 and K4 are held
#                     by tolerance.compare_to_twin: the same 1e-4 plus the
#                     bound of the f32 sum order (large only over
#                     near-silent bins) and, at "default", of one bf16 flip
#                     per rounding, with at most tolerance.FLIP_FRAMES
#                     frames past 1e-4 in a window of the tile's frames
TOL_GOLDEN = 1e-3   # features vs the float64 golden, same scaling: the
#                     repo's fidelity budget
TOL_HIGHEST = 1.2e-4  # the same at "highest", its contract
TOL_ROUTE = 1e-4    # one-shot staged routes vs the fused route at
#                     "highest" (six passes in each), same scaling
TOL_STREAM = 1e-5   # streaming vs its one-shot counterpart, same scaling
REPS = 11           # timed runs per path (median)
LAUNCHES = 10       # calls per timed run of a kernel or a twin alone: its
#                     time is their mean, so the host's time between two
#                     launches does not count as the card's
STREAM_BLOCK = 256  # streams per block of a streaming comparison
FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True,
             matmul_precision="bf16x3")
STAGED_K3 = dict(use_pallas=True, gemm_dft=True, matmul_precision="bf16x3")
STAGED_K4 = dict(use_pallas=True, matmul_precision="bf16x3")
HIGHEST = dict(matmul_precision="highest")
PRECISIONS = ("highest", "bf16x3", "default")
ROWS = (1, 31, 32, 33, 63, 64, 65, 511, 512, 513, 40960)  # K3/K4 row counts
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


def repeated(fn, n: int):
    """fn, n times over, keeping none of its results."""
    def run():
        for _ in range(n):
            fn()
    return run


def time_paths(paths: dict, reps: int) -> tuple[dict, dict, dict]:
    """Warm each path once (recording its peak memory), then time ``reps``
    runs of every path in turns, the order reversed every other round; a
    path whose name ends in ``_only`` (a kernel or a twin alone) runs
    LAUNCHES calls per timed run, and its time is their mean. Returns
    (median ms, every run's ms, peak bytes) per path."""
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
            n = LAUNCHES if name.endswith("_only") else 1
            times[name].append(cuda_ms(repeated(paths[name], n)) / n)
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


def signal_work(rows: int, cfg, fold_kaldi: bool = True) -> tuple:
    """(FLOPs by type, constant tensors) of the signal kernel over ``rows``
    frames at ``cfg``'s precision: its passes of the DFT and mel products on
    the bf16 tensor cores and of the DCT's FFMA on the pieces; the
    constants are the pieces it reads."""
    from tpufeat_torch.kernels import signal
    cs, fb, dct = (signal.put(a, "cuda") for a in (
        signal.cs_constant(cfg, fold_kaldi), signal.fb_constant(cfg),
        signal.dct_constant(cfg)))
    gemm = 2 * rows * cfg.frame_length * cs.shape[1] + tail_flops(
        rows, fb.shape[0], fb, None)
    tail = tail_flops(rows, 0, fb, dct)
    n = signal.passes(cfg)
    return ({"bf16": n * gemm, "f32": n * tail},
            tuple(t for pieces in signal.mma_constants(cfg, fold_kaldi)
                  if pieces is not None for t in pieces))


def tail_work(rows: int, cfg) -> tuple:
    """(FLOPs by type, constant tensors) of K4 over ``rows`` spectra at
    ``cfg``'s precision: its passes of the mel product and the DCT on the
    tensor cores; the constants are fb's and the DCT's packed pieces."""
    from tpufeat_torch.kernels import signal, staged
    fb, dct = (signal.put(a, "cuda") for a in (
        staged.tail_fb_constant(cfg), signal.dct_constant(cfg)))
    n = signal.passes(cfg)
    return ({"bf16": n * tail_flops(rows, fb.shape[0], fb, dct)},
            staged.tail_mma_constants(cfg))


def twin_of(module, name: str):
    """A context in which ``module.name`` (a kernel wrapper) is its plain
    twin ``module.name_reference``: the twin path of a timing."""
    return mock.patch.object(module, name, getattr(module, f"{name}_reference"))


def kaldi39_phase(sig: np.ndarray, streams: int, steps: int,
                  reset_counts, read_counts, card: str,
                  device: str = "cuda") -> dict:
    """Kaldi-39 (``BASELINE.json`` config 3) through the public entry
    points: offline ``extract`` of ``KALDI39`` with the fused flags on the
    batch ``sig`` with ragged lengths, at "highest" and bf16x3 and with
    sliding CMVN, each held against the same call with K1 replaced by its
    twin on every row and row 0 against the float64 golden, and timed
    whole and split into K1 and the deltas/CMVN tail; then the online
    ``StreamingPipeline`` with sliding CMVN on ``streams`` streams of
    ``steps`` 100 ms chunks, its base columns bit for bit against
    ``extract_scan``, its delta columns against the offline deltas, its
    rows against the offline ``extract``, and its step timed. Returns the
    largest kernel-vs-twin error of the signal kernel's outputs per row of
    the kernels line."""
    from tpufeat_torch import KALDI39, StreamingPipeline, extract, features
    from tpufeat_torch import framing, streaming
    from tpufeat_torch.kernels import signal
    from tpufeat_torch.kernels import _tolerance as tolerance
    from tpufeat_torch.reference import cpu

    B, n = sig.shape
    rng = np.random.default_rng(39)
    lengths = np.concatenate([[n], rng.integers(n // 100, n, B - 1)])
    x = torch.from_numpy(sig).to(device)
    lx = torch.from_numpy(lengths).to(device)
    errs = {"signal_mma": 0.0, "signal_mma_highest": 0.0}
    sliding = dict(cmvn="sliding")
    fused = dataclasses.replace(KALDI39, **FUSED)
    cfgs = {"highest": dataclasses.replace(fused, **HIGHEST),
            "bf16x3": fused,
            "sliding_highest": dataclasses.replace(fused, **HIGHEST,
                                                   **sliding)}
    gold = {}
    paths = {}
    for name, cfg in cfgs.items():
        hi = cfg.matmul_precision == "highest"
        reset_counts()
        res = extract(x, lx, cfg)
        torch.cuda.synchronize()
        read_counts(f"kaldi39 extract ({name})", {"signal_features_mma": 1},
                    highest=hi)
        feats, nf = res.features, res.num_frames.cpu()
        check(feats.shape == (B, cfg.num_frames(n), 39), f"kaldi39 {name} "
              f"shape {tuple(feats.shape)}")
        check(torch.equal(nf, framing.num_frames_dynamic(
            torch.from_numpy(lengths), cfg).to(torch.int32)),
            f"kaldi39 {name} frame counts")
        valid = res.mask
        check(bool(torch.isfinite(feats[valid]).all()),
              f"kaldi39 {name} finite")
        # the same call with K1's twin: every row, valid frames
        with twin_of(signal, "signal_features"):
            want = extract(x, lx, cfg).features
        torch.cuda.synchronize()
        err, rel = scaled_err(feats[valid], want[valid])
        print(f"kaldi39 {name}: B={B} ragged ({int(nf.sum())} frames), "
              f"kernel path vs twin path on every row: max_abs_err="
              f"{err:.3e} scaled={rel:.3e} (limit {TOL_GOLDEN})")
        check(rel <= TOL_GOLDEN, f"kaldi39 {name} kernel vs twin {rel:.3e}")
        # K1's own output at these shapes, held as every K1 launch is
        xx = framing.preemphasize(x, cfg.preemphasis)
        buf = framing.framing_buffer(xx, lx, cfg)[0].contiguous()
        F = cfg.num_frames(n)
        a = tolerance.compare_to_twin(
            signal.signal_features(buf, F, cfg),
            signal.signal_features_reference(buf, F, cfg),
            framing.frames_from_buffer(buf, F, cfg.frame_length,
                                       cfg.hop_length),
            cfg, what=f"kaldi39 K1 ({name})")
        row = "signal_mma_highest" if hi else "signal_mma"
        errs[row] = max(errs[row], a.max_abs_err)
        print(f"kaldi39 {name}: K1 vs twin at these shapes max_abs_err="
              f"{a.max_abs_err:.3e} scaled={a.scaled:.3e}")
        key = (cfg.cmvn, 0)
        if key not in gold:
            gold[key] = cpu.extract(sig[0].astype(np.float64), cfg)
        err, rel = scaled_err(feats[0].cpu(), torch.from_numpy(gold[key]))
        limit = TOL_GOLDEN if hi else None
        print(f"kaldi39 {name}: row 0 vs float64 golden max_abs_err="
              f"{err:.3e} scaled={rel:.3e}"
              f"{f' (limit {limit})' if limit else ' (no limit: bf16x3)'}")
        if limit:
            check(rel <= limit, f"kaldi39 {name} row 0 vs golden {rel:.3e}")
        del res, want, feats, valid
        feat, mask = features.features_impl(x, lx, cfg)
        paths[f"{name}_extract"] = functools.partial(extract, x, lx, cfg)
        paths[f"{name}_k1_only"] = functools.partial(
            signal.signal_features, buf, F, cfg)
        paths[f"{name}_tail_only"] = functools.partial(
            features.finish_impl, feat, mask, lx, cfg)
    ms, times, peak = time_paths(paths, REPS)
    audio = B * n / SR
    for name in cfgs:
        whole, k1, tail = (ms[f"{name}_{p}"] for p in
                           ("extract", "k1_only", "tail_only"))
        print(f"kaldi39 {name}: extract {whole:.3f} ms per batch of {B} x "
              f"{n / SR:.0f} s (RTFx {audio / (whole / 1e3):.0f}), K1 "
              f"{k1:.3f} ms, deltas/CMVN tail {tail:.3f} ms, the rest "
              f"{whole - k1 - tail:.3f} ms; runs "
              f"{['%.3f' % t for t in times[f'{name}_extract']]}, peak "
              f"memory {peak[f'{name}_extract'] / 2**20:.0f} MiB [{card}]")
    del paths, x, lx

    # online: StreamingPipeline(KALDI39 with sliding CMVN) at serving size
    cfg = cfgs["sliding_highest"]
    base_cfg = dataclasses.replace(cfg, deltas=False, cmvn="none")
    gen = torch.Generator(device=device).manual_seed(39)
    xs = torch.randn(streams, steps * CHUNK, generator=gen,
                     device=device) * 0.1
    pipe = StreamingPipeline(cfg, streams, device=device)
    base, pre = [], []
    process, scmvn = pipe.frontend.process, pipe._scmvn.process
    # record what the front-end emits and what reaches the sliding CMVN
    pipe.frontend.process = lambda c: base.append(process(c)[0]) or \
        (base[-1], None)
    pipe._scmvn.process = lambda r: pre.append(r) or scmvn(r)
    reset_counts()
    outs = [pipe.process(xs[:, k * CHUNK:(k + 1) * CHUNK])
            for k in range(steps)]
    torch.cuda.synchronize()
    read_counts("kaldi39 StreamingPipeline.process (sliding CMVN)",
                {"signal_features_mma": steps}, highest=True)
    outs.append(pipe.flush())
    out = torch.cat(outs, dim=1)
    base, pre = torch.cat(base, dim=1), torch.cat(pre, dim=1)
    F = cfg.num_frames(steps * CHUNK)
    check(out.shape == (streams, F, 39), f"pipeline shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "pipeline finite")
    scan = streaming.extract_scan(xs, base_cfg, CHUNK)
    check(torch.equal(base, scan), "pipeline base columns != extract_scan")
    nf = torch.full((streams,), F, device=device)
    d1 = features.deltas(scan, nf)
    offline = torch.cat([scan, d1, features.deltas(d1, nf)], dim=-1)
    check(torch.equal(pre[..., :13], scan), "pipeline rows' base columns")
    gap = (pre - offline).abs().max().item()
    err, rel = scaled_err(pre, offline)
    print(f"kaldi39 StreamingPipeline S={streams} x {steps} steps of "
          f"{CHUNK}: base columns bit-identical to extract_scan(..., "
          f"{CHUNK}); delta columns vs offline deltas of those rows: "
          f"largest gap {gap:.3e} (scaled {rel:.3e}, limit {TOL_STREAM})")
    check(rel <= TOL_STREAM, f"pipeline deltas vs offline {rel:.3e}")
    one = extract(xs, cfg=cfg).features
    err, rel = scaled_err(out, one)
    print(f"kaldi39 StreamingPipeline vs offline extract of the same config "
          f"(cmvn_min_window {cfg.cmvn_min_window} rows of delay, all "
          f"{F} rows after flush): max_abs_err={err:.3e} scaled={rel:.3e} "
          f"(limit {TOL_KERNEL})")
    check(rel <= TOL_KERNEL, f"pipeline vs offline extract {rel:.3e}")
    del outs, out, base, pre, scan, d1, offline, one, pipe

    # the steady step: a pipeline past its min_window start-up
    pipe = StreamingPipeline(cfg, streams, device=device)
    chunks = [xs[:, k * CHUNK:(k + 1) * CHUNK].contiguous()
              for k in range(steps)]
    warm = -(-(cfg.cmvn_min_window + 2 * cfg.delta_order
               * cfg.delta_window) * cfg.hop_length // CHUNK) + 1
    for chunk in chunks[:warm]:
        pipe.process(chunk)
    feed = itertools.cycle(chunks[warm:])
    check(pipe.process(next(feed)).shape[1] > 0, "pipeline emits in steady "
          "state")
    ms, times, peak = time_paths(
        {"step": lambda: pipe.process(next(feed))}, STEP_REPS)
    budget_ms = 1e3 * CHUNK / SR
    print(f"kaldi39 StreamingPipeline step (sliding CMVN, window "
          f"{cfg.cmvn_window}): median {ms['step']:.3f} ms per step of "
          f"{streams} streams x {CHUNK} samples, "
          f"{100 * ms['step'] / budget_ms:.2f} % of the {budget_ms:.0f} ms "
          f"real-time budget, runs {['%.3f' % t for t in times['step']]}, "
          f"peak memory {peak['step'] / 2**20:.0f} MiB [{card}]")
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from tpufeat_torch import FBANK80, WHISPER80, WHISPER128, MFCC13_HTK
    from tpufeat_torch import FeatureConfig, extract
    from tpufeat_torch import framing, matrices, spectrum, streaming
    from tpufeat_torch.experiments import RUNNERS
    from tpufeat_torch.kernels import _build, anatomy, signal, staged
    from tpufeat_torch.kernels import _tolerance as tolerance
    from tpufeat_torch.reference import cpu

    counters = (("signal_features_mma", signal, "mma_launches"),
                ("dft_mel_log_dct_mma", staged,
                 "dft_mel_log_dct_mma_launches"),
                ("mel_log_dct", staged, "mel_log_dct_launches"),
                ("anatomy_features", anatomy, "launches"))
    path_launches = {name: 0 for name, _, _ in counters}
    # the kernels line's rows: the signal kernel's launches (K1 and K3) at
    # "highest" apart, its six-pass variant having its own bound
    row_of = {"signal_features_mma": "signal_mma",
              "dft_mel_log_dct_mma": "signal_mma",
              "mel_log_dct": "mel_log_dct",
              "anatomy_features": "anatomy_features"}
    row_launches = {"signal_mma": 0, "signal_mma_highest": 0,
                    "mel_log_dct": 0, "anatomy_features": 0}

    def reset_counts() -> None:
        for _, mod, attr in counters:
            setattr(mod, attr, 0)

    def read_counts(path: str, want: dict, highest: bool = False) -> dict:
        """The counts after a main path, which must launch ``want``'s
        kernels that many times and no other kernel; ``highest``: the path
        runs at "highest"."""
        got = {name: getattr(mod, attr) for name, mod, attr in counters}
        print(f"launches in {path}: {got}")
        for name in got:
            check(got[name] == want.get(name, 0),
                  f"{path}: {name} launched {got[name]} times, expected "
                  f"{want.get(name, 0)}")
            path_launches[name] += got[name]
            row = row_of[name]
            if highest and row == "signal_mma":
                row = "signal_mma_highest"
            row_launches[row] += got[name]
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

    # 2. build every kernel from the checkout's sources (one nvcc per
    # csrc/*.cu, all at once: signal_mma.cu holds K1/K3 and K4, anatomy.cu
    # K5a-h)
    built = _build.load(str(_build.CSRC))
    how = "ran" if built.build_seconds else "reused an earlier build"
    print(f"build: {built.path.name} in {built.build_seconds:.2f} s "
          f"(nvcc {how})")
    for line in built.log.splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or "Compiling entry" in line or ": nvcc " in line) \
                and "(C7519)" not in line:   # wgmma's injected arrives
            print("  ptxas:", line.strip())
    for n_mels in (26, 40, 80, 128):
        for prec in PRECISIONS:
            smem, blocks = signal.mma_resources(dataclasses.replace(
                MFCC13_HTK, n_mels=n_mels, matmul_precision=prec))
            print(f"  tensor-core signal kernel (K1 and K3) for "
                  f"{n_mels}-mel at {prec}: {smem} B dynamic shared "
                  f"memory per block, {blocks} blocks per SM")
            check(blocks >= 1, f"tensor-core kernel at {prec} fits no "
                  f"block on an SM")
    for name, cfg in (("mfcc13", MFCC13_HTK), ("fbank80", FBANK80),
                      ("whisper80", WHISPER80)):
        for prec in PRECISIONS:
            smem, blocks, rows, slots, staged_consts = staged.tail_resources(
                dataclasses.replace(cfg, matmul_precision=prec))
            print(f"  K4 for {name} at {prec}: {smem} B dynamic shared "
                  f"memory per block, {blocks} blocks per SM, tiles of "
                  f"{rows} rows, {slots} in the ring, fragments "
                  f"{'staged' if staged_consts else 'read in place'}")
            check(blocks >= 1, f"K4 for {name} fits no block on an SM")
    for dft, mel in (("bf16x1", "bf16x1"), ("bf16x3", "bf16x3"),
                     ("bf16x6", "bf16x6"), ("bf16x3", None)):
        smem, blocks, regs, spill = anatomy.resources(dft, mel)
        print(f"  anatomy kernel, {dft} DFT and {mel or 'no'} mel: {smem} B "
              f"dynamic shared memory per block, {blocks} blocks per SM, "
              f"{regs} registers a thread at launch, {spill} B of local "
              f"memory (spills) a thread")
        check(blocks >= 1, f"anatomy {dft}/{mel} fits no block on an SM")

    # 3. the signal kernel vs its plain twin, both on the card, at every
    # precision: the configs and frame counts of
    # tests/test_torch_cuda_signal.py, around the kernel's tile and half
    tm = signal.MMA_TILE_FRAMES
    tf = tm // 2
    variants = {
        "whisper80": WHISPER80,
        "whisper128": WHISPER128,
        "mfcc13": MFCC13_HTK,
        "mfcc13_kaldi_dc": dataclasses.replace(
            MFCC13_HTK, kaldi_mode=True, dc_offset=True),
        "mfcc13_magnitude": dataclasses.replace(MFCC13_HTK,
                                                spectrum="magnitude"),
        "mfcc13_lifter22": dataclasses.replace(MFCC13_HTK, lifter=22),
        "mfcc13_log10": dataclasses.replace(MFCC13_HTK, log="log10"),
        "hop100": FeatureConfig(hop_length=100, frame_length=300),
        "fl1024": FeatureConfig(frame_length=1024, hop_length=256,
                                n_fft=1024, n_mels=40),
        # past one slab of 128 mel bands: MFCCs, and a log-mel
        "mel160_mfcc13": FeatureConfig(n_mels=160, n_mfcc=13),
        "mel200_logmel": FeatureConfig(n_mels=200, n_mfcc=0),
    }
    rng = np.random.default_rng(1)
    worst = {prec: 0.0 for prec in PRECISIONS}
    # at "default": the largest share of frames past TOL_TWIN and the most
    # such frames in one window of the tile's, per phase (PERF.md)
    flips = {}

    def note_flips(where: str, agreement) -> str:
        share, window = flips.get(where, (0.0, 0))
        flips[where] = (max(share, agreement.frames_past),
                        max(window, agreement.worst_window))
        return (f" frames_past={agreement.frames_past:.4%} "
                f"worst_window={agreement.worst_window}")
    for prec in PRECISIONS:
        for name, base in variants.items():
            cfg = dataclasses.replace(base, matmul_precision=prec)
            for n_frames in (1, tf - 1, tf, tf + 1, tm - 1, tm, tm + 1, 127,
                             129, 3000):
                for batch in (1, 3):
                    # 3 samples short of the last frame: the zero reads past M
                    M = (n_frames - 1) * cfg.hop_length + cfg.frame_length - 3
                    buf = torch.tensor(rng.standard_normal((batch, M)) * 0.1,
                                       dtype=torch.float32, device="cuda")
                    got = signal.signal_features(buf, n_frames, cfg)
                    torch.cuda.synchronize()
                    want = signal.signal_features_reference(buf, n_frames, cfg)
                    torch.cuda.synchronize()
                    a = tolerance.compare_to_twin(
                        got, want, framing.frames_from_buffer(
                            buf, n_frames, cfg.frame_length, cfg.hop_length),
                        cfg, what=f"{name} {prec} n_frames={n_frames} "
                        f"B={batch}")
                    worst[prec] = max(worst[prec], a.scaled)
                    seen = note_flips(f"grid {prec}", a)
                    print(f"kernel vs twin {prec:8s} {name:17s} "
                          f"n_frames={n_frames:4d} B={batch}: "
                          f"max_abs_err={a.max_abs_err:.3e} "
                          f"scaled={a.scaled:.3e}{seen}")
    print(f"kernel vs twin: every case within tolerance.compare_to_twin "
          f"(worst scaled {worst})")

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
    launches = read_counts("the dual extract (bf16x3)",
                           {"signal_features_mma": 2})
    print(f"main path: whisper80 {tuple(mel.features.shape)} mfcc13 "
          f"{tuple(mfcc.features.shape)}; tensor-core signal kernel "
          f"launches {launches['signal_features_mma']}")
    # the same dual at "highest": the kernel's six-pass variant on the same
    # batch
    cfg_mel_hi = dataclasses.replace(cfg_mel, **HIGHEST)
    cfg_mfcc_hi = dataclasses.replace(cfg_mfcc, **HIGHEST)
    reset_counts()
    mel_hi = extract(sig, lengths, cfg_mel_hi, device="cuda")
    mfcc_hi = extract(sig, lengths, cfg_mfcc_hi, device="cuda").features
    torch.cuda.synchronize()
    read_counts("the dual extract (highest)", {"signal_features_mma": 2},
                highest=True)
    goldens = {}                        # (base config name, row) -> golden
    for res, cfg, base, prec in (
            (mel, cfg_mel, WHISPER80, "bf16x3"),
            (mfcc, cfg_mfcc, MFCC13_HTK, "bf16x3"),
            (mel_hi, cfg_mel_hi, WHISPER80, "highest"),
            (mfcc_hi, cfg_mfcc_hi, MFCC13_HTK, "highest")):
        feats = getattr(res, "features", res)
        check(feats.shape == (BATCH, cfg.num_frames(n), cfg.feature_dim),
              "main-path shape")
        check(bool(torch.isfinite(feats).all()), "main path finite")
        if (base.n_mels, 0) not in goldens:
            goldens[base.n_mels, 0] = cpu.extract(
                sig[0].astype(np.float64), base)
        err, rel = scaled_err(feats[0].cpu(),
                              torch.from_numpy(goldens[base.n_mels, 0]))
        limit = TOL_HIGHEST if prec == "highest" else TOL_GOLDEN
        print(f"main path at {prec} (tensor-core kernel, "
              f"{signal.passes(cfg)} bf16 passes) row 0 vs float64 golden, "
              f"{base.n_mels}-mel: max_abs_err={err:.3e} scaled={rel:.3e} "
              f"(limit {limit})")
        check(rel <= limit, f"row 0 at {prec} vs golden {rel:.3e}")
    del mel_hi

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

    # 5. timing on the card: the dual call, kernel path and twin path in
    # turns, and the kernel at "default" and "highest" on the same buffers
    x = torch.from_numpy(sig).cuda()
    lx = torch.from_numpy(lengths).cuda()

    def dual(cm=cfg_mel, cf=cfg_mfcc):
        return (extract(x, lx, cm).features, extract(x, lx, cf).features)

    def twin_dual():
        with twin_of(signal, "signal_features"):
            return dual()

    bufs = []
    for cfg in (cfg_mel, cfg_mfcc):
        xx = framing.preemphasize(x, cfg.preemphasis) \
            if cfg.preemphasis else x
        bufs.append((framing.framing_buffer(xx, lx, cfg)[0].contiguous(),
                     cfg.num_frames(n), cfg))

    def kernels(prec="bf16x3"):
        return [signal.signal_features(
            buf, f, dataclasses.replace(cfg, matmul_precision=prec))
            for buf, f, cfg in bufs]

    def twins(prec="bf16x3"):
        return [signal.signal_features_reference(
            buf, f, dataclasses.replace(cfg, matmul_precision=prec))
            for buf, f, cfg in bufs]

    main_err = {}
    for prec in PRECISIONS:
        got, want = kernels(prec), twins(prec)
        torch.cuda.synchronize()
        errs = []
        for g, w, (buf, f, cfg) in zip(got, want, bufs):
            errs.append(tolerance.compare_to_twin(
                g, w, framing.frames_from_buffer(buf, f, cfg.frame_length,
                                                 cfg.hop_length),
                dataclasses.replace(cfg, matmul_precision=prec),
                what=f"main-path {cfg.n_mels}-mel at {prec}"))
            seen = note_flips(f"main {prec}", errs[-1])
            print(f"kernel vs twin at the main path's shapes, "
                  f"{cfg.n_mels}-mel at {prec}: max_abs_err="
                  f"{errs[-1].max_abs_err:.3e} scaled={errs[-1].scaled:.3e}"
                  f"{seen}")
        main_err[prec] = max(e.max_abs_err for e in errs)
        if prec == "default":
            # the guard's negative control: the bf16x3 kernel's output held
            # as if it were the default kernel's (a pass swap)
            swapped = kernels("bf16x3")
            for g, w, (buf, f, cfg) in zip(swapped, want, bufs):
                scale = max(1.0, w.abs().max().item())
                share, window = tolerance.frames_past(
                    (g.double() - w.double()).abs(),
                    tolerance.TOL_TWIN * scale)
                print(f"pass swap at the main path's shapes, {cfg.n_mels}-"
                      f"mel (bf16x3 kernel vs default twin): frames_past="
                      f"{share:.4%} worst_window={window}")
                check(window > tolerance.FLIP_FRAMES,
                      f"the default check lets a pass swap through "
                      f"({cfg.n_mels}-mel)")
            del swapped
        del got, want

    paths = {"dual_kernel": dual, "dual_twin": twin_dual,
             "kernel_only": kernels, "twin_only": twins,
             "dual_highest": functools.partial(dual, cfg_mel_hi, cfg_mfcc_hi),
             "default_only": functools.partial(kernels, "default"),
             "highest_only": functools.partial(kernels, "highest"),
             "highest_twin_only": functools.partial(twins, "highest")}
    ms, times, peak = time_paths(paths, REPS)
    audio = BATCH * SECONDS
    for name in paths:
        print(f"{name:14s}: median {ms[name]:.3f} ms per batch of "
              f"{BATCH} x {SECONDS} s (RTFx {audio / (ms[name] / 1e3):.0f}), "
              f"runs {['%.3f' % t for t in times[name]]}, "
              f"peak memory {peak[name] / 2**20:.0f} MiB [{card}]")
    k1 = {}
    for prec in ("bf16x3", "default", "highest"):
        flops, moved = {}, 0
        for buf, f, cfg in bufs:
            rows = buf.shape[0] * f
            work, consts = signal_work(
                rows, dataclasses.replace(cfg, matmul_precision=prec))
            for kind, v in work.items():
                flops[kind] = flops.get(kind, 0) + v
            moved += nbytes(buf, *consts) + 4 * rows * cfg.feature_dim
        k1[prec] = bound(flops, moved)
        print(f"K1 bound for the dual at {prec}: {k1[prec][0]:.3f} ms "
              f"({k1[prec][1]}; FLOPs {flops}, {moved / 1e9:.3f} GB)")
    del bufs
    signal_replaces = "tpufeat/pallas/fused.py:669, tpufeat/pallas/" \
        "fused.py:353"
    kernel_rows = {
        "signal_mma": dict(
            source="tpufeat_torch/csrc/signal_mma.cu",
            replaces=signal_replaces,
            max_abs_err=main_err["bf16x3"], ms=ms["kernel_only"],
            plain_ms=ms["twin_only"], bound=k1["bf16x3"]),
        "signal_mma_highest": dict(
            source="tpufeat_torch/csrc/signal_mma.cu",
            replaces=signal_replaces,
            max_abs_err=main_err["highest"], ms=ms["highest_only"],
            plain_ms=ms["highest_twin_only"], bound=k1["highest"])}

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

    worst = {}
    for name, base in staged_variants.items():
        for rows in ROWS:
            frames = torch.randn(rows, base.frame_length, generator=gen,
                                 device="cuda") * 0.1
            spec = spectrum_rows(frames, base)
            cases = [(kernel, prec, inp) for prec in PRECISIONS
                     for kernel, inp in (("dft_mel_log_dct", frames),
                                         ("mel_log_dct", spec))]
            for kernel, prec, inp in cases:
                cfg = dataclasses.replace(base, matmul_precision=prec)
                got = getattr(staged, kernel)(inp, cfg)
                torch.cuda.synchronize()
                want = getattr(staged, f"{kernel}_reference")(inp, cfg)
                torch.cuda.synchronize()
                what = f"{kernel} {name} {prec} R={rows}"
                k4 = kernel == "mel_log_dct"
                a = tolerance.compare_to_twin(
                    got, want, inp, cfg, fold_kaldi=False, what=what,
                    spectrum=k4)
                err, rel = a.max_abs_err, a.scaled
                seen = note_flips(f"{'K4' if k4 else 'K3'} grid {prec}", a)
                worst[kernel, prec] = max(worst.get((kernel, prec), 0.0),
                                          rel)
                print(f"{kernel:15s} vs twin {prec:8s} {name:19s} "
                      f"R={rows:5d}: max_abs_err={err:.3e} scaled={rel:.3e}"
                      f"{seen}")
    print(f"K3/K4 vs twin: every case within its tolerance (worst scaled "
          f"{ {f'{k} {p}': v for (k, p), v in worst.items()} })")

    # 7. staged one-shot extraction of the main batch, MFCC-13: K3, and
    # cuFFT + K4; at bf16x3 against the golden, at "highest" (fp32 in each
    # route) against the fused route as well
    routes = {"dft_mel_log_dct": dataclasses.replace(MFCC13_HTK, **STAGED_K3),
              "mel_log_dct": dataclasses.replace(MFCC13_HTK, **STAGED_K4)}
    for kernel, cfg in routes.items():
        for prec in ("bf16x3", "highest"):
            c = dataclasses.replace(cfg, matmul_precision=prec)
            counter = "dft_mel_log_dct_mma" if kernel == "dft_mel_log_dct" \
                else kernel
            reset_counts()
            res = extract(sig, lengths, c, device="cuda")
            torch.cuda.synchronize()
            read_counts(f"staged extract via {kernel} at {prec}",
                        {counter: 1}, highest=prec == "highest")
            check(res.features.shape == mfcc.features.shape, "staged shape")
            check(bool(torch.isfinite(res.features).all()), "staged finite")
            err, rel = scaled_err(
                res.features[0].cpu(),
                torch.from_numpy(goldens[MFCC13_HTK.n_mels, 0]))
            print(f"staged extract via {kernel} at {prec}: row 0 vs float64 "
                  f"golden max_abs_err={err:.3e} scaled={rel:.3e}")
            check(rel <= TOL_GOLDEN, f"staged {kernel} row 0 vs golden "
                  f"{rel:.3e}")
            if prec == "highest":
                err, rel = scaled_err(res.features, mfcc_hi)
                print(f"staged extract via {kernel} at highest: B={BATCH} "
                      f"vs the fused route at highest max_abs_err={err:.3e} "
                      f"scaled={rel:.3e}")
                check(rel <= TOL_ROUTE, f"staged {kernel} vs fused {rel:.3e}")
            del res
            if prec == "bf16x3":
                check_ragged(extract(xr, ragged, c, device="cuda"),
                             MFCC13_HTK, f"staged via {kernel}")
    del mfcc_hi

    xx = framing.preemphasize(x, MFCC13_HTK.preemphasis)
    frames_main = framing.condition_frames(
        framing.frame_signal(xx, lx, MFCC13_HTK)[0], MFCC13_HTK
    ).reshape(-1, MFCC13_HTK.frame_length).contiguous()
    spec_main = spectrum_rows(frames_main, MFCC13_HTK).contiguous()
    del xx
    print(f"staged kernels' main-path inputs: frames "
          f"{tuple(frames_main.shape)}, spectrum {tuple(spec_main.shape)}")
    k3 = {}
    for prec in PRECISIONS:
        cfg = dataclasses.replace(routes["dft_mel_log_dct"],
                                  matmul_precision=prec)
        got = staged.dft_mel_log_dct(frames_main, cfg)
        want = staged.dft_mel_log_dct_reference(frames_main, cfg)
        torch.cuda.synchronize()
        a = tolerance.compare_to_twin(got, want, frames_main, cfg,
                                      fold_kaldi=False,
                                      what=f"main-path K3 at {prec}")
        err = a.max_abs_err
        print(f"dft_mel_log_dct at {prec} vs twin at the main path's shapes: "
              f"max_abs_err={err:.3e} scaled={a.scaled:.3e}"
              f"{note_flips(f'K3 main {prec}', a)}")
        work, consts = signal_work(frames_main.shape[0], cfg,
                                   fold_kaldi=False)
        k3[prec] = bound(work, nbytes(frames_main, *consts, got))
        print(f"K3 bound at {prec}: {k3[prec][0]:.3f} ms ({k3[prec][1]}; "
              f"FLOPs {work})")
        row = kernel_rows["signal_mma_highest" if prec == "highest"
                          else "signal_mma"]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        del got, want
    k4 = {}
    for prec in PRECISIONS:
        cfg = dataclasses.replace(routes["mel_log_dct"],
                                  matmul_precision=prec)
        got = staged.mel_log_dct(spec_main, cfg)
        want = staged.mel_log_dct_reference(spec_main, cfg)
        torch.cuda.synchronize()
        a = tolerance.compare_to_twin(got, want, spec_main, cfg,
                                      what=f"main-path K4 at {prec}",
                                      spectrum=True)
        print(f"mel_log_dct at {prec} vs twin at the main path's shapes: "
              f"max_abs_err={a.max_abs_err:.3e} scaled={a.scaled:.3e}"
              f"{note_flips(f'K4 main {prec}', a)}")
        work, consts = tail_work(spec_main.shape[0], cfg)
        k4[prec] = bound(work, nbytes(spec_main, *consts, got))
        print(f"K4 bound at {prec}: {k4[prec][0]:.3f} ms ({k4[prec][1]}; "
              f"FLOPs {work}, "
              f"{nbytes(spec_main, *consts, got) / 1e9:.3f} GB)")
        if prec == "bf16x3":
            kernel_rows["mel_log_dct"] = dict(
                source="tpufeat_torch/csrc/signal_mma.cu",
                replaces="tpufeat/pallas/fused.py:336",
                max_abs_err=a.max_abs_err, bound=k4[prec])
        del got, want

    def staged_path(kernel, twin, prec="bf16x3"):
        cfg = dataclasses.replace(routes[kernel], matmul_precision=prec)

        def run():
            with twin_of(staged, kernel) if twin else \
                    contextlib.nullcontext():
                return extract(x, lx, cfg).features
        return run

    paths = {}
    for kernel, short, inp in (("dft_mel_log_dct", "k3", frames_main),
                               ("mel_log_dct", "k4", spec_main)):
        cfg = routes[kernel]
        paths[f"{short}_extract_kernel"] = staged_path(kernel, False)
        paths[f"{short}_extract_twin"] = staged_path(kernel, True)
        paths[f"{short}_only"] = functools.partial(
            getattr(staged, kernel), inp, cfg)
        paths[f"{short}_twin_only"] = functools.partial(
            getattr(staged, f"{kernel}_reference"), inp, cfg)
    for prec in ("highest", "default"):
        for kernel, short, inp in (("dft_mel_log_dct", "k3", frames_main),
                                   ("mel_log_dct", "k4", spec_main)):
            cfg = dataclasses.replace(routes[kernel], matmul_precision=prec)
            paths[f"{short}_{prec}_only"] = functools.partial(
                getattr(staged, kernel), inp, cfg)
    paths["k3_highest_twin_only"] = functools.partial(
        staged.dft_mel_log_dct_reference, frames_main,
        dataclasses.replace(routes["dft_mel_log_dct"], **HIGHEST))
    ms, times, peak = time_paths(paths, REPS)
    for name in paths:
        print(f"{name:18s}: median {ms[name]:.3f} ms per batch of "
              f"{BATCH} x {SECONDS} s MFCC-13 "
              f"(RTFx {audio / (ms[name] / 1e3):.0f}), "
              f"runs {['%.3f' % t for t in times[name]]}, "
              f"peak memory {peak[name] / 2**20:.0f} MiB [{card}]")
    kernel_rows["mel_log_dct"].update(ms=ms["k4_only"],
                                      plain_ms=ms["k4_twin_only"])
    for prec, name in (("bf16x3", "k3_only"), ("highest", "k3_highest_only"),
                       ("default", "k3_default_only")):
        print(f"tensor-core kernel as K3 at {prec}: {ms[name]:.3f} ms, "
              f"bound {k3[prec][0]:.3f} ms "
              f"({100 * k3[prec][0] / ms[name]:.1f} % of it) [{card}]")
    for prec, name in (("bf16x3", "k4_only"), ("highest", "k4_highest_only"),
                       ("default", "k4_default_only")):
        print(f"K4 at {prec}: {ms[name]:.3f} ms, bound {k4[prec][0]:.3f} ms "
              f"({k4[prec][1]}, {100 * k4[prec][0] / ms[name]:.1f} % of it) "
              f"[{card}]")
    del frames_main, spec_main

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

    pre = framing.preemphasize(xs, MFCC13_HTK.preemphasis)

    def against_twin(name: str, module, kernel: str, run, out, cfg) -> None:
        """Run the streaming path ``run`` again with ``kernel`` replaced by
        its plain twin (so at the shapes streaming gives the kernel), check
        that no kernel launched, and hold the kernel path's ``out`` against
        it on every stream (the signal kernels by tolerance.compare_to_twin on
        the streams' frames, STREAM_BLOCK streams at a time)."""
        reset_counts()
        with twin_of(module, kernel):
            want = run()
        torch.cuda.synchronize()
        check(all(getattr(mod, attr) == 0 for _, mod, attr in counters),
              f"streaming {name}: the twin run launched a kernel")
        if kernel == "mel_log_dct":
            err, rel = scaled_err(out, want)
            check(rel <= TOL_KERNEL, f"streaming {name} kernel vs twin "
                  f"{rel:.3e} > {TOL_KERNEL}")
        else:
            err = rel = 0.0
            for s0 in range(0, STREAMS, STREAM_BLOCK):
                a = tolerance.compare_to_twin(
                    out[s0: s0 + STREAM_BLOCK], want[s0: s0 + STREAM_BLOCK],
                    framing.frames_from_buffer(
                        pre[s0: s0 + STREAM_BLOCK], n_frames,
                        cfg.frame_length, cfg.hop_length),
                    cfg, what=f"streaming {name}")
                err, rel = max(err, a.max_abs_err), max(rel, a.scaled)
        print(f"streaming {name}: {kernel} vs its twin on all {STREAMS} "
              f"streams: max_abs_err={err:.3e} scaled={rel:.3e}")
        row = kernel_rows["mel_log_dct" if kernel == "mel_log_dct"
                          else "signal_mma"]
        row["max_abs_err"] = max(row["max_abs_err"], err)

    # the chunk plans at "highest" (the six-pass variant), bit for bit
    cfg_s_hi = dataclasses.replace(cfg_s, **HIGHEST)
    reset_counts()
    out = frontend_run(cfg_s_hi, [CHUNK] * STEPS)
    torch.cuda.synchronize()
    read_counts("StreamingFrontend.process at highest",
                {"signal_features_mma": STEPS}, highest=True)
    check(torch.equal(streaming.extract_scan(xs, cfg_s_hi, CHUNK), out),
          "streaming at highest != extract_scan(..., 1600)")
    check(torch.equal(frontend_run(cfg_s_hi, [3 * CHUNK] * (STEPS // 3)),
                      out), "plan [4800] * 10 != plan [1600] * 30 at highest")
    print(f"streaming at highest S={STREAMS} x {STEPS} steps of {CHUNK}: "
          f"{tuple(out.shape)} bit-identical to extract_scan(..., {CHUNK}) "
          f"and to the plan [{3 * CHUNK}] * {STEPS // 3}")
    del out

    fused_run = functools.partial(frontend_run, cfg_s, [CHUNK] * STEPS)
    reset_counts()
    out = fused_run()
    torch.cuda.synchronize()
    read_counts("StreamingFrontend.process (fused static step)",
                {"signal_features_mma": STEPS})
    against_twin("static_fused", signal, "signal_features", fused_run, out,
                 cfg_s)
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
        read_counts(f"streaming {name}", {
            "dft_mel_log_dct_mma" if kernel == "dft_mel_log_dct" else kernel:
            STEPS})
        against_twin(name, staged, kernel, run, out, cfg)
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

    # 9. Kaldi-39, offline and online (StreamingPipeline)
    for row, err in kaldi39_phase(sig, STREAMS, STEPS, reset_counts,
                                  read_counts, card).items():
        kernel_rows[row]["max_abs_err"] = max(
            kernel_rows[row]["max_abs_err"], err)

    # 10. the anatomy family (K5a-h): each runner's every mode at its
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
        if runner in ("phase_anatomy", "phase_anatomy4"):
            # the same call twice, the same bits (fixed tiles and sums, no
            # atomics; not part of the main path's launch count)
            for mode in ("full", "allhighest"):
                if mode in mod.MODES:
                    twice = [_common.call(inp, mod.MODES[mode])()
                             for _ in range(2)]
                    torch.cuda.synchronize()
                    check(torch.equal(*twice), f"{runner} {mode}: two "
                          f"launches differ")
                    print(f"anatomy {runner} {mode}: two launches "
                          f"bit-identical [{card}]")
                    del twice
        del inp, outs

    # the pass counts at the scripts' shape, where no z*z can round apart
    # in the kernel and the twin, held to the pre-log tolerance: dftonly at
    # every DFT precision, and every mel precision behind an identity DFT
    # at six passes (z is then the signal, exactly: its three pieces
    # against the identity's hi; the identity's lo and lo2 are 0)
    inp = phase_anatomy.inputs("cuda")
    eye = anatomy.constants_from_numpy(
        [[(0, 0, np.eye(_common.NCS, dtype=np.float32))]],
        (inp.consts.fb_hi, inp.consts.fb_lo, inp.consts.fb_f32), "cuda")
    for prec in anatomy.PRECISIONS:
        for what, consts, dft, mel, tail in (
                ("dftonly", inp.consts, prec, None, "dftonly"),
                ("identity DFT, mel", eye, "bf16x6", prec, "nolog")):
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

    for where, (share, window) in flips.items():
        print(f"frames past TOL_TWIN, {where}: largest share {share:.4%}, "
              f"most in one window of {signal.MMA_TILE_FRAMES} frames "
              f"{window} (the default check allows "
              f"{tolerance.FLIP_FRAMES})")
    for name, count in path_launches.items():
        check(count > 0, f"{name} was launched no time in the main paths")
    # one row per kernel: the signal kernel's launches are those of both of
    # its routes, K1 and K3, its six-pass variant ("highest") apart
    for name, count in row_launches.items():
        check(count > 0, f"{name} was launched no time in the main paths")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": kernel_rows[name]["source"],
         "replaces": kernel_rows[name]["replaces"],
         "launches": launches,
         "max_abs_err": kernel_rows[name]["max_abs_err"],
         "ms": kernel_rows[name]["ms"],
         "plain_ms": kernel_rows[name]["plain_ms"],
         "bound_ms": kernel_rows[name]["bound"][0],
         "bound_by": kernel_rows[name]["bound"][1],
         # no single PyTorch call computes any of these fused functions
         "library_ms": None}
        for name, launches in row_launches.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
