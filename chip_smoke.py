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
the other front-end families (:func:`families_phase`): one ``extract`` of
the same ragged batch for FBANK80, WHISPER128, GFCC13, FBANK80 with VTLN,
PLP13 and PNCC13 with the fused flags at bf16x3 and "highest" (K1 with
log "none" for PLP's and PNCC's raw energies) and SPEC257 on the plain
path, each with its K1 launches, K1 against its twin, two rows against the
float64 golden and its time; the stream pool (:func:`pool_phase`):
``StreamPool`` over the sliding-CMVN pipeline on 4096 slots, 256 of them
recycled every tick, timed beside the bare step and profiled, its
recycled and untouched slots bit for bit against a zeros-prefix oracle;
the corpus pipeline (:func:`corpus_phase`): ``python -m
tpufeat_torch.pipeline`` over 256 WAVs to an ark, every utterance against
``extract`` of it alone, and ``extract_corpus`` with the native C++
decoder (its arks bit for bit those of the Python decoder) and the Python
one, and with its upload and fetch knobs on and off; 48 kHz capture with
Kaldi pitch (:func:`rate_pitch_phase`): ``StreamingPipeline(input_rate=48000,
pitch=True)`` on the 4096 streams, bit for bit against the same pipeline
fed the offline resample, its pitch columns against the CPU run, its step
timed and profiled; offline ``resample``, ``extract`` and
``pitch_features`` of B=128 x 30 s at 48 kHz against scipy, K1's twin and
the float64 golden; and a pool over that pipeline; the speaker stack
(:func:`speaker_phase`) at Kaldi's width (512-gauss UBM, 100-dim
i-vectors), trained on the card from the kaldi39 batch:
``StreamingPipeline(pitch=True, ivector=)`` on the 4096 streams (142-dim
rows, their spectral and pitch columns bit for bit against the pipeline
without i-vectors, their i-vector columns against ``ivector_features``)
and a pool over it, offline i-vectors and fMLLR against the CPU and the
float64 golden, diarization of 30 min and 3 h drawn from the
extractor's model against the truth and the CPU, and ``diarize_long`` on
the reference's own long-form world (``diarize_long_bench.py``'s
generator at G=512, K=100) against the truth and, on 30 min of it, the
CPU's labels; the ASR models (:func:`models_phase`): ``asr_forward`` of
the main path's batch through whisper-tiny on ``WHISPER80`` and
conformer-small on ``KALDI39`` (K1 on the path, the front-end's share,
two rows against the CPU) and a few CTC, RNN-T and x-vector training
steps with falling losses; multi-device extraction and training over
``torch.distributed`` (:func:`sharding_phase`): a one-rank NCCL group
(dp of the main path's batch and time sharding of one hour of audio,
against the unsharded ``extract``), then four gloo ranks sharing the card
(dp, time sharding, the 2x2 mesh, pitch dp, the CTC and x-vector steps
data-parallel against one rank's, dp i-vectors and PLDA scores, and
``python -m tpufeat_torch.pipeline --dp`` over the corpus WAVs, its ark
byte for byte the one-rank pass's), each rank's K1 launches counted; the
toolchain shims (:func:`compat_phase`: ``WhisperFeatureExtractor`` on the
main path's batch against the golden and the CPU, ``FeatureLoader`` over
a DataLoader with four workers); the five examples
(:func:`examples_phase`); and the phase-kernel
anatomy family (K5a-h): every mode of the eight runners of
``tpufeat_torch.experiments`` at its script's own shape through
``anatomy_features``, each held against its plain twin and both timed, with
the mode's bound, ``full`` and ``allhighest`` launched twice for the same
bits, then every precision's pass count at the scripts' shape (the
``dftonly`` tail, and the mel product behind an identity DFT).

Every path is driven with the launch counts set to 0 just before it and
read just after. Any failure exits non-zero; nothing is caught. Needs one
CUDA card, nvcc and g++; imports nothing of jax or tpufeat. The line
before the
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
TOL_IVECTOR = 1e-4  # online i-vector columns vs ivector_features of the
#                     same base rows (tests/test_torch_ivector.py's)
TRAIN_LR = 3e-4     # the models phase's AdamW learning rate
TOL_MODEL = 1e-3    # asr_forward's logits on the card vs the same model
#                     on the CPU (K1's twin), scaled by max(1, |CPU|.max()):
#                     the front-end's 1e-3 fidelity budget, through the
#                     encoder
TOL_SHARD_CMVN = 2e-5  # sharded vs unsharded with CMVN, scaled: its sums
#                       reassociated over the ranks (the reference's dry-run
#                       bound); without CMVN the two must be equal
TOL_DP_LOSS = 1e-5  # a dp step's all-reduced loss vs one rank's, relative:
#                     the batch mean taken as a mean of the ranks' means
TOL_DP_GRAD = 1e-4  # a dp step's averaged gradient vs one rank's, scaled
#                     by each tensor's largest entry (tests/
#                     test_torch_models.py's bound): sums over the rows in
#                     another order
TOL_DP_PARAMS = 1e-2  # the parameters after one dp AdamW step vs one
#                       rank's, in units of the learning rate, wherever the
#                       gradient is farther from 0 than TOL_DP_GRAD: the
#                       first update is about sign(g) per entry, so where g
#                       is within its sum-order noise of 0 the two steps may
#                       move an entry lr apart either way
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


def ragged_lengths(n: int, batch: int) -> np.ndarray:
    """The kaldi39 and families phases' lengths: row 0 whole, the others
    uniform in [n // 100, n) (seed 39)."""
    rng = np.random.default_rng(39)
    return np.concatenate([[n], rng.integers(n // 100, n, batch - 1)])


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
    lengths = ragged_lengths(n, B)
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


def idle_share(fn, calls: int) -> tuple[float, float, float]:
    """(wall ms, device ms, idle share) per call of ``fn`` over ``calls``
    calls under torch.profiler: the device time is the summed self time
    of the CUDA kernel and copy rows of ``key_averages()``
    (``tpufeat_torch.profile_stream``'s reading)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3 / calls
    return wall, device, 1.0 - device / wall


def top_kernels(fn, k: int = 4) -> str:
    """The ``k`` device kernels of one call of ``fn`` with the most self
    time under torch.profiler: "name ms (launches)", comma-separated."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)[:k]
    return ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} "
                     f"ms ({e.count})" for e in rows)


def device_launches(fn) -> tuple[int, float]:
    """(device kernel launches, device ms) of one call of ``fn`` under
    torch.profiler: the launch count and self time of the CUDA kernel
    rows of ``key_averages()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in rows),
            sum(e.self_device_time_total for e in rows) / 1e3)


def families_phase(sig: np.ndarray, reset_counts, read_counts, card: str,
                   device: str = "cuda", reps: int = REPS,
                   pncc_reps: int = 3) -> dict:
    """The other front-end families through ``extract`` on the batch
    ``sig`` with the kaldi39 phase's ragged lengths: FBANK80, WHISPER128,
    GFCC13, FBANK80 with VTLN (warp 1.1), PLP13 (K1 with log "none", 23
    bands) and PNCC13 (40 gammatone bands) with the fused flags at bf16x3
    and "highest", and SPEC257 on the plain path (it has no kernel route).
    Each: K1's launches, K1 against its twin at these shapes (for raw
    energies also elementwise against the bound that replaces the
    tolerance's max-scaled 1e-4: the sum-order bound plus 1e-4 of each
    energy), rows 0 and 1 against the float64 golden, and the call timed
    (CUDA events, median of ``reps``, PNCC's of ``pncc_reps``). Returns
    the largest K1-vs-twin error of the log-domain outputs per row of the
    kernels line."""
    from tpufeat_torch import (FBANK80, GFCC13, WHISPER128, extract,
                               framing)
    from tpufeat_torch.config import PLP13, PNCC13, SPEC257
    from tpufeat_torch.kernels import signal
    from tpufeat_torch.kernels import _tolerance as tolerance
    from tpufeat_torch.reference import cpu

    B, n = sig.shape
    lengths = ragged_lengths(n, B)
    x = torch.from_numpy(sig).to(device)
    lx = torch.from_numpy(lengths).to(device)
    audio = float(lengths.sum()) / SR
    errs = {"signal_mma": 0.0, "signal_mma_highest": 0.0}
    bases = {"fbank80": FBANK80, "whisper128": WHISPER128,
             "gfcc13": GFCC13,
             "fbank80_vtln": dataclasses.replace(FBANK80, vtln_warp=1.1),
             "plp13": PLP13, "pncc13": PNCC13}
    cfgs = {f"{name} {prec}": dataclasses.replace(
        base, **dict(FUSED, matmul_precision=prec))
        for name, base in bases.items() for prec in ("bf16x3", "highest")}
    cfgs["spec257 plain"] = SPEC257
    gold = {}
    for name, cfg in cfgs.items():
        family = name.split()[0]
        kernel = cfg.use_pallas
        hi = cfg.matmul_precision == "highest"
        reset_counts()
        res = extract(x, lx, cfg)
        torch.cuda.synchronize()
        read_counts(f"families extract ({name})",
                    {"signal_features_mma": 1} if kernel else {},
                    highest=hi)
        feats, nf = res.features, res.num_frames.cpu()
        check(feats.shape == (B, cfg.num_frames(n), cfg.feature_dim),
              f"families {name} shape {tuple(feats.shape)}")
        check(torch.equal(nf, framing.num_frames_dynamic(
            torch.from_numpy(lengths), cfg).to(torch.int32)),
            f"families {name} frame counts")
        check(bool(torch.isfinite(feats[res.mask]).all()),
              f"families {name} finite")
        line = f"families {name}:"
        if kernel:
            xx = framing.preemphasize(x, cfg.preemphasis) \
                if cfg.preemphasis and not cfg.kaldi_mode else x
            buf = framing.framing_buffer(xx, lx, cfg)[0].contiguous()
            F = cfg.num_frames(n)
            got = signal.signal_features(buf, F, cfg)
            want = signal.signal_features_reference(buf, F, cfg)
            frames = framing.frames_from_buffer(buf, F, cfg.frame_length,
                                                cfg.hop_length)
            a = tolerance.compare_to_twin(got, want, frames, cfg,
                                          what=f"families K1 ({name})")
            line += (f" K1 vs twin max_abs_err={a.max_abs_err:.3e} "
                     f"scaled={a.scaled:.3e}")
            if cfg.log == "none":
                # raw energies: each band against its own size
                flat = frames.reshape(-1, frames.shape[-1])
                worst = 0.0
                for r0 in range(0, flat.shape[0], tolerance.TWIN_ROWS):
                    t = tolerance.twin_stages(
                        flat[r0:r0 + tolerance.TWIN_ROWS], cfg, True)
                    bnd = tolerance.sum_order_bound(t, cfg)
                    w = want.reshape(-1, want.shape[-1])[
                        r0:r0 + tolerance.TWIN_ROWS].double()
                    g = got.reshape(-1, got.shape[-1])[
                        r0:r0 + tolerance.TWIN_ROWS].double()
                    ratio = ((g - w).abs() / (bnd + tolerance.TOL_TWIN
                                              * w.abs())).max().item()
                    worst = max(worst, ratio)
                    del t, bnd
                line += (f" (raw {cfg.n_mels} energies: error up to "
                         f"{worst:.3f} x each band's bound)")
                check(worst <= 1.0, f"families {name}: raw energies past "
                      f"their bound ({worst:.3f} x)")
            else:
                row = "signal_mma_highest" if hi else "signal_mma"
                errs[row] = max(errs[row], a.max_abs_err)
            del got, want, frames, buf
        for i in (0, 1):
            key = (family, i)
            if key not in gold:
                gold[key] = cpu.extract(
                    sig[i, :lengths[i]].astype(np.float64), cfg)
            g = gold[key]
            got = feats[i, :int(nf[i])].double().cpu().numpy()
            check(got.shape == g.shape, f"families {name} row {i} shape")
            d = np.abs(got - g)
            scale = max(1.0, np.abs(g).max())
            if family == "plp13":
                limit = (5e-3, 2e-4) if not hi else (2e-3, None)
                ok = d.max() < limit[0] and (limit[1] is None
                                             or np.median(d) < limit[1])
                what = (f"max {d.max():.3e} median {np.median(d):.3e} "
                        f"(limits {limit[0]}, {limit[1]})")
            elif family == "pncc13" and hi:
                ok, what = d.max() < 2e-3, f"max {d.max():.3e} (limit 2e-3)"
            elif family == "pncc13":
                # bf16x3 moves the energies by about 2^-16, enough to flip
                # the excitation switch (Q >= 2 Qle) of a frame near it,
                # in the reference package too: no limit here
                ok = True
                what = (f"max {d.max():.3e} median {np.median(d):.3e}, "
                        f"{int((d.max(axis=1) > 5e-3).sum())} of "
                        f"{d.shape[0]} frames past 5e-3 (no limit: bf16x3)")
            elif family == "spec257":
                # a bin's log power carries the f32 transform's error
                # relative to the frame's peak bins: 1e-3 of the log does
                # not hold for bins 8 decades down (the reference's is
                # further off on these rows), so the bins are held in
                # power relative to each frame's peak; element 0 is the
                # log frame energy. 2e-6: an f32 transform of 512 points
                # rounds to about log2(512) 2^-24 of the frame's amplitude,
                # some 1e-6 of its peak power
                p_got, p_gold = np.exp(got[:, 1:]), np.exp(g[:, 1:])
                rel = (np.abs(p_got - p_gold)
                       / p_gold.max(axis=1, keepdims=True)).max()
                ok = rel <= 2e-6 and d[:, 0].max() <= TOL_GOLDEN
                what = (f"power rel. to the frame's peak {rel:.3e} (limit "
                        f"2e-6), log energy {d[:, 0].max():.3e} (limit "
                        f"{TOL_GOLDEN}), log power {d.max():.3e} (no limit)")
            elif hi:
                ok = d.max() / scale <= TOL_GOLDEN
                what = f"scaled {d.max() / scale:.3e} (limit {TOL_GOLDEN})"
            else:
                ok, what = True, f"scaled {d.max() / scale:.3e} (no limit: " \
                    f"bf16x3)"
            line += f"{';' if kernel or i else ''} row {i} vs golden {what}"
            check(ok, f"families {name} row {i} vs golden: {what}")
        print(line)
        del res, feats
        ms, times, peak = time_paths(
            {"extract": functools.partial(extract, x, lx, cfg)},
            pncc_reps if family == "pncc13" else reps)
        print(f"families {name}: extract {ms['extract']:.3f} ms per batch "
              f"of {B} ragged (RTFx {audio / (ms['extract'] / 1e3):.0f}), "
              f"{'1 K1 launch' if kernel else 'no kernel'}, runs "
              f"{['%.3f' % t for t in times['extract']]}, peak memory "
              f"{peak['extract'] / 2**20:.0f} MiB [{card}]", flush=True)
    return errs


def pool_phase(streams: int, churn_ticks: int, churn: int, reset_counts,
               read_counts, card: str, device: str = "cuda") -> None:
    """``StreamPool`` over ``StreamingPipeline(KALDI39, cmvn="sliding")``
    with the fused flags at "highest": ``streams`` slots leased, then
    ``churn_ticks`` ticks of 100 ms chunks through ``process_batch``, each
    but the first detaching ``churn`` slots of the first half and leasing
    them again for new streams; each tick timed, then the bare pipeline
    step on the same blocks, then ten more ticks under torch.profiler for
    the device's idle share. The check runs the same schedule again beside
    an oracle, a pipeline of the same size whose recycled rows were fed
    zeros up to their last lease, and goes on without churn until every
    recycled slot is past its warmup_rows: the untouched slots equal the
    oracle bit for bit on every row, the recycled ones on every row past
    warmup_rows but those of the tick that crosses it, whose sliding-CMVN
    step also sums rows before it (held to TOL_STREAM)."""
    from tpufeat_torch import KALDI39, StreamingPipeline, streaming

    cfg = dataclasses.replace(KALDI39, cmvn="sliding",
                              **dict(FUSED, **HIGHEST))
    half = streams // 2

    def leased(k: int) -> list:
        """The slots tick k detaches and leases again."""
        if not 0 < k < churn_ticks:
            return []
        return [((k - 1) * churn + j) % half for j in range(churn)]

    def blocks(seed: int = 6):
        gen = torch.Generator(device=device).manual_seed(seed)
        while True:
            yield torch.randn(streams, CHUNK, generator=gen,
                              device=device) * 0.1

    def tick(pool, k, block):
        slots = leased(k)
        for s in slots:
            pool.detach(s)
        for _ in slots:
            pool.attach()
        return pool.process_batch(block)

    # the timed run: the pool's ticks, then the bare step on their blocks
    pool = streaming.StreamPool(StreamingPipeline(cfg, streams,
                                                  device=device))
    for _ in range(streams):
        pool.attach()
    feed = blocks()
    tick_ms = []
    reset_counts()
    for k in range(churn_ticks):
        block = next(feed)
        tick_ms.append(cuda_ms(functools.partial(tick, pool, k, block)))
    torch.cuda.synchronize()
    read_counts(f"pool, {churn_ticks} ticks of {streams} slots ({churn} "
                f"recycled a tick)", {"signal_features_mma": churn_ticks},
                highest=True)
    bare = StreamingPipeline(cfg, streams, device=device)
    feed = blocks()
    bare_ms = [cuda_ms(functools.partial(bare.process, next(feed)))
               for _ in range(churn_ticks)]
    budget_ms = 1e3 * CHUNK / SR
    t, b = statistics.median(tick_ms[1:]), statistics.median(bare_ms[1:])
    print(f"pool tick (detach + attach {churn} slots, process_batch): "
          f"median {t:.3f} ms for {streams} slots x {CHUNK} samples, "
          f"{100 * t / budget_ms:.2f} % of the {budget_ms:.0f} ms budget; "
          f"the bare pipeline step on the same blocks {b:.3f} ms; ticks "
          f"{['%.3f' % v for v in tick_ms]}, bare steps "
          f"{['%.3f' % v for v in bare_ms]} [{card}]")
    more = iter(range(churn_ticks, 10 ** 9))
    extra = blocks(60)
    wall, dev, idle = idle_share(
        lambda: tick(pool, 1 + next(more) % (churn_ticks - 1),
                     next(extra)), 10)
    print(f"pool tick under torch.profiler: wall {wall:.3f} ms, device "
          f"{dev:.3f} ms, idle share {idle:.3f} [{card}]")
    del pool, bare

    # the check: the same schedule beside the zeros-prefix oracle
    last = np.zeros(streams, np.int64)        # each slot's last lease
    for k in range(churn_ticks):
        last[leased(k)] = k
    pipe = StreamingPipeline(cfg, streams, device=device)
    pool = streaming.StreamPool(pipe)
    for _ in range(streams):
        pool.attach()
    oracle = StreamingPipeline(cfg, streams, device=device)
    warm = pipe.warmup_rows
    steady = -(-(warm + cfg.delta_order * cfg.delta_window)
               // (CHUNK // cfg.hop_length)) + 2
    untouched = torch.from_numpy(last == 0).to(device)
    feed = blocks()
    n_untouched = n_recycled = n_crossing = 0
    crossing_err = 0.0
    for k in range(churn_ticks + steady):
        block = next(feed)
        zblock = torch.where(torch.from_numpy(last > k).to(device)[:, None],
                             0.0, block)
        out, skips = tick(pool, k, block).block()
        want = oracle.process(zblock)
        n = out.shape[1]
        check(out.shape == want.shape, f"pool tick {k} shape")
        if n == 0:
            continue
        check(torch.equal(out[untouched], want[untouched]),
              f"pool tick {k}: an untouched slot differs from the oracle")
        n_untouched += int(untouched.sum()) * n
        skip = torch.tensor([skips[s] for s in range(streams)],
                            device=device)
        mine = ~untouched & torch.from_numpy(last <= k).to(device)
        whole = mine & (skip == 0)
        check(torch.equal(out[whole], want[whole]),
              f"pool tick {k}: a recycled slot past its warmup differs "
              f"from the zeros-prefix oracle")
        n_recycled += int(whole.sum()) * n
        for s in torch.nonzero(mine & (skip > 0) & (skip < n)).flatten():
            s = int(s)
            n_crossing += n - skips[s]
            crossing_err = max(crossing_err, scaled_err(
                out[s, skips[s]:], want[s, skips[s]:])[1])
    torch.cuda.synchronize()
    recycled = int((last > 0).sum())
    print(f"pool check, the same {churn_ticks} ticks then {steady} without "
          f"churn: {int(untouched.sum())} untouched slots bit-identical to "
          f"the oracle on {n_untouched} rows; {recycled} recycled slots "
          f"bit-identical to the zeros-prefix oracle on {n_recycled} rows "
          f"past warmup_rows ({warm}); {n_crossing} rows of the crossing "
          f"ticks within {crossing_err:.3e} scaled (limit {TOL_STREAM}) "
          f"[{card}]")
    check(n_recycled >= recycled * 10, f"pool: only {n_recycled} recycled "
          f"rows were checked")
    check(crossing_err <= TOL_STREAM,
          f"pool crossing rows {crossing_err:.3e}")


RATE_IN, CHUNK48 = 48000, 4800     # 100 ms of a 48 kHz capture


def voiced(rows: int, n: int, seed: int, device: str,
           rate: int = RATE_IN) -> torch.Tensor:
    """[rows, n] voiced audio at ``rate``: a tone per row (f0 uniform in
    90-300 Hz), its second harmonic and noise, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f0 = 90.0 + 210.0 * torch.rand(rows, 1, generator=gen, device=device)
    ph = (2 * np.pi / rate) * f0 * torch.arange(n, device=device)
    x = 0.3 * torch.sin(ph)
    x += 0.1 * torch.sin(2 * ph + 0.3)
    del ph
    return x + 0.02 * torch.randn(rows, n, generator=gen, device=device)


def rate_pitch_phase(reset_counts, read_counts, card: str,
                     device: str = "cuda", streams: int = STREAMS,
                     steps: int = 30, batch: int = BATCH,
                     seconds: int = SECONDS, pool_ticks: int = 20,
                     churn: int = 256, reps: int = STEP_REPS,
                     pitch_reps: int = 3, cpu_rows: int = 8) -> dict:
    """Kaldi's online nnet3 front-end on 48 kHz capture:
    ``StreamingPipeline(KALDI39 with the fused flags at "highest",
    cmvn="sliding", input_rate=48000, pitch=True, pitch_lookahead=15)`` on
    ``streams`` streams of ``steps`` 100 ms chunks: its K1 launches (one a
    step), its rows (39 spectral and 3 pitch columns) bit for bit against
    the same pipeline fed the offline ``resample`` of the streams in the
    chunks the resampler gave, the spectral columns against the offline
    ``extract`` of that signal, the pitch columns of ``cpu_rows`` streams
    against the CPU run of the same pipeline; the step timed (median), its
    device time and idle share under torch.profiler, and the resampler's
    and the pitch tracker's steps alone. Offline, ``batch`` x ``seconds``
    ragged at 48 kHz: ``resample`` to 16 kHz (against scipy on two rows,
    its bound the bytes over the memory rate, the
    peak memory), ``extract`` (K1 against its twin by
    ``tolerance.compare_to_twin``) and ``pitch_features`` (against the
    float64 golden on row 0, 30 s, and the shortest row: hz within rtol
    1e-6 and POV within 1e-4 on the frames the golden calls voiced, POV >
    0.5; its Viterbi loops timed apart). Then ``StreamPool`` over the
    pipeline, ``churn`` slots recycled a tick for ``pool_ticks`` ticks:
    untouched and recycled slots bit for bit against a pipeline fed zeros
    before each lease and reset at the same ticks. Returns K1's largest error against its twin."""
    import scipy.signal

    from tpufeat_torch import KALDI39, StreamingPipeline, extract
    from tpufeat_torch import framing, pitch, resampling, streaming
    from tpufeat_torch.kernels import signal
    from tpufeat_torch.kernels import _tolerance as tolerance
    from tpufeat_torch.reference import cpu

    cfg = dataclasses.replace(KALDI39, cmvn="sliding",
                              **dict(FUSED, **HIGHEST))
    K = 15
    budget_ms = 1e3 * CHUNK48 / RATE_IN
    base = dataclasses.replace(cfg, deltas=False, cmvn="none")
    pcfg = pitch.config_for(base)

    def pipeline():
        return StreamingPipeline(cfg, streams, pitch=True,
                                 pitch_lookahead=K, input_rate=RATE_IN,
                                 device=device)

    # online: the main path, its K1 launches and its bits
    x48 = voiced(streams, steps * CHUNK48, 48, device)
    pipe = pipeline()
    sizes = []
    native = pipe._process_native
    pipe._process_native = lambda c: sizes.append(c.shape[1]) or native(c)
    reset_counts()
    outs = [pipe.process(x48[:, k * CHUNK48:(k + 1) * CHUNK48])
            for k in range(steps)]
    torch.cuda.synchronize()
    read_counts(f"rate_pitch StreamingPipeline.process ({streams} streams "
                f"x {steps} steps of {CHUNK48} samples at 48 kHz)",
                {"signal_features_mma": steps}, highest=True)
    outs.append(pipe.flush())
    out = torch.cat(outs, dim=1)
    del outs, pipe
    n16 = resampling.output_length(steps * CHUNK48, 1, 3)
    Fp = pcfg.num_frames(n16)
    check(out.shape == (streams, Fp, 42),
          f"rate_pitch rows {tuple(out.shape)}, want {(streams, Fp, 42)}")
    check(bool(torch.isfinite(out).all()), "rate_pitch rows finite")
    check(sum(sizes) == n16, f"rate_pitch resampled {sum(sizes)} samples")
    x16 = resampling.resample(x48, RATE_IN, 16000)
    twin = StreamingPipeline(cfg, streams, pitch=True, pitch_lookahead=K,
                             device=device)
    pos, fed = 0, []
    for c in sizes[:-1]:
        fed.append(twin.process(x16[:, pos:pos + c]))
        pos += c
    fed.append(twin.process(x16[:, pos:]))
    fed.append(twin.flush())
    fed = torch.cat(fed, dim=1)
    torch.cuda.synchronize()
    check(torch.equal(out, fed), "rate_pitch rows != the pipeline fed the "
          "offline-resampled signal")
    del twin, fed
    one = extract(x16, cfg=cfg).features[:, :Fp]
    err, rel = scaled_err(out[..., :39], one)
    print(f"rate_pitch StreamingPipeline S={streams} x {steps} steps of "
          f"{CHUNK48} samples at 48 kHz (resampled chunks "
          f"{sorted(set(sizes))}): every row bit-identical to the same "
          f"pipeline fed resample() of the streams; spectral columns vs "
          f"offline extract: max_abs_err={err:.3e} scaled={rel:.3e} "
          f"(limit {TOL_KERNEL}) [{card}]")
    check(rel <= TOL_KERNEL, f"rate_pitch spectral vs offline {rel:.3e}")
    del one
    # the pitch columns of a few streams against the CPU run
    sub = x48[:cpu_rows].cpu()
    cpipe = StreamingPipeline(cfg, cpu_rows, pitch=True, pitch_lookahead=K,
                              input_rate=RATE_IN, device="cpu")
    want = torch.cat([cpipe.process(sub[:, k * CHUNK48:(k + 1) * CHUNK48])
                      for k in range(steps)] + [cpipe.flush()], dim=1)
    got = out[:cpu_rows].cpu()
    same = (got[..., 39] - want[..., 39]).abs() < 1e-4   # POV: the lag
    gap = (got[..., 39:][same] - want[..., 39:][same]).abs().max().item()
    print(f"rate_pitch pitch columns of {cpu_rows} streams vs the CPU run: "
          f"{int((~same).sum())} of {same.numel()} rows with another lag; "
          f"the others within {gap:.3e} (limit 1e-3, the running mean's "
          f"column) [{card}]")
    check(int((~same).sum()) <= same.numel() // 1000,
          "rate_pitch: the card's pitch decisions differ from the CPU's")
    check(gap <= 1e-3, f"rate_pitch pitch columns vs CPU {gap:.3e}")
    del out, got, want, cpipe

    # the steady step, and its parts alone
    pipe = pipeline()
    chunks = [x48[:, k * CHUNK48:(k + 1) * CHUNK48].contiguous()
              for k in range(steps)]
    warm = -(-(cfg.cmvn_min_window + 2 * cfg.delta_order * cfg.delta_window
               + K + 2 * pcfg.delta_window) * cfg.hop_length * 3
             // CHUNK48) + 1
    for chunk in chunks[:warm]:
        pipe.process(chunk)
    feed = itertools.cycle(chunks[warm:])
    check(pipe.process(next(feed)).shape[1] > 0, "rate_pitch emits")
    rs = resampling.StreamingResampler(RATE_IN, 16000, streams, device)
    pf = pitch.StreamingPitchFeatures(pcfg, streams, K, device)
    c16 = x16[:, :1600].contiguous()
    ms, times, peak = time_paths({
        "step": lambda: pipe.process(next(feed)),
        "resampler_only": lambda: rs.process(chunks[0]),
        "pitch_only": lambda: pf.process(c16)}, reps)
    wall, dev, idle = idle_share(lambda: pipe.process(next(feed)), 10)
    n_step, _ = device_launches(lambda: pipe.process(next(feed)))
    n_pitch, _ = device_launches(lambda: pf.process(c16))
    print(f"rate_pitch step: median {ms['step']:.3f} ms per step of "
          f"{streams} streams x {CHUNK48} samples at 48 kHz, "
          f"{100 * ms['step'] / budget_ms:.2f} % of the {budget_ms:.0f} ms "
          f"budget; resampler alone {ms['resampler_only']:.3f} ms "
          f"({100 * ms['resampler_only'] / ms['step']:.1f} %), pitch "
          f"tracker alone {ms['pitch_only']:.3f} ms "
          f"({100 * ms['pitch_only'] / ms['step']:.1f} %); runs "
          f"{['%.3f' % t for t in times['step']]}; peak memory "
          f"{peak['step'] / 2**20:.0f} MiB; under torch.profiler wall "
          f"{wall:.3f} ms, device {dev:.3f} ms, idle share {idle:.3f}; "
          f"{n_step} device launches a step, {n_pitch} of them the pitch "
          f"tracker's [{card}]")
    del pipe, rs, pf, chunks, feed, x48, x16, c16

    # offline: B x seconds ragged at 48 kHz
    n48 = seconds * RATE_IN
    l48 = ragged_lengths(n48, batch)
    x48 = voiced(batch, n48, 39, device)
    x48 = x48 * (torch.arange(n48, device=device)[None, :]
                 < torch.from_numpy(l48).to(device)[:, None])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.max_memory_allocated()
    x16 = resampling.resample(x48, RATE_IN, 16000)
    torch.cuda.synchronize()
    rs_peak = torch.cuda.max_memory_allocated() - base_mem
    l16 = torch.from_numpy(np.array([resampling.output_length(int(n), 1, 3)
                                     for n in l48], np.int32)).to(device)
    worst = 0.0
    golden = (0, int(np.argmin(l48)))       # 30 s, and the shortest row
    for b in golden:
        want = scipy.signal.resample_poly(
            x48[b, :l48[b]].double().cpu().numpy(), 1, 3)
        got = x16[b, :len(want)].double().cpu().numpy()
        worst = max(worst, np.abs(got - want).max()
                    / max(1.0, np.abs(want).max()))
    check(worst < 2e-5, f"rate_pitch resample vs scipy {worst:.3e}")
    reset_counts()
    res = extract(x16, l16, cfg)
    torch.cuda.synchronize()
    read_counts(f"rate_pitch offline extract (B={batch} x {seconds} s "
                f"resampled)", {"signal_features_mma": 1}, highest=True)
    check(bool(torch.isfinite(res.features[res.mask]).all()),
          "rate_pitch offline extract finite")
    xx = framing.preemphasize(x16, cfg.preemphasis)
    buf = framing.framing_buffer(xx, l16, cfg)[0].contiguous()
    F = cfg.num_frames(x16.shape[1])
    a = tolerance.compare_to_twin(
        signal.signal_features(buf, F, cfg),
        signal.signal_features_reference(buf, F, cfg),
        framing.frames_from_buffer(buf, F, cfg.frame_length,
                                   cfg.hop_length),
        cfg, what="rate_pitch K1")
    print(f"rate_pitch offline K1 vs twin at these shapes max_abs_err="
          f"{a.max_abs_err:.3e} scaled={a.scaled:.3e}")
    del res, xx, buf
    feats, valid = pitch.pitch_features(x16, l16, pcfg)
    torch.cuda.synchronize()
    check(feats.shape == (batch, pcfg.num_frames(x16.shape[1]), 3),
          f"rate_pitch pitch_features {tuple(feats.shape)}")
    check(bool(torch.isfinite(feats[valid]).all()), "pitch finite")
    n_strong = n_off = 0
    pov_gap = 0.0
    for b in golden:
        n = int(l16[b])
        ghz, gpov = cpu.pitch(x16[b, :n].double().cpu().numpy(), pcfg)
        hz, pov, _ = pitch.track(x16[b:b + 1, :n], cfg=pcfg)
        hz, pov = hz[0].cpu().numpy(), pov[0].cpu().numpy()
        strong = gpov > 0.5
        n_strong += int(strong.sum())
        n_off += int((np.abs(hz[strong] / ghz[strong] - 1) > 1e-6).sum())
        pov_gap = max(pov_gap, float(np.abs(pov[strong]
                                            - gpov[strong]).max()))
    print(f"rate_pitch pitch vs the float64 golden on rows {golden}: "
          f"{n_off} of {n_strong} voiced frames (golden POV > 0.5) past hz "
          f"rtol 1e-6; POV within {pov_gap:.3e} there (limit 1e-4) [{card}]")
    check(n_off == 0, "rate_pitch pitch decisions differ from the golden")
    check(pov_gap <= 1e-4, f"rate_pitch POV vs golden {pov_gap:.3e}")
    sig16, lens16, inner = pitch.to_lag_grid(x16, l16, pcfg)
    scores, vgrid = pitch.nccf(sig16, lens16, inner)
    shaped = scores - pitch._lag_tilt(inner, scores.device)
    trans = torch.as_tensor(pitch._transition_matrix(inner), device=device)
    audio = float(l48.sum()) / RATE_IN
    ms, times, peak = time_paths({
        "resample": lambda: resampling.resample(x48, RATE_IN, 16000),
        "extract": lambda: extract(x16, l16, cfg),
        "pitch_features": lambda: pitch.pitch_features(x16, l16, pcfg),
        "viterbi": lambda: pitch._viterbi(shaped, vgrid, trans)},
        pitch_reps)
    b_ms, _ = bound({}, nbytes(x48, x16))
    n_vit, vit_dev = device_launches(
        lambda: pitch._viterbi(shaped, vgrid, trans))
    print(f"rate_pitch offline B={batch} x {seconds} s ragged at 48 kHz "
          f"({audio:.0f} s of audio): resample {ms['resample']:.3f} ms "
          f"(bound {b_ms:.3f} ms, bytes; {100 * b_ms / ms['resample']:.1f} "
          f"% of it; max {worst:.3e} from scipy; peak memory "
          f"{rs_peak / 2**20:.0f} MiB above its input), extract "
          f"{ms['extract']:.3f} ms, pitch_features "
          f"{ms['pitch_features']:.3f} ms, of which the Viterbi loops "
          f"{ms['viterbi']:.3f} ms over {scores.shape[1]} frames "
          f"({(scores.shape[1] - 1) * 2} steps, {n_vit} device launches, "
          f"{vit_dev:.3f} ms of device time); runs "
          f"{ {k: ['%.3f' % t for t in v] for k, v in times.items()} } "
          f"[{card}]")
    check(rs_peak < 15 * 2**30 // 10, f"rate_pitch resample peak "
          f"{rs_peak / 2**30:.2f} GiB")
    del x48, x16, scores, shaped, feats, valid, sig16

    # the pool: churn slots recycled a tick, against a zero-fed oracle
    half = streams // 2

    def leased(k):
        return [((k - 1) * churn + j) % half for j in range(churn)] \
            if 0 < k < pool_ticks else []
    last = np.zeros(streams, np.int64)
    for k in range(pool_ticks):
        last[leased(k)] = k
    xp = voiced(streams, pool_ticks * CHUNK48, 61, device)
    pool = streaming.StreamPool(pipeline())
    for _ in range(streams):
        pool.attach()
    got = []
    reset_counts()
    for k in range(pool_ticks):
        for s in leased(k):
            pool.detach(s)
        for _ in leased(k):
            pool.attach()
        got.append(pool.process_batch(
            xp[:, k * CHUNK48:(k + 1) * CHUNK48]).block()[0])
    torch.cuda.synchronize()
    read_counts(f"rate_pitch pool, {pool_ticks} ticks of {streams} slots "
                f"({churn} recycled a tick)",
                {"signal_features_mma": pool_ticks}, highest=True)
    del pool
    oracle = pipeline()
    untouched = torch.from_numpy(last == 0).to(device)
    rows_u = rows_r = 0
    for k in range(pool_ticks):
        oracle.reset_rows(leased(k))
        zero = torch.from_numpy(last > k).to(device)[:, None]
        want = oracle.process(torch.where(
            zero, 0.0, xp[:, k * CHUNK48:(k + 1) * CHUNK48]))
        check(got[k].shape == want.shape, f"pool tick {k} shape")
        mine = ~untouched & torch.from_numpy(last <= k).to(device)
        check(torch.equal(got[k][untouched], want[untouched]),
              f"rate_pitch pool tick {k}: an untouched slot differs")
        check(torch.equal(got[k][mine], want[mine]),
              f"rate_pitch pool tick {k}: a recycled slot differs")
        rows_u += int(untouched.sum()) * want.shape[1]
        rows_r += int(mine.sum()) * want.shape[1]
    print(f"rate_pitch pool: {int(untouched.sum())} untouched slots bit for "
          f"bit on {rows_u} rows, {int((last > 0).sum())} recycled slots "
          f"bit for bit on {rows_r} rows against a pipeline fed zeros "
          f"before each lease and reset at the same ticks [{card}]")
    check(rows_r > 0, "rate_pitch pool checked no recycled row")
    return {"signal_mma_highest": a.max_abs_err}


def agreement(labels: np.ndarray, truth: np.ndarray) -> float:
    """The share of frames whose label maps to their true speaker under
    the best one-to-one map of labels to speakers."""
    from scipy.optimize import linear_sum_assignment
    _, li = np.unique(labels, return_inverse=True)
    _, ti = np.unique(truth, return_inverse=True)
    conf = np.zeros((li.max() + 1, ti.max() + 1))
    np.add.at(conf, (li, ti), 1)
    r, c = linear_sum_assignment(-conf)
    return float(conf[r, c].sum() / len(truth))


def turns(frames: int, speakers: int, seed: int) -> np.ndarray:
    """[frames] speaker ids of one recording: turns of 3-15 s (300-1500
    frames), each by a speaker other than the last (seeded)."""
    rng = np.random.default_rng(seed)
    truth = np.empty(frames, np.int64)
    pos, spk = 0, int(rng.integers(speakers))
    while pos < frames:
        n = int(rng.integers(300, 1500))
        truth[pos:pos + n] = spk
        pos += n
        spk = (spk + int(rng.integers(1, speakers))) % speakers
    return truth


def speaker_frames(ext, voices: np.ndarray, truth: np.ndarray,
                   seed: int) -> np.ndarray:
    """[T, D] float32 frames drawn from the extractor's own generative
    model for the speakers ``truth`` [T] names: x = mu_g + M_g w_s +
    sigma_g e, g from the UBM's weights, w_s = ``voices[s]`` (draws of
    N(0, I)); seeded."""
    rng = np.random.default_rng(seed)
    G, D, K = ext.M.shape
    offs = np.einsum("gdk,sk->sgd", ext.M, voices)
    g = rng.choice(G, size=truth.size, p=ext.ubm.weights)
    return (ext.ubm.means[g] + offs[truth, g] + np.sqrt(ext.ubm.vars[g])
            * rng.standard_normal((truth.size, D))).astype(np.float32)


def generator_world(ivector, plda, device: str, num_gauss: int,
                    ivector_dim: int, speakers: int = 24):
    """``benchmarks/experiments/diarize_long_bench.py``'s world (copied: this
    script imports nothing of the JAX package): 32 acoustic states shared
    by every speaker in a 13-dim space plus a small per-speaker shift of
    every state, a UBM, extractor and PLDA trained as the generator trains
    them (``speakers`` x 4000 frames; 40 utterances of 150 frames a
    speaker; EM on ``device``). Returns (extractor, PLDA, draw, the
    separation line: same- and different-speaker score medians over the
    training i-vectors and the share of different-speaker scores above
    the same-speaker median)."""
    D, P = 13, 32
    r = np.random.default_rng(0)
    phones = r.standard_normal((P, D)) * 4.0      # shared acoustic states
    offs = r.standard_normal((speakers, D)) * 1.0  # per-speaker shift

    def draw(spk, n, s):
        rr = np.random.default_rng(s)
        z = rr.integers(0, P, n)
        return (phones[z] + offs[spk]
                + 0.8 * rr.standard_normal((n, D))).astype(np.float32)

    frames = np.concatenate([draw(s, 4000, 100 + s)
                             for s in range(speakers)])
    ubm = ivector.train_diag_ubm(frames, num_gauss, iters=2, final_iters=3,
                                 seed=0, device=device)
    utts = np.stack([draw(s, 150, 200 + 10 * s + u)
                     for s in range(speakers) for u in range(40)])
    ids = np.repeat(np.arange(speakers), 40)
    ext = ivector.train_ivector_extractor(ubm, utts, ivector_dim=ivector_dim,
                                          iters=3, seed=1, device=device)
    ivs = ivector.utterance_ivector(ext, utts, device=device)
    ivs = ivs.double().cpu().numpy()
    model = plda.train_plda(ivs, ids, iters=5)
    S = model.score_host(ivs, ivs)
    same = S[ids[:, None] == ids[None, :]]
    diff = S[ids[:, None] != ids[None, :]]
    sep = (f"same-speaker median {np.median(same):.1f}, different "
           f"{np.median(diff):.1f}, overlap "
           f"{(diff > np.median(same)).mean():.4f}")
    return ext, model, draw, sep


def generator_recording(draw, frames: int, speakers: int = 6,
                        seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """The generator's recording: turns of 300-1500 frames (3-15 s), each by
    one of the first ``speakers`` speakers -> (feats [T, 13], truth [T])."""
    rr = np.random.default_rng(seed)
    parts, truth, t, i = [], [], 0, 0
    while t < frames:
        s = int(rr.integers(0, speakers))
        n = min(int(rr.integers(300, 1500)), frames - t)
        parts.append(draw(s, n, 5000 + i))
        truth.append(np.full(n, s))
        t, i = t + n, i + 1
    return np.concatenate(parts), np.concatenate(truth)


def speaker_phase(sig: np.ndarray, reset_counts, read_counts, card: str,
                  device: str = "cuda", streams: int = STREAMS,
                  steps: int = 30, num_gauss: int = 512,
                  ivector_dim: int = 100, pool_ticks: int = 20,
                  churn_ticks: int = 10, churn: int = 256,
                  reps: int = STEP_REPS, offline_reps: int = 3,
                  cpu_rows: int = 4, golden_frames: int = 300,
                  world_minutes: float = 30, long_hours: float = 3,
                  plda_speakers: int = 24, diar_chunk: int = 1000,
                  generator_hours: float = 3,
                  generator_slice_minutes: float = 30,
                  generator_block: int = 512) -> None:
    """The speaker stack at Kaldi's width (``run_ivector_common.sh``: a
    ``num_gauss`` UBM, ``ivector_dim`` i-vectors, period 10, posterior
    scale 0.1), trained on the card from the kaldi39 batch ``sig``:
    ``train_diag_ubm`` over its base MFCC-13 rows (K1 at "highest", ragged
    lengths) and ``train_ivector_extractor`` (2 iterations) over the
    batch, timed. Online: ``StreamingPipeline(KALDI39 with the fused flags
    at "highest", cmvn="sliding", pitch=True, ivector=)`` on ``streams``
    voiced streams of ``steps`` 100 ms chunks — Kaldi nnet3-online's
    [39 | 3 | K] rows — its K1 launches (one a step), its spectral and
    pitch columns bit for bit against the same pipeline without
    ``ivector=``, its i-vector columns within 1e-4 of ``ivector_features``
    of the base rows (``extract_scan``); the step timed (median), beside
    ``StreamingIvector`` alone, its idle share, device launches and peak
    memory; a ``StreamPool`` over it, ``churn`` slots recycled a tick for
    ``churn_ticks`` of ``pool_ticks`` ticks, recycled and untouched slots
    bit for bit against a pipeline fed zeros before each lease and reset
    at the same ticks. Offline on the batch: ``utterance_ivector`` (against
    the CPU on ``cpu_rows`` rows), ``ivector_features`` (against the
    float64 golden on ``golden_frames`` frames of row 0) and
    ``fmllr_stats`` + ``estimate_fmllr`` over the batch as one speaker,
    timed. Diarization on ``world_minutes`` of frames drawn from the
    extractor's own model (4 speakers in 3-15 s turns), with a PLDA
    trained on a seeded ``plda_speakers``-speaker world of 1.5 s
    utterances whose first 4 speakers are the recording's
    (``tests/test_diarize.py``'s arrangement): ``segment_ivectors``
    (against the CPU), ``plda_affinity`` on the device and on the host, ``diarize`` (labels against the CPU's)
    and ``StreamingDiarizer`` fed ``diar_chunk``-frame chunks, each timed
    with its frame agreement against the truth, and ``diarize_long`` over
    ``long_hours`` hours (0 leaves it out). Then ``diarize_long`` on the
    reference's own long-form world (:func:`generator_world`, trained on
    the card at ``num_gauss`` / ``ivector_dim``): ``generator_hours`` of its
    6-speaker recording on the card, timed, with its frame agreement, and
    its first ``generator_slice_minutes`` (at least 4 blocks of
    ``generator_block`` windows) on the card and on the CPU, whose labels
    must agree on 0.99 of the frames (ROADMAP queue 3, item 2)."""
    import time

    from tpufeat_torch import KALDI39, StreamingPipeline, extract
    from tpufeat_torch import diarization, fmllr, ivector, pitch, plda
    from tpufeat_torch import streaming
    from tpufeat_torch.reference import cpu

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(KALDI39, cmvn="sliding",
                              **dict(FUSED, **HIGHEST))
    base_cfg = dataclasses.replace(cfg, deltas=False, cmvn="none")
    pcfg = pitch.config_for(base_cfg)
    B, n = sig.shape
    lengths = ragged_lengths(n, B)
    K = ivector_dim

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the training data: the base rows of the kaldi39 batch
    reset_counts()
    res = extract(torch.from_numpy(sig).to(device),
                  torch.from_numpy(lengths).to(device), base_cfg)
    torch.cuda.synchronize()
    read_counts(f"speaker base rows (extract, B={B} ragged)",
                {"signal_features_mma": 1}, highest=True)
    feats, valid, nf = res.features, res.mask, res.num_frames
    frames = feats[valid]
    ubm, ubm_s = clock(lambda: ivector.train_diag_ubm(frames, num_gauss,
                                                      seed=0))
    (ext, objs), ext_s = clock(lambda: ivector.train_ivector_extractor(
        ubm, feats, nf.cpu().numpy(), ivector_dim=K, iters=2, seed=0,
        return_objective=True))
    print(f"speaker training: train_diag_ubm(num_gauss={num_gauss}) over "
          f"{frames.shape[0]} base MFCC-13 rows of the kaldi39 batch in "
          f"{ubm_s:.2f} s (average log-likelihood "
          f"{ivector.avg_log_like(ubm, frames):.4f}); "
          f"train_ivector_extractor(ivector_dim={K}, iters=2) over the "
          f"B={B} ragged batch in {ext_s:.2f} s (EM objectives "
          f"{['%.6g' % o for o in objs]}) [{card}]")
    check(bool(np.isfinite(objs).all()), "speaker extractor EM objective")

    # online: the main path, its K1 launches, its columns
    x16 = voiced(streams, steps * CHUNK, 16, device, rate=SR)

    def pipeline(**kw):
        return StreamingPipeline(cfg, streams, pitch=True, device=device,
                                 **kw)
    pipe = pipeline(ivector=ext)
    reset_counts()
    outs = [pipe.process(x16[:, k * CHUNK:(k + 1) * CHUNK])
            for k in range(steps)]
    torch.cuda.synchronize()
    read_counts(f"speaker StreamingPipeline.process (pitch, i-vectors; "
                f"{streams} streams x {steps} steps of {CHUNK} samples)",
                {"signal_features_mma": steps}, highest=True)
    outs.append(pipe.flush())
    out = torch.cat(outs, dim=1)
    del outs, pipe
    Fp = pcfg.num_frames(steps * CHUNK)
    check(out.shape == (streams, Fp, 42 + K),
          f"speaker rows {tuple(out.shape)}, want {(streams, Fp, 42 + K)}")
    check(bool(torch.isfinite(out).all()), "speaker rows finite")
    plain = pipeline()
    pos = 0
    for k in range(steps + 1):
        o = plain.process(x16[:, k * CHUNK:(k + 1) * CHUNK]) \
            if k < steps else plain.flush()
        check(torch.equal(o, out[:, pos:pos + o.shape[1], :42]),
              f"speaker step {k}: spectral/pitch columns differ from the "
              "pipeline without ivector=")
        pos += o.shape[1]
    check(pos == Fp, "speaker rows of the pipeline without ivector=")
    del plain
    worst = 0.0
    for s0 in range(0, streams, STREAM_BLOCK):
        base = streaming.extract_scan(x16[s0:s0 + STREAM_BLOCK], base_cfg,
                                      CHUNK)
        want = ivector.ivector_features(ext, base)[:, :Fp]
        worst = max(worst, scaled_err(out[s0:s0 + STREAM_BLOCK, :, 42:],
                                      want)[1])
        del base, want
    print(f"speaker StreamingPipeline S={streams} x {steps} steps of "
          f"{CHUNK} samples: {Fp} rows of {42 + K} columns; spectral and "
          f"pitch columns bit-identical to the pipeline without ivector=; "
          f"i-vector columns vs ivector_features of extract_scan's base "
          f"rows: scaled {worst:.3e} (limit {TOL_IVECTOR}) [{card}]")
    check(worst <= TOL_IVECTOR, f"speaker i-vector columns {worst:.3e}")
    del out

    # the steady step, and StreamingIvector alone
    pipe = pipeline(ivector=ext)
    chunks = [x16[:, k * CHUNK:(k + 1) * CHUNK].contiguous()
              for k in range(steps)]
    warm = -(-(cfg.cmvn_min_window + 2 * cfg.delta_order * cfg.delta_window
               + 15 + 2 * pcfg.delta_window) * cfg.hop_length
             // CHUNK) + 1
    for chunk in chunks[:warm]:
        pipe.process(chunk)
    feed = itertools.cycle(chunks[warm:])
    check(pipe.process(next(feed)).shape[1] > 0, "speaker step emits")
    per = CHUNK // cfg.hop_length
    rows10 = frames[:streams * per].reshape(streams, per, -1).contiguous()
    siv = ivector.StreamingIvector(ext, streams, device=device)
    ms, times, peak = time_paths({
        "step": lambda: pipe.process(next(feed)),
        "ivector_only": lambda: siv.process(rows10)}, reps)
    wall, dev, idle = idle_share(lambda: pipe.process(next(feed)), 10)
    n_step, _ = device_launches(lambda: pipe.process(next(feed)))
    n_iv, iv_dev = device_launches(lambda: siv.process(rows10))
    iv_top = top_kernels(lambda: siv.process(rows10))
    siv.check()
    budget_ms = 1e3 * CHUNK / SR
    print(f"speaker step: median {ms['step']:.3f} ms per step of {streams} "
          f"streams x {CHUNK} samples ({42 + K}-dim rows), "
          f"{100 * ms['step'] / budget_ms:.2f} % of the {budget_ms:.0f} ms "
          f"budget; StreamingIvector alone {ms['ivector_only']:.3f} ms "
          f"({100 * ms['ivector_only'] / ms['step']:.1f} %, {n_iv} device "
          f"launches, {iv_dev:.3f} ms of device time); runs "
          f"{['%.3f' % t for t in times['step']]}; peak memory "
          f"{peak['step'] / 2**20:.0f} MiB (StreamingIvector alone "
          f"{peak['ivector_only'] / 2**20:.0f} MiB); under torch.profiler "
          f"wall {wall:.3f} ms, device {dev:.3f} ms, idle share "
          f"{idle:.3f}; {n_step} device launches a step; StreamingIvector's "
          f"largest device kernels: {iv_top} [{card}]")
    del pipe, chunks, feed, siv, x16

    # the pool: churn slots recycled a tick, against a zero-fed oracle
    half = streams // 2

    def leased(k):
        return [((k - 1) * churn + j) % half for j in range(churn)] \
            if 0 < k <= churn_ticks else []
    last = np.zeros(streams, np.int64)
    for k in range(pool_ticks):
        last[leased(k)] = k
    xp = voiced(streams, pool_ticks * CHUNK, 61, device, rate=SR)
    pool = streaming.StreamPool(pipeline(ivector=ext))
    for _ in range(streams):
        pool.attach()
    got = []
    reset_counts()
    for k in range(pool_ticks):
        for s in leased(k):
            pool.detach(s)
        for _ in leased(k):
            pool.attach()
        got.append(pool.process_batch(
            xp[:, k * CHUNK:(k + 1) * CHUNK]).block()[0])
    torch.cuda.synchronize()
    read_counts(f"speaker pool, {pool_ticks} ticks of {streams} slots "
                f"({churn} recycled a tick for {churn_ticks} ticks)",
                {"signal_features_mma": pool_ticks}, highest=True)
    del pool
    oracle = pipeline(ivector=ext)
    untouched = torch.from_numpy(last == 0).to(device)
    rows_u = rows_r = 0
    for k in range(pool_ticks):
        oracle.reset_rows(leased(k))
        zero = torch.from_numpy(last > k).to(device)[:, None]
        want = oracle.process(torch.where(
            zero, 0.0, xp[:, k * CHUNK:(k + 1) * CHUNK]))
        check(got[k].shape == want.shape, f"speaker pool tick {k} shape")
        mine = ~untouched & torch.from_numpy(last <= k).to(device)
        check(torch.equal(got[k][untouched], want[untouched]),
              f"speaker pool tick {k}: an untouched slot differs")
        check(torch.equal(got[k][mine], want[mine]),
              f"speaker pool tick {k}: a recycled slot differs")
        rows_u += int(untouched.sum()) * want.shape[1]
        rows_r += int(mine.sum()) * want.shape[1]
    print(f"speaker pool: {int(untouched.sum())} untouched slots bit for "
          f"bit on {rows_u} rows, {int((last > 0).sum())} recycled slots "
          f"bit for bit on {rows_r} rows against a pipeline fed zeros "
          f"before each lease and reset at the same ticks [{card}]")
    check(rows_r > 0, "speaker pool checked no recycled row")
    del oracle, got, xp

    # offline: the batch's utterance i-vectors, online i-vectors, fMLLR
    mask = valid.float()
    reset_counts()
    utt = ivector.utterance_ivector(ext, feats, mask)
    ivf = ivector.ivector_features(ext, feats, lengths=nf)
    stats = fmllr.fmllr_stats(ubm, feats, nf)
    torch.cuda.synchronize()
    read_counts("speaker offline (utterance_ivector, ivector_features, "
                "fmllr_stats)", {})
    W, est_s = clock(lambda: fmllr.estimate_fmllr(*stats))
    ivf_top = top_kernels(lambda: ivector.ivector_features(ext, feats,
                                                           lengths=nf))
    check(bool(np.isfinite(W).all()), "speaker fMLLR transform finite")
    want = ivector.utterance_ivector(ext, feats[:cpu_rows].cpu(),
                                     mask[:cpu_rows].cpu(), device="cpu")
    gap = (utt[:cpu_rows].cpu() - want).abs()
    ok = bool((gap <= 2e-4 + 1e-3 * want.abs()).all())
    gw = cpu.ivector_features(
        feats[0, :golden_frames].double().cpu().numpy(), ubm.weights,
        ubm.means, ubm.vars, ext.M, period=10, posterior_scale=0.1)
    g_err, g_rel = scaled_err(ivf[0, :golden_frames],
                              torch.from_numpy(gw).to(device))
    solves = B * -(-feats.shape[1] // 10)
    audio = float(lengths.sum()) / SR

    def operand_upload():
        """The extractor's operands made and uploaded again: the cost the
        per-device cache saves each call."""
        ext.__dict__.pop("_device_cache")
        return ext.device_operands(device)
    ms, times, peak = time_paths({
        "operand_upload": operand_upload,
        "utterance_ivector": lambda: ivector.utterance_ivector(ext, feats,
                                                               mask),
        "ivector_features": lambda: ivector.ivector_features(ext, feats,
                                                             lengths=nf),
        "fmllr_stats": lambda: fmllr.fmllr_stats(ubm, feats, nf)},
        offline_reps)
    print(f"speaker offline B={B} x {n / SR:.0f} s ragged ({audio:.0f} s "
          f"of audio): utterance_ivector {ms['utterance_ivector']:.3f} ms "
          f"(RTFx {audio / (ms['utterance_ivector'] / 1e3):.0f}; {cpu_rows} "
          f"rows vs the CPU: max gap {gap.max().item():.3e}, limit atol "
          f"2e-4 + rtol 1e-3), ivector_features "
          f"{ms['ivector_features']:.3f} ms ({solves} solves; peak memory "
          f"{peak['ivector_features'] / 2**20:.0f} MiB; vs the float64 "
          f"golden on {golden_frames} frames: scaled {g_rel:.3e}, limit "
          f"{TOL_GOLDEN}; its largest device kernels: {ivf_top}), "
          f"fmllr_stats {ms['fmllr_stats']:.3f} ms + "
          f"estimate_fmllr {1e3 * est_s:.1f} ms on the host (beta "
          f"{stats[0]:.0f}); the operands made and uploaded again (what "
          f"the per-device cache saves a call) {ms['operand_upload']:.3f} "
          f"ms; runs "
          f"{ {k: ['%.3f' % t for t in v] for k, v in times.items()} } "
          f"[{card}]")
    check(ok, f"speaker utterance_ivector vs CPU {gap.max().item():.3e}")
    check(g_rel <= TOL_GOLDEN, f"speaker ivector_features vs golden "
          f"{g_rel:.3e}")
    del utt, ivf, feats, valid, frames, res

    # diarization on a world drawn from the extractor's model
    # a population of speakers, w_s ~ N(0, I); the recordings' 4 voices
    # are its first 4, as tests/test_diarize.py's recording voices are the
    # first of the PLDA's population
    voices = np.random.default_rng(24).standard_normal((plda_speakers, K))
    ids = np.arange(plda_speakers * 16) % plda_speakers
    utts = speaker_frames(ext, voices, np.repeat(ids, 150), 25).reshape(
        len(ids), 150, -1)
    ivs = ivector.utterance_ivector(ext, utts, device=device)
    model, plda_s = clock(lambda: plda.train_plda(
        ivs.double().cpu().numpy(), ids, iters=10))
    T = int(world_minutes * 6000)
    truth = turns(T, 4, 30)
    world = speaker_frames(ext, voices, truth, 30)
    xw = torch.from_numpy(world).to(device)
    reset_counts()
    seg, spans = diarization.segment_ivectors(ext, xw)
    torch.cuda.synchronize()
    read_counts("speaker segment_ivectors", {})
    seg_cpu, _ = diarization.segment_ivectors(ext, world, device="cpu")
    seg_gap = (seg.cpu() - seg_cpu).abs()
    seg_ok = bool((seg_gap <= 2e-4 + 1e-4 * seg_cpu.abs()).all())
    aff = diarization.plda_affinity(model, seg)
    aff_host = diarization.plda_affinity(model, seg, host=True)
    aff_gap = float(np.abs(aff - aff_host).max())
    ms, times, _ = time_paths({
        "segment_ivectors": lambda: diarization.segment_ivectors(ext, xw),
        "plda_affinity": lambda: diarization.plda_affinity(model, seg),
        "plda_affinity_host": lambda: diarization.plda_affinity(
            model, seg, host=True)}, offline_reps)
    (labels, _), diar_s = clock(lambda: diarization.diarize(
        ext, model, xw, num_speakers=4))
    cpu_labels, _ = diarization.diarize(ext, model, world, num_speakers=4,
                                        device="cpu")
    same = float((labels == cpu_labels).mean())

    def online():
        sd = diarization.StreamingDiarizer(ext, model, max_speakers=4,
                                           device=device)
        got = [sd.process(world[p:p + diar_chunk])[0]
               for p in range(0, T, diar_chunk)]
        return np.concatenate(got + [sd.flush()[0]])
    online_labels, online_s = clock(online)
    print(f"speaker diarization, {world_minutes} min drawn from the "
          f"extractor's model (4 of the PLDA's speakers in 3-15 s turns): "
          f"train_plda on "
          f"{len(ids)} utterances of {plda_speakers} speakers in "
          f"{plda_s:.2f} s; segment_ivectors {ms['segment_ivectors']:.3f} ms "
          f"for {len(spans)} windows (vs the CPU: max gap "
          f"{seg_gap.max().item():.3e}, limit atol 2e-4 + rtol 1e-4); "
          f"plda_affinity {ms['plda_affinity']:.3f} ms on the device, "
          f"{ms['plda_affinity_host']:.3f} ms with host=True (max gap "
          f"{aff_gap:.3e}); diarize {diar_s:.2f} s, frame agreement "
          f"{agreement(labels, truth):.4f} with the truth, labels equal "
          f"to the CPU's on {same:.4f} of frames (limit 0.99); "
          f"StreamingDiarizer ({diar_chunk}-frame chunks) {online_s:.2f} s, "
          f"frame agreement {agreement(online_labels, truth):.4f}; runs "
          f"{ {k: ['%.3f' % t for t in v] for k, v in times.items()} } "
          f"[{card}]")
    check(seg_ok, f"speaker segment i-vectors vs CPU "
          f"{seg_gap.max().item():.3e}")
    check(aff_gap <= 5e-3 + 1e-4 * float(np.abs(aff_host).max()),
          f"speaker plda_affinity device vs host {aff_gap:.3e}")
    check(same >= 0.99, f"speaker diarize labels vs CPU {same:.4f}")
    check(online_labels.shape == (T,), "speaker StreamingDiarizer frames")
    del xw, seg, seg_cpu, aff, aff_host
    if long_hours:
        T3 = int(long_hours * 360000)
        truth = turns(T3, 4, 31)
        world = speaker_frames(ext, voices, truth, 31)
        xw = torch.from_numpy(world).to(device)
        (labels, _), long_s = clock(lambda: diarization.diarize_long(
            ext, model, xw, num_speakers=4))
        print(f"speaker diarize_long over {long_hours} h ({T3} frames): "
              f"{long_s:.2f} s (RTFx {T3 / 100 / long_s:.0f}), frame "
              f"agreement {agreement(labels, truth):.4f} [{card}]")
        del xw
    if generator_hours:
        (gext, gmodel, draw, sep), world_s = clock(lambda: generator_world(
            ivector, plda, device, num_gauss, K))
        feats, truth = generator_recording(draw,
                                           int(generator_hours * 360000))
        xw = torch.from_numpy(feats).to(device)
        (labels, _), long_s = clock(lambda: diarization.diarize_long(
            gext, gmodel, xw, num_speakers=6, block=generator_block))
        T4 = int(generator_slice_minutes * 6000)
        n_blocks = -(-len(diarization.sliding_windows(T4))
                     // generator_block)
        check(n_blocks >= diarization.MIN_BLOCKS, f"speaker generator slice "
              f"forms {n_blocks} blocks")
        (card_slice, _), _ = clock(lambda: diarization.diarize_long(
            gext, gmodel, xw[:T4], num_speakers=6, block=generator_block))
        cpu_slice, _ = diarization.diarize_long(
            gext, gmodel, feats[:T4], num_speakers=6, block=generator_block,
            device="cpu")
        same = float((card_slice == cpu_slice).mean())
        print(f"speaker diarize_long on the reference's world "
              f"(diarize_long_bench.py: 6 of 24 speakers, 3-15 s turns; "
              f"G={num_gauss}, K={K}, trained on the card in {world_s:.1f} "
              f"s; PLDA separation: {sep}): {generator_hours} h "
              f"({len(truth)} frames) in {long_s:.2f} s (RTFx "
              f"{len(truth) / 100 / long_s:.0f}), frame agreement "
              f"{agreement(labels, truth):.4f}; its first "
              f"{generator_slice_minutes} min ({n_blocks} blocks of "
              f"{generator_block} windows): agreement on the card "
              f"{agreement(card_slice, truth[:T4]):.4f}, on the CPU "
              f"{agreement(cpu_slice, truth[:T4]):.4f}, labels equal to the "
              f"CPU's on {same:.4f} of frames (limit 0.99) [{card}]")
        check(same >= 0.99, f"speaker diarize_long on the generator's world "
              f"vs CPU {same:.4f}")
        del xw
    print(f"speaker phase: {time.perf_counter() - t_phase:.1f} s in all "
          f"[{card}]")


def shipped_pass(wav_dir: str, cfg, batch: int, device: str,
                 native: bool = True) -> float:
    """One pass of ``extract_corpus`` decoding with the native C++ decoder
    (``native=True``: required) or the Python one; returns its decode
    seconds."""
    from tpufeat_torch import pipeline
    stats = {}
    for _ in pipeline.extract_corpus(wav_dir, cfg, batch, stats=stats,
                                     native=native, device=device):
        pass
    return stats["decode_s"]


def option_pass(plans, cfg, compact: bool, overlap: bool,
                device: str) -> float:
    """One pass of the corpus pipeline's loop (decode one batch ahead on a
    host thread into a pinned arena, a non_blocking upload, ``extract``,
    the fetch) with the reference's two options: ``compact`` uploads the
    arena as int16 where that is exact, ``overlap`` fetches a batch's
    features on a side stream and takes them after the next batch is
    dispatched. Returns the decode seconds."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    from tpufeat_torch import extract, pipeline

    def prep(plan):
        t0 = time.perf_counter()
        entries, width, rows, rate = plan
        arena, lengths = pipeline._decode_batch(entries, width, rows, rate,
                                                native=True)
        if compact:
            q = np.round(arena * 32768.0)
            q16 = q.astype(np.int16)
            if q.min() >= -32768 and q.max() <= 32767 and \
                    (q16.astype(np.float32) / 32768.0 == arena).all():
                arena = q16
        host = torch.from_numpy(arena)
        return (host.pin_memory() if cuda else host, lengths,
                time.perf_counter() - t0)

    cuda = torch.device(device).type == "cuda"
    side = torch.cuda.Stream() if overlap and cuda else None
    pending, decode_s = None, 0.0

    def take(fetched):
        event, feats, nf = fetched
        event.synchronize()
        return feats.numpy(), nf.numpy()

    with ThreadPoolExecutor(1) as pool:
        ahead = pool.submit(prep, plans[0])
        for i in range(len(plans)):
            host, lengths, dt = ahead.result()
            decode_s += dt
            if i + 1 < len(plans):
                ahead = pool.submit(prep, plans[i + 1])
            res = extract(host.to(device, non_blocking=True),
                          torch.from_numpy(lengths).to(device), cfg)
            if side is None:
                res.features.cpu().numpy(), res.num_frames.cpu().numpy()
                continue
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                feats = torch.empty(res.features.shape, pin_memory=True)
                nf = torch.empty(res.num_frames.shape,
                                 dtype=res.num_frames.dtype, pin_memory=True)
                feats.copy_(res.features, non_blocking=True)
                nf.copy_(res.num_frames, non_blocking=True)
                event = torch.cuda.Event()
                event.record(side)
            res.features.record_stream(side)
            res.num_frames.record_stream(side)
            if pending is not None:
                take(pending)
            pending = (event, feats, nf)
    if pending is not None:
        take(pending)
    return decode_s


def corpus_phase(files: int, reset_counts, read_counts, card: str,
                 device: str = "cuda", batch: int = 64) -> dict:
    """The corpus pipeline: ``files`` PCM16 WAVs of seeded noise, lengths
    uniform in 1-30 s (seed 8), written to a temporary directory; ``python
    -m tpufeat_torch.pipeline DIR OUT.ark --preset kaldi39 --fused`` run
    to an ark, read back with ``feats_io`` and every utterance held
    against ``extract`` of that utterance alone; then, in this process,
    ``extract_corpus`` with the native C++ decoder (its arks bit for bit
    those of the Python decoder) and with the Python one, and the
    pipeline's loop with the reference's int16 upload and overlapped fetch
    on and off (:func:`option_pass`, native decode), two passes of each in
    turns: RTFx (audio seconds over wall seconds), the decode thread's
    share of the wall time, and the device's idle share in a profiled
    pass. Returns the wall seconds of each."""
    import os
    import tempfile
    import time

    from tpufeat_torch import KALDI39, extract, feats_io, io, pipeline

    cfg = dataclasses.replace(KALDI39, **FUSED)   # --fused: bf16x3
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        wav_dir = os.path.join(tmp, "wavs")
        os.makedirs(wav_dir)
        lengths = write_corpus(wav_dir, files)
        audio = float(lengths.sum()) / SR
        ark = os.path.join(tmp, "feats.ark")
        cmd = [sys.executable, "-m", "tpufeat_torch.pipeline", wav_dir, ark,
               "--preset", "kaldi39", "--fused", "--batch", str(batch),
               "--repeat", "2", "--device", device]
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                           text=True, timeout=600)
        whole = time.perf_counter() - t0
        check(r.returncode == 0, f"python -m tpufeat_torch.pipeline exited "
              f"{r.returncode}: {r.stderr[-2000:]}")
        report = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"corpus: python -m tpufeat_torch.pipeline over {files} WAVs "
              f"({audio:.1f} s of audio) --preset kaldi39 --fused: "
              f"{json.dumps(report)}; the command took {whole:.2f} s "
              f"[{card}]")
        utts = feats_io.read_kaldi_ark(ark)
        check(sorted(utts) == [f"u{i:03d}" for i in range(files)],
              f"corpus ark keys ({len(utts)})")
        same, worst = 0, 0.0
        for i in range(files):
            x, rate = io.read_wav(os.path.join(wav_dir, f"u{i:03d}.wav"))
            want = extract(x, cfg=cfg, device=device).features.cpu()
            got = torch.from_numpy(utts[f"u{i:03d}"])
            check(got.shape == want.shape, f"corpus u{i:03d} shape "
                  f"{tuple(got.shape)} vs {tuple(want.shape)}")
            same += bool(torch.equal(got, want))
            worst = max(worst, scaled_err(got, want)[1])
        torch.cuda.synchronize()
        print(f"corpus ark vs extract of each utterance alone: {same} of "
              f"{files} bit-identical, the rest within {worst:.3e} scaled "
              f"(limit {TOL_STREAM})")
        check(worst <= TOL_STREAM, f"corpus vs per-utterance {worst:.3e}")
        del utts

        # the native decode against the Python decode: the same arks
        native = dict(pipeline.extract_corpus(wav_dir, cfg, batch,
                                              native=True, device=device))
        python = dict(pipeline.extract_corpus(wav_dir, cfg, batch,
                                              native=False, device=device))
        same = sum(np.array_equal(native[k], python[k]) for k in python)
        print(f"corpus extract_corpus, native decode vs Python decode: "
              f"{same} of {len(python)} utterances bit for bit [{card}]")
        check(sorted(native) == sorted(python) and same == len(python),
              f"corpus native vs Python decode: {same} of {len(python)}")
        del native, python

        # where the decode thread's time goes: each batch decoded by the
        # native decoder and by the Python one, and made page-locked
        split = {"native": 0.0, "Python": 0.0, "pin_memory": 0.0}
        for entries, width, rows, rate in pipeline._plan_batches(
                pipeline._scan_corpus(wav_dir, native=True), batch):
            for name, native in (("native", True), ("Python", False)):
                t0 = time.perf_counter()
                arena, _ = pipeline._decode_batch(entries, width, rows, rate,
                                                  native=native)
                split[name] += time.perf_counter() - t0
            t0 = time.perf_counter()
            pipeline._pinned(arena, device != "cpu")
            split["pin_memory"] += time.perf_counter() - t0
        print(f"corpus decode, a pass's batches one after another: "
              f"{', '.join(f'{k} {1e3 * v:.1f} ms' for k, v in split.items())}"
              f" [{card}]")

        # the shipped pipeline with the native decoder and with the Python
        # one, then the reference's two options on the same loop: "int16"
        # uploads an arena as int16 where that is exact, "overlap" fetches
        # batch k on a side stream after batch k+1 is dispatched; "f32
        # serial" is the shipped loop again (the control)
        plans = pipeline._plan_batches(
            pipeline._scan_corpus(wav_dir, native=True), batch)
        runs = {"shipped": functools.partial(shipped_pass, wav_dir, cfg,
                                             batch, device),
                "shipped, Python decode": functools.partial(
                    shipped_pass, wav_dir, cfg, batch, device, False)}
        for compact, overlap in itertools.product((False, True), repeat=2):
            name = (f"{'int16' if compact else 'f32'} "
                    f"{'overlap' if overlap else 'serial'}")
            runs[name] = functools.partial(option_pass, plans, cfg, compact,
                                           overlap, device)
        walls = {name: [] for name in runs}
        decode = {name: [] for name in runs}
        reset_counts()
        runs["shipped"]()                          # warm
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                t0 = time.perf_counter()
                decode[name].append(runs[name]())
                walls[name].append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        read_counts("corpus passes", {"signal_features_mma": (
            1 + 2 * len(runs)) * len(plans)})
        out = {}
        for name, run in runs.items():
            wall = statistics.mean(walls[name])
            _, dev, idle = idle_share(run, 1)
            out[name] = wall
            print(f"corpus pass, {name}: wall {wall:.3f} s (passes "
                  f"{['%.3f' % w for w in walls[name]]}), RTFx "
                  f"{audio / wall:.0f}, decode share "
                  f"{statistics.mean(decode[name]) / wall:.3f}, device "
                  f"{dev:.1f} ms a pass, idle share {idle:.3f} (profiled "
                  f"pass) [{card}]", flush=True)
    return out


def kernel_device_ms(fn, part: str) -> tuple[float, float]:
    """(device ms of the kernels whose name holds ``part``, all device ms)
    of one call of ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in rows if part in e.key)
            / 1e3, sum(e.self_device_time_total for e in rows) / 1e3)


def models_phase(sig: np.ndarray, reset_counts, read_counts, card: str,
                 device: str = "cuda", reps: int = REPS, cpu_rows: int = 2,
                 train_batch: int = 16, steps: int = 5,
                 xvector_steps: int = 8, widths: dict | None = None) -> None:
    """The ASR models fed by the front-end (config 5). Serving:
    ``asr_forward`` over the main path's batch ``sig`` (B x 30 s, full
    lengths) with ``make_models()`` (whisper-tiny's widths, a 64-token
    head) on ``WHISPER80`` with the fused flags at bf16x3, then with
    ``conformer_small``'s widths on ``KALDI39`` rows; each with its K1
    launch, its median time (CUDA events) beside the front-end's
    (``extract`` alone) and K1's device time in a profiled forward, its
    peak memory, ``cpu_rows`` rows against the same model on the CPU (K1's
    twin) within ``TOL_MODEL``, and the greedy CTC output's lengths.
    Training, ``steps`` steps each from raw audio (``train_batch`` x 30 s)
    with AdamW (``TRAIN_LR``), each loss finite and the last below the
    first, each step timed: ``ctc_train_step`` at whisper-tiny's width
    (40-label targets), ``transducer_train_step`` at
    ``make_transducer()``'s (dim 128, 2 Conformer layers, vocab 64,
    32-label targets), and ``xvector_train_step`` (``xvector_steps``
    steps) at ``xvector_model(24)``'s (channels 256, embedding 192) on the
    batch's ``KALDI39`` rows, ragged, each row labelled one of 24 speakers
    and shifted by that speaker's seeded offset (``tests/test_xvector.py``'s
    batch), the embeddings' nearest neighbours then counted. ``widths``:
    per-model overrides of the model functions' widths (a CPU dry run's)."""
    import copy
    import time

    from tpufeat_torch import KALDI39, WHISPER80, extract
    from tpufeat_torch.models import train, xvector

    widths = widths or {}
    t_phase = time.perf_counter()
    B, n = sig.shape
    x = torch.from_numpy(sig).to(device)
    lx = torch.full((B,), n, dtype=torch.int64, device=device)

    def clocked(fn) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    # serving: raw audio -> front-end (K1) -> encoder -> head
    for arch, base, kw in (
            ("whisper", WHISPER80, dict(dim=384, layers=4, heads=6)),
            ("conformer", KALDI39, dict(dim=144, layers=4, heads=4))):
        cfg = dataclasses.replace(base, **FUSED)
        torch.manual_seed(0)
        model = train.make_models(vocab=64, arch=arch,
                                  in_dim=cfg.feature_dim, device=device,
                                  **dict(kw, **widths.get(arch, {})))

        def forward(model=model, cfg=cfg):
            with torch.inference_mode():
                return train.asr_forward(model, x, lx, cfg)

        def front(cfg=cfg):
            with torch.inference_mode():
                return extract(x, lx, cfg)

        reset_counts()
        logits, mask = forward()
        torch.cuda.synchronize()
        read_counts(f"models {arch} asr_forward (B={B})",
                    {"signal_features_mma": 1})
        ms, times, peak = time_paths({"asr_forward": forward,
                                      "front_end": front}, reps)
        k1_ms, dev_ms = kernel_device_ms(forward, "signal_mma")
        hyps, decode_ms = clocked(lambda: train.greedy_ctc_decode(logits,
                                                                  mask))
        lens = np.array([len(h) for h in hyps])
        cpu_model = copy.deepcopy(model).to("cpu")
        with torch.inference_mode():
            want, wmask = train.asr_forward(cpu_model, sig[:cpu_rows],
                                            np.full(cpu_rows, n), cfg)
        got = logits[:cpu_rows].cpu()
        check(torch.equal(mask[:cpu_rows].cpu(), wmask),
              f"models {arch} mask vs CPU")
        _, err = scaled_err(got[wmask], want[wmask])
        print(f"models serving, {arch} ({kw}, vocab 64) on "
              f"{cfg.feature_dim}-dim rows: asr_forward of B={B} x "
              f"{n // SR} s median "
              f"{ms['asr_forward']:.3f} ms (RTFx "
              f"{B * n / SR / ms['asr_forward'] * 1e3:.0f}), the front-end "
              f"(extract alone) {ms['front_end']:.3f} ms = "
              f"{ms['front_end'] / ms['asr_forward']:.4f} of it; profiled: "
              f"K1 {k1_ms:.3f} of {dev_ms:.3f} device ms = "
              f"{k1_ms / dev_ms:.4f}; peak memory "
              f"{peak['asr_forward'] / 2**30:.2f} GiB; logits "
              f"{tuple(logits.shape)}; {cpu_rows} rows vs the CPU "
              f"{err:.3e} scaled (limit {TOL_MODEL}); greedy CTC in "
              f"{decode_ms:.1f} ms, lengths min {lens.min()} median "
              f"{np.median(lens):.0f} max {lens.max()} of {mask.sum(1).max()}"
              f" frames; runs "
              f"{ {k: ['%.3f' % t for t in v] for k, v in times.items()} } "
              f"[{card}]", flush=True)
        check(bool(torch.isfinite(logits).all()), f"models {arch} logits")
        check(err <= TOL_MODEL, f"models {arch} vs CPU {err:.3e}")
        del model, cpu_model, logits, mask

    # training from raw audio: CTC, RNN-T; x-vectors on features
    rng = np.random.default_rng(12)
    tb = min(train_batch, B)
    xa, la = x[:tb], lx[:tb]

    def train_steps(name, state, step, count, *args, **kw):
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for _ in range(count):
            (_, loss), t = clocked(lambda: step(state, *args, **kw))
            losses.append(loss.item())
            step_ms.append(t)
        print(f"models training, {name}: losses "
              f"{['%.4f' % v for v in losses]}, step median "
              f"{statistics.median(step_ms[1:] or step_ms):.1f} ms (steps "
              f"{['%.1f' % t for t in step_ms]}), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]", flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"models {name}: losses {losses}")

    cfg = dataclasses.replace(WHISPER80, **FUSED)
    torch.manual_seed(1)
    model = train.make_models(vocab=64, device=device,
                              **widths.get("whisper", {}))
    labels = rng.integers(1, 64, (tb, 40))
    train_steps(f"ctc_train_step, whisper-tiny, B={tb} x {n // SR} s",
                train.TrainState(model, train.adamw(model, TRAIN_LR)),
                train.ctc_train_step, steps, xa, la, labels,
                np.full(tb, 40), cfg=cfg)
    read_counts("models ctc_train_step", {"signal_features_mma": steps})
    del model

    torch.manual_seed(2)
    model = train.make_transducer(device=device,
                                  **widths.get("transducer", {}))
    labels = rng.integers(1, 64, (tb, 32))
    train_steps(f"transducer_train_step, make_transducer(), B={tb} x "
                f"{n // SR} s, 32 labels",
                train.TrainState(model, train.adamw(model, TRAIN_LR)),
                train.transducer_train_step, steps, xa, la, labels,
                np.full(tb, 32), cfg=cfg)
    read_counts("models transducer_train_step",
                {"signal_features_mma": steps})
    del model

    kcfg = dataclasses.replace(KALDI39, **FUSED)
    rows = torch.from_numpy(ragged_lengths(n, B)).to(device)
    reset_counts()
    res = extract(x, rows, kcfg)
    torch.cuda.synchronize()
    read_counts("models x-vector features (KALDI39)",
                {"signal_features_mma": 1})
    speaker = torch.arange(B, device=device) % 24
    offsets = torch.from_numpy(rng.standard_normal((24, 39)).astype(
        np.float32)).to(device)
    feats = res.features + offsets[speaker][:, None, :]
    torch.manual_seed(3)
    model = xvector.xvector_model(24, in_dim=39, device=device,
                                  **widths.get("xvector", {}))
    train_steps(f"xvector_train_step, xvector_model(24), B={B} ragged",
                xvector.XvectorState(model, train.adamw(model, TRAIN_LR)),
                xvector.xvector_train_step, xvector_steps,
                feats, res.mask, speaker)
    read_counts("models xvector_train_step", {})
    emb = xvector.extract_xvectors(model, feats, res.num_frames)
    check(emb.shape == (B, model.embed.out_features)
          and bool(torch.isfinite(emb).all()), "models x-vectors")
    d = torch.cdist(emb, emb)
    d.fill_diagonal_(float("inf"))
    nearest = float((speaker[d.argmin(dim=1)] == speaker).float().mean())
    print(f"models x-vectors of the {B} rows: the nearest neighbour is of "
          f"the same speaker for {nearest:.3f} of them [{card}]")
    del model, res, emb, x, feats
    print(f"models phase: {time.perf_counter() - t_phase:.1f} s in all "
          f"[{card}]", flush=True)


def main_batch(batch: int = BATCH, seconds: int = SECONDS) -> np.ndarray:
    """The main path's batch: ``batch`` x ``seconds`` of seeded noise (seed
    0), float32."""
    return (np.random.default_rng(0).standard_normal((batch, seconds * SR))
            * 0.1).astype(np.float32)


def long_recording(seconds: int) -> np.ndarray:
    """One recording of ``seconds`` of seeded noise (seed 13): the sharding
    phase's long-form audio."""
    return (np.random.default_rng(13).standard_normal(seconds * SR)
            * 0.1).astype(np.float32)


def write_corpus(wav_dir: str, files: int) -> np.ndarray:
    """``files`` PCM16 WAVs of seeded noise in ``wav_dir``, ``u000.wav``
    on, lengths uniform in 1-30 s (seed 8): the corpus phase's corpus.
    Returns the lengths."""
    import os

    from tpufeat_torch import io
    rng = np.random.default_rng(8)
    lengths = rng.integers(1 * SR, 30 * SR + 1, files)
    for i, n in enumerate(lengths):
        io.write_wav(os.path.join(wav_dir, f"u{i:03d}.wav"),
                     (rng.standard_normal(n) * 0.1).astype(np.float32), SR)
    return lengths


def fused_presets() -> dict:
    """WHISPER80, MFCC13_HTK and KALDI39 with the fused flags at bf16x3
    (K1), by name."""
    from tpufeat_torch import KALDI39, MFCC13_HTK, WHISPER80
    return {name: dataclasses.replace(cfg, **FUSED) for name, cfg in (
        ("WHISPER80", WHISPER80), ("MFCC13_HTK", MFCC13_HTK),
        ("KALDI39", KALDI39))}


def same_or_err(got, want) -> tuple[bool, float]:
    """(bit for bit, the scaled error) of two tensors, on the host."""
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    if got.shape != want.shape:
        raise RuntimeError(f"chip_smoke failed: shape {tuple(got.shape)} "
                           f"vs {tuple(want.shape)}")
    return bool(torch.equal(got, want)), scaled_err(got, want)[1]


def step_result(loss: torch.Tensor, model, optimizer) -> dict:
    """A training step's outcome on the host: the loss, the parameters
    after the step, and the gradient it took (AdamW's first moment after
    one step, ``(1 - beta1) g``, over ``1 - beta1``), by name."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    return {"loss": loss.item(),
            "params": {k: v.detach().cpu().numpy()
                       for k, v in model.named_parameters()},
            "grads": {k: (optimizer.state[v]["exp_avg"] / (1 - beta1))
                      .cpu().numpy() for k, v in model.named_parameters()}}


def dp_step_gaps(got: dict, want: dict) -> tuple[float, float, int, int]:
    """A dp step's :func:`step_result` against one rank's: (the loss's
    relative gap, the gradient's largest gap scaled by its tensor's
    largest entry, the parameter entries more than TOL_DP_PARAMS x lr
    apart, those of them whose gradient is farther than TOL_DP_GRAD from
    0)."""
    check(sorted(got["params"]) == sorted(want["params"]),
          "parameter names differ")
    grad_gap, moved, unexplained = 0.0, 0, 0
    for k, g in want["grads"].items():
        g = g.astype(np.float64)
        scale = max(float(np.abs(g).max()), 1e-30)
        grad_gap = max(grad_gap, float(np.abs(got["grads"][k] - g).max())
                       / scale)
        apart = np.abs(got["params"][k].astype(np.float64)
                       - want["params"][k]) > TOL_DP_PARAMS * TRAIN_LR
        moved += int(apart.sum())
        unexplained += int((apart & (np.abs(g) > TOL_DP_GRAD * scale))
                           .sum())
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    return rel, grad_gap, moved, unexplained


def train_batch_labels(rows: int, width: int) -> np.ndarray:
    """The dp CTC step's targets: ``rows`` x ``width`` labels in 1-63
    (seed 12)."""
    return np.random.default_rng(12).integers(1, 64, (rows, width))


def ctc_step(sig: np.ndarray, rows: slice, labels: np.ndarray, device: str,
             widths: dict, group=None) -> dict:
    """One ``ctc_train_step`` at whisper-tiny's width (``make_models()``,
    a 64-token head, torch seed 1, AdamW at TRAIN_LR) on ``sig[rows]``,
    data-parallel over ``group`` when a process group is initialised: its
    :func:`step_result`."""
    from tpufeat_torch.models import train
    n = sig.shape[1]
    per = rows.stop - rows.start
    torch.manual_seed(1)
    model = train.make_models(vocab=64, device=device,
                              **widths.get("whisper", {}))
    state = train.TrainState(model, train.adamw(model, TRAIN_LR))
    _, loss = train.ctc_train_step(
        state, sig[rows], np.full(per, n), labels[rows],
        np.full(per, labels.shape[1]), cfg=fused_presets()["WHISPER80"],
        group=group)
    return step_result(loss, model, state.optimizer)


def xvector_features(sig: np.ndarray, rows: slice, device: str):
    """``KALDI39`` (fused) features of ``sig[rows]`` at the kaldi39
    phase's ragged lengths, each row shifted by its speaker's seeded offset
    (row b speaks speaker b % 24, offsets seed 24): (features, mask,
    speakers)."""
    from tpufeat_torch import extract
    n = sig.shape[1]
    lengths = ragged_lengths(n, len(sig))
    res = extract(sig[rows], lengths[rows], fused_presets()["KALDI39"],
                  device=device)
    speaker = torch.arange(len(sig), device=device)[rows] % 24
    offsets = torch.from_numpy(np.random.default_rng(24).standard_normal(
        (24, 39)).astype(np.float32)).to(device)
    return res.features + offsets[speaker][:, None, :], res.mask, speaker


def xvector_step(feats, mask, speaker, device: str, widths: dict,
                 group=None) -> dict:
    """One ``xvector_train_step`` at ``xvector_model(24)``'s width (torch
    seed 3, AdamW at TRAIN_LR), data-parallel over ``group`` when a
    process group is initialised: its :func:`step_result`."""
    from tpufeat_torch.models import train, xvector
    torch.manual_seed(3)
    model = xvector.xvector_model(24, in_dim=39, device=device,
                                  **widths.get("xvector", {}))
    state = xvector.XvectorState(model, train.adamw(model, TRAIN_LR))
    _, loss = xvector.xvector_train_step(state, feats, mask, speaker,
                                         group=group)
    return step_result(loss, model, state.optimizer)


def sharding_rank(spec: dict) -> dict:
    """One rank of the sharding phase's gloo group (every rank on the same
    card, spawned by ``tpufeat_torch.multichip.spawn``): each part driven
    with K1's launch count set to 0 just before it and read just after,
    its wall time taken between two barriers; rank 0 holds each result
    against the unsharded path on its device. Returns {"launches": by
    part} from every rank, and from rank 0 also "checks" (part -> (bit
    for bit, scaled error, CMVN or not)), "ms" (part -> ms a call) and the
    training steps' losses and parameters."""
    import os
    import time

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from tpufeat_torch import extract, pipeline, pitch, sharding
    from tpufeat_torch import ivector as iv
    from tpufeat_torch.kernels import signal
    from tpufeat_torch.multichip import _speaker_model

    device = spec["device"]
    rank, ranks = sharding.rank_and_size()
    cuda = torch.device(device).type == "cuda"
    sig = main_batch(spec["batch"], spec["seconds"])
    B, n = sig.shape
    lengths = np.full(B, n)
    hour = long_recording(spec["long_s"])
    cfgs = fused_presets()
    launches, ms, checks, out = {}, {}, {}, {}
    # first calls (the kernel library's load, the allocator, a first
    # collective), outside the timed parts
    for cfg in cfgs.values():
        extract(sig[:1], lengths[:1], cfg, device=device)
    sharding._gather_rows([torch.zeros(1, device=device)])

    def timed(part: str, fn, reps: int = 1):
        """``fn()`` ``reps`` times on every rank: K1's launches counted,
        ms a call between two barriers."""
        dist.barrier()
        signal.mma_launches = 0
        t0 = time.perf_counter()
        for _ in range(reps):
            got = fn()
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        ms[part] = 1e3 * (time.perf_counter() - t0) / reps
        launches[part] = signal.mma_launches
        return got

    def hold(part: str, got, want, cmvn: bool) -> None:
        if rank == 0:
            checks[part] = (*same_or_err(got, want), cmvn)

    # data parallelism over the main path's batch
    for name in ("WHISPER80", "MFCC13_HTK"):
        cfg = cfgs[name]
        res = timed(f"dp {name}", lambda: sharding.extract_data_parallel(
            sig, lengths, cfg, device=device))
        if rank == 0:
            want = extract(sig, lengths, cfg, device=device)
            check(torch.equal(res.mask, want.mask), f"dp {name} mask")
            hold(f"dp {name}", res.features, want.features, False)
            del want
        del res

    # time sharding of the long recording, a quarter a rank
    for name in ("KALDI39", "WHISPER80", "MFCC13_HTK"):
        cfg = cfgs[name]
        got = timed(f"time {name}", lambda: sharding.extract_time_sharded(
            hour, cfg, device=device))
        if rank == 0:
            hold(f"time {name}", got, extract(hour, cfg=cfg,
                                              device=device).features,
                 cfg.cmvn != "none")
        del got

    # the 2-D mesh: two recordings (the long one's halves), each split
    # along time over one row of the mesh
    mesh = DeviceMesh("cpu", torch.arange(ranks).reshape(2, -1),
                      mesh_dim_names=("dp", "time"))
    halves = hour.reshape(2, -1)
    for name in ("KALDI39", "WHISPER80"):
        cfg = cfgs[name]
        res = timed(f"mesh {name}", lambda: sharding.extract_batch_time_sharded(
            halves, np.full(2, halves.shape[1]), cfg, mesh, device=device))
        if rank == 0:
            for b in range(2):
                hold(f"mesh {name} row {b}", res.features[b][res.mask[b]],
                     extract(halves[b], cfg=cfg, device=device).features,
                     cfg.cmvn != "none")
        del res

    # pitch, data-parallel over the batch
    pcfg = pitch.PitchConfig()
    feats, valid = timed("pitch dp", lambda: sharding.pitch_features_data_parallel(
        sig, lengths, pcfg, device=device))
    if rank == 0:
        wf, wv = pitch.pitch_features(sig, lengths, pcfg, device=device)
        check(torch.equal(valid, wv), "pitch dp validity")
        hold("pitch dp", feats, wf, False)
    del feats, valid

    # the CTC step at whisper-tiny width, the training batch's rows split
    rows = sharding._own_rows(spec["train_batch"], None, "ctc")
    labels = train_batch_labels(spec["train_batch"], 40)
    out["ctc"] = timed("ctc step", lambda: ctc_step(
        sig, rows, labels, device, spec["widths"]))
    timed("ctc step, second call", lambda: ctc_step(
        sig, rows, labels, device, spec["widths"]))

    # the x-vector step on this rank's rows of the batch's KALDI39 rows,
    # then dp i-vectors and PLDA trial scores of the same rows
    rows = sharding._own_rows(B, None, "x-vectors")
    out["xvector"] = timed("x-vector step", lambda: xvector_step(
        *xvector_features(sig, rows, device), device, spec["widths"]))
    ext, plda = _speaker_model(np.random.default_rng(7),
                               *spec["speaker"])

    def speaker_stack():
        f, m, _ = xvector_features(sig, rows, device)
        local = iv.utterance_ivector(ext, f, m, device=device)
        ivecs, = sharding._gather_rows([local])
        scores, = sharding._gather_rows([plda.score(
            ivecs[: B // 2], local, device=device)], dim=1)
        return ivecs, scores

    ivecs, scores = timed("i-vectors and PLDA", speaker_stack)
    if rank == 0:
        f, m, _ = xvector_features(sig, slice(0, B), device)
        want = iv.utterance_ivector(ext, f, m, device=device)
        hold("i-vectors", ivecs, want, False)
        hold("PLDA scores", scores, plda.score(want[: B // 2], want,
                                               device=device), False)
        del f, m, want
    del ivecs, scores

    # the corpus pipeline with --dp: rank 0 writes the ark
    ark = os.path.join(spec["out_dir"], "dp.ark")
    rc = timed("corpus --dp", lambda: pipeline.main([
        spec["wav_dir"], ark, "--preset", "kaldi39", "--fused", "--batch",
        str(spec["corpus_batch"]), "--dp", "--device", device]))
    check(rc == 0, f"pipeline --dp exited {rc} in rank {rank}")

    # the collectives alone (the dist layer): the halo exchange of a
    # quarter of the long recording, a masked max's all_reduce, the gather
    # of a rank's dp rows of Whisper features
    shard = torch.from_numpy(hour[: len(hour) // ranks][None]).to(device)
    timed("dist halo exchange", lambda: sharding._halos(
        shard, 1, cfgs["MFCC13_HTK"].frame_length - 160, None), reps=10)
    peak = torch.ones(1, 1, 1, device=device)
    timed("dist all_reduce(MAX)", lambda: sharding._collective(
        "all_reduce", peak, None, dist.ReduceOp.MAX), reps=10)
    part = torch.zeros(B // ranks, cfgs["WHISPER80"].num_frames(n), 80,
                       device=device)
    timed("dist gather of dp rows", lambda: sharding._gather_rows([part]),
          reps=3)
    # the CTC step's gradient exchange alone: one all_reduce per parameter
    # tensor of whisper-tiny's shapes, as optimizer_step runs it
    grads = [torch.zeros(v.shape, device=device) for v in
             out["ctc"]["params"].values()]
    timed("dist gradient all_reduce", lambda: [sharding._collective(
        "all_reduce", g, None) for g in grads], reps=3)
    for name in ("dist halo exchange", "dist all_reduce(MAX)",
                 "dist gather of dp rows", "dist gradient all_reduce"):
        launches.pop(name)
    out.update(launches=launches)
    if rank == 0:
        out.update(checks=checks, ms=ms)
    return out


def sharding_phase(sig: np.ndarray, wav_dir: str, reset_counts, read_counts,
                   card: str, device: str = "cuda", ranks: int = 4,
                   long_s: int = 3600, train_batch: int = 16,
                   corpus_batch: int = 64, widths: dict | None = None,
                   speaker: tuple = (512, 39, 100)) -> None:
    """Multi-device extraction and training over ``torch.distributed`` on
    the one card. (a) A one-rank NCCL group in this process:
    ``extract_data_parallel`` of the main path's batch ``sig`` and
    ``extract_time_sharded`` of one ``long_s`` recording on ``WHISPER80``,
    ``MFCC13_HTK`` and ``KALDI39`` (fused, bf16x3), each against the
    unsharded ``extract``. (b) ``ranks`` gloo ranks sharing the card
    (NCCL refuses two ranks on one GPU; :func:`sharding_rank`): dp over
    ``sig``, time sharding of the long recording, the 2 x ``ranks / 2``
    mesh over its two halves, pitch dp, the CTC step at whisper-tiny width
    on ``train_batch`` rows and the x-vector step on ``sig``'s KALDI39
    rows against the same steps on one rank here, dp i-vectors and PLDA
    scores (a seeded random model of ``speaker`` = (gaussians, dim,
    i-vector dim)), and (c) ``python -m tpufeat_torch.pipeline --dp`` over
    ``wav_dir``, its ark byte for byte the one-rank pass's. K1 must launch
    in every rank; the ranks' launches are summed into the counts. Times
    of (b) are four processes sharing one card, not a multi-GPU scaling
    number. Without CMVN the sharded features must equal the unsharded
    bit for bit (K1 computes a frame from that frame alone; every halo is
    an exact copy; a max is order-free); with it within TOL_SHARD_CMVN."""
    import os
    import tempfile
    import time

    import torch.distributed as dist

    from tpufeat_torch import extract, pipeline, sharding
    from tpufeat_torch.kernels import signal
    from tpufeat_torch.multichip import spawn

    widths = widths or {}
    t_phase = time.perf_counter()
    cfgs = fused_presets()
    B, n = sig.shape
    lengths = np.full(B, n)
    hour = long_recording(long_s)
    cuda = torch.device(device).type == "cuda"

    def hold(what: str, same: bool, err: float, cmvn: bool) -> None:
        limit = TOL_SHARD_CMVN if cmvn else 0.0
        print(f"sharding {what} vs unsharded extract: "
              f"{'bit for bit' if same else f'scaled {err:.3e}'} "
              f"(limit {'2e-5 scaled' if cmvn else 'bit for bit'}) "
              f"[{card}]")
        check(same or (cmvn and err <= limit),
              f"sharding {what}: scaled {err:.3e}")

    # (a) a one-rank NCCL group in this process
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(sharding.backend_for(device, 1),
                                init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            backend = dist.get_backend()
            for cfg in cfgs.values():           # first calls: set-up
                sharding.extract_data_parallel(sig[:1], lengths[:1], cfg,
                                               device=device)
                sharding.extract_time_sharded(hour[: 160 * 1000], cfg,
                                              device=device)
            reset_counts()
            got, walls = {}, {}
            for kind, fn in (
                    ("dp", lambda cfg: sharding.extract_data_parallel(
                        sig, lengths, cfg, device=device)),
                    ("time", lambda cfg: sharding.extract_time_sharded(
                        hour, cfg, device=device))):
                for name, cfg in cfgs.items():
                    if cuda:
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got[kind, name] = fn(cfg)
                    if cuda:
                        torch.cuda.synchronize()
                    walls[kind, name] = 1e3 * (time.perf_counter() - t0)
            read_counts(f"sharding, one-rank {backend} group",
                        {"signal_features_mma": 2 * len(cfgs)})
        finally:
            dist.destroy_process_group()
    for (kind, name), res in got.items():
        cfg = cfgs[name]
        if kind == "dp":
            want = extract(sig, lengths, cfg, device=device)
            check(torch.equal(res.mask, want.mask), f"dp {name} mask")
            res, want = res.features, want.features
        else:
            want = extract(hour, cfg=cfg, device=device).features
        hold(f"one-rank {backend} {kind} {name}", *same_or_err(res, want),
             cfg.cmvn != "none")
        print(f"sharding one-rank {backend} {kind} {name}: "
              f"{walls[kind, name]:.1f} ms a call (wall, from numpy: the "
              f"upload included; {'B=%d x %d s' % (B, n // SR) if kind == 'dp' else '%d s of audio' % long_s}) "
              f"[{card}]")
    del got, res, want

    # (b, c) the gloo ranks sharing the card
    plans = len(pipeline._plan_batches(pipeline._scan_corpus(wav_dir,
                                                             native=True),
                                       corpus_batch))
    per_rank = {"dp WHISPER80": 1, "dp MFCC13_HTK": 1, "time KALDI39": 1,
                "time WHISPER80": 1, "time MFCC13_HTK": 1,
                "mesh KALDI39": 1, "mesh WHISPER80": 1, "pitch dp": 0,
                "ctc step": 1, "ctc step, second call": 1,
                "x-vector step": 1, "i-vectors and PLDA": 1,
                "corpus --dp": plans}
    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(device=device, batch=B, seconds=n // SR, long_s=long_s,
                    train_batch=train_batch, corpus_batch=corpus_batch,
                    widths=widths, speaker=speaker, wav_dir=wav_dir,
                    out_dir=tmp)
        t0 = time.perf_counter()
        ranks_out = spawn(sharding_rank, ranks, spec, device=device,
                          timeout=900)
        spawn_s = time.perf_counter() - t0
        for r, res in enumerate(ranks_out):
            check(res["launches"] == per_rank,
                  f"sharding rank {r} launches {res['launches']}, expected "
                  f"{per_rank}")
        reset_counts()
        signal.mma_launches = sum(sum(res["launches"].values())
                                  for res in ranks_out)
        read_counts(f"sharding, {ranks} gloo ranks on one card (the ranks' "
                    f"launches summed)", {"signal_features_mma":
                                          ranks * sum(per_rank.values())})
        first = ranks_out[0]
        for what, (same, err, cmvn) in first["checks"].items():
            hold(f"{ranks} gloo ranks, {what}", same, err, cmvn)

        # the corpus: --dp's ark against one rank's
        ark = os.path.join(tmp, "one.ark")
        check(pipeline.main([wav_dir, ark, "--preset", "kaldi39", "--fused",
                             "--batch", str(corpus_batch), "--device",
                             device]) == 0, "pipeline one rank")
        with open(ark, "rb") as a, open(os.path.join(tmp, "dp.ark"),
                                          "rb") as b:
            same = a.read() == b.read()
        print(f"sharding corpus: python -m tpufeat_torch.pipeline --dp over "
              f"{ranks} gloo ranks, its ark {'byte for byte' if same else 'NOT'}"
              f" the one-rank pass's [{card}]")
        check(same, "pipeline --dp ark differs from the one-rank ark")

    # the dp training steps against one rank here
    one = {"ctc": ctc_step(sig, slice(0, train_batch),
                           train_batch_labels(train_batch, 40), device,
                           widths),
           "xvector": xvector_step(*xvector_features(sig, slice(0, B),
                                                     device),
                                   device, widths)}
    for part, what in (("ctc", "CTC step, whisper-tiny"),
                       ("xvector", "x-vector step")):
        rel, grad_gap, moved, unexplained = dp_step_gaps(first[part],
                                                         one[part])
        entries = sum(v.size for v in one[part]["params"].values())
        print(f"sharding {ranks} gloo ranks, {what}: loss "
              f"{first[part]['loss']:.6f} vs one rank's "
              f"{one[part]['loss']:.6f} (rel {rel:.3e}, limit "
              f"{TOL_DP_LOSS}); gradient within {grad_gap:.3e} of each "
              f"tensor's largest entry (limit {TOL_DP_GRAD}); {moved} of "
              f"{entries} parameter entries more than {TOL_DP_PARAMS} x lr "
              f"apart after the step, {unexplained} of them where the "
              f"gradient is farther than its tolerance from 0 (limit 0) "
              f"[{card}]")
        check(rel <= TOL_DP_LOSS, f"sharding {what} loss {rel:.3e}")
        check(grad_gap <= TOL_DP_GRAD, f"sharding {what} gradient "
              f"{grad_gap:.3e}")
        check(unexplained == 0, f"sharding {what}: {unexplained} parameter "
              f"entries apart where the gradient is not near 0")
    del one

    for part, t in first["ms"].items():
        print(f"sharding {ranks} gloo ranks sharing one card, {part}: "
              f"{t:.3f} ms a call (wall, between barriers; four processes "
              f"on one card, not a multi-GPU scaling number) [{card}]")
    print(f"sharding phase: {spawn_s:.1f} s for the {ranks} ranks (spawn "
          f"included), {time.perf_counter() - t_phase:.1f} s in all "
          f"[{card}]", flush=True)


def compat_phase(sig: np.ndarray, wav_dir: str, reset_counts, read_counts,
                 card: str, device: str = "cuda", cpu_rows: int = 8,
                 batch: int = 64, workers: int = 4) -> None:
    """The toolchain shims. ``WhisperFeatureExtractor`` on the card (the
    fused route at bf16x3: K1) over the main path's utterances ``sig``,
    row 0 against the float64 golden and ``cpu_rows`` rows against the
    same shim on the CPU, both within TOL_GOLDEN, timed; then a
    ``FeatureLoader`` over a ``DataLoader`` (``workers`` worker processes,
    ``pad_collate``, ``batch`` rows) of ``wav_dir``'s WAVs on ``KALDI39``
    fused, each batch equal to ``extract`` of the same padded batch."""
    import glob
    import os
    import time

    from tpufeat_torch import WHISPER80, compat, extract
    from tpufeat_torch.reference import cpu

    B, n = sig.shape
    fe = compat.WhisperFeatureExtractor(device=device)
    cuda = torch.device(device).type == "cuda"
    check(fe.config.use_pallas == cuda and fe.config.fused_framing == cuda,
          "the shim's route")
    reset_counts()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fe(sig, sampling_rate=SR, return_tensors="pt")["input_features"]
    if cuda:
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    read_counts("compat WhisperFeatureExtractor",
                {"signal_features_mma": 1 if cuda else 0})
    check(got.shape == (B, 80, fe.nb_max_frames)
          and bool(torch.isfinite(got).all()),
          f"compat shape {tuple(got.shape)}")
    x0 = np.zeros(fe.n_samples)                   # the shim's 30 s window
    x0[: min(n, fe.n_samples)] = sig[0, : fe.n_samples]
    gold = torch.from_numpy(cpu.extract(x0, WHISPER80)).T
    _, rel = scaled_err(got[0].cpu(), gold)
    host = compat.WhisperFeatureExtractor(device="cpu")(
        sig[:cpu_rows])["input_features"]
    _, rel_cpu = scaled_err(got[:cpu_rows].cpu(), torch.from_numpy(host))
    print(f"compat WhisperFeatureExtractor (fused, bf16x3) on B={B} x "
          f"{n // SR} s: {wall:.1f} ms a call (wall, from numpy to the "
          f"card's tensor); row 0 vs float64 golden scaled {rel:.3e}, "
          f"{cpu_rows} rows vs the shim on the CPU scaled {rel_cpu:.3e} "
          f"(limit {TOL_GOLDEN}) [{card}]")
    check(rel <= TOL_GOLDEN, f"compat vs golden {rel:.3e}")
    check(rel_cpu <= TOL_GOLDEN, f"compat vs CPU shim {rel_cpu:.3e}")
    del got, host

    cfg = fused_presets()["KALDI39"]
    paths = sorted(glob.glob(os.path.join(wav_dir, "*.wav")))

    def loader(workers: int):
        return torch.utils.data.DataLoader(
            compat.TorchWavDataset(paths), batch_size=batch, shuffle=False,
            num_workers=workers, collate_fn=compat.pad_collate)

    reset_counts()
    t0 = time.perf_counter()
    batches, arrivals = [], []
    for got in compat.FeatureLoader(loader(workers), cfg, device=device):
        batches.append(got)
        arrivals.append(time.perf_counter() - t0)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_counts("compat FeatureLoader", {"signal_features_mma":
                                         len(batches) if cuda else 0})
    same = 0
    for got, plain in zip(batches, loader(0)):
        want = extract(plain["signal"], plain["lengths"], cfg, device=device)
        check(got["keys"] == plain["keys"], "compat loader keys")
        same += all(torch.equal(got[k], getattr(want, k))
                    for k in ("features", "num_frames", "mask"))
    print(f"compat FeatureLoader over {len(paths)} WAVs ({workers} workers, "
          f"batches of {batch}): {len(batches)} batches in {wall:.2f} s "
          f"(each out at {['%.2f' % t for t in arrivals]} s: the workers' "
          f"start, then their decode), "
          f"{same} of them bit for bit extract of the same padded batch "
          f"[{card}]")
    check(same == len(batches) == -(-len(paths) // batch),
          f"compat FeatureLoader: {same} of {len(batches)} batches")


def examples_phase(reset_counts, read_counts, card: str,
                   device: str = "cuda") -> None:
    """Each example of ``tpufeat_torch.examples`` through its
    ``main(device=)`` at its own size (each checks its own outcome); none
    takes the fused route, so none launches a kernel."""
    import tempfile
    import time

    from tpufeat_torch.examples import NAMES
    for name in NAMES:
        mod = importlib.import_module(f"tpufeat_torch.examples.{name}")
        reset_counts()
        t0 = time.perf_counter()
        if name == "offline_corpus":
            with tempfile.TemporaryDirectory() as tmp:
                mod.main(tmp, device=device)
        else:
            mod.main(device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        read_counts(f"example {name}", {})
        print(f"examples {name}: main(device={device!r}) returned in "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from tpufeat_torch import FBANK80, WHISPER80, WHISPER128, MFCC13_HTK
    import time

    from tpufeat_torch import FeatureConfig, extract
    from tpufeat_torch import cpp_golden, framing, matrices, spectrum
    from tpufeat_torch import streaming
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
    # the native C++ decoder and goldens (cpp_ref/mfcc.cc with g++): the
    # corpus phase decodes with it and fails without it
    t0 = time.perf_counter()
    check(cpp_golden.available(), "cpp_ref/mfcc.cc did not build with g++")
    print(f"build: {cpp_golden.library_path()} in "
          f"{time.perf_counter() - t0:.2f} s (g++)")
    for line in built.log.splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or "Compiling entry" in line or ": nvcc " in line) \
                and "(C7519)" not in line:   # wgmma's injected arrives
            print("  ptxas:", line.strip())
    for n_mels in (26, 40, 80, 128):
        for prec in PRECISIONS:
            smem, blocks, regs, spill = signal.mma_resources(
                dataclasses.replace(MFCC13_HTK, n_mels=n_mels,
                                    matmul_precision=prec))
            print(f"  tensor-core signal kernel (K1 and K3) for "
                  f"{n_mels}-mel at {prec}: {smem} B dynamic shared "
                  f"memory per block, {blocks} blocks per SM, {regs} "
                  f"registers a thread at launch, {spill} B of local "
                  f"memory (spills) a thread")
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
            for n_frames in (1, tf - 1, tf, tf + 1, tm - 1, tm, tm + 1,
                             2 * tm + 1, 3000):
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
    sig = main_batch()
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

    # 9b-d. the other front-end families on the same batch; the stream pool
    # at serving size; the corpus pipeline over a directory of WAVs
    for row, err in families_phase(sig, reset_counts, read_counts,
                                   card).items():
        kernel_rows[row]["max_abs_err"] = max(
            kernel_rows[row]["max_abs_err"], err)
    pool_phase(STREAMS, STEPS, 256, reset_counts, read_counts, card)
    corpus_phase(256, reset_counts, read_counts, card)

    # 9e. 48 kHz capture with Kaldi pitch: the online pipeline, offline
    # resample -> extract -> pitch_features, and the pool over it
    for row, err in rate_pitch_phase(reset_counts, read_counts,
                                     card).items():
        kernel_rows[row]["max_abs_err"] = max(
            kernel_rows[row]["max_abs_err"], err)

    # 9f. the speaker stack: training, the online pipeline with i-vectors
    # (142-dim rows) and its pool, offline i-vectors and fMLLR, diarization
    speaker_phase(sig, reset_counts, read_counts, card)

    # 9g. the ASR models fed by the front-end: serving (whisper-tiny and
    # conformer-small through asr_forward, K1 on the path) and the CTC,
    # RNN-T and x-vector training steps
    models_phase(sig, reset_counts, read_counts, card)

    # 9h-j. multi-device extraction and training over torch.distributed (a
    # one-rank NCCL group, four gloo ranks sharing the card, --dp); the
    # toolchain shims; the examples. The corpus phase's WAVs once more
    import tempfile
    with tempfile.TemporaryDirectory() as wav_dir:
        write_corpus(wav_dir, 256)
        sharding_phase(sig, wav_dir, reset_counts, read_counts, card)
        compat_phase(sig, wav_dir, reset_counts, read_counts, card)
    examples_phase(reset_counts, read_counts, card)

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
              f"most in one window of {tolerance.FLIP_WINDOW} frames "
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
