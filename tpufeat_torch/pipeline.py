"""Offline corpus pipeline: a directory of WAVs -> features, on the card —
counterpart of ``tpufeat/pipeline.py``.

A host thread decodes batch k+1 (on the native C++ decoder's threads,
``cpp_golden.read_wav_batch``, when it builds; else the port's Python WAV
reader) into a pinned host arena while batch k is uploaded with a
``non_blocking`` copy, extracted on the card and fetched. Length bucketing
(``data.bucket_length``) keeps the corpus at a handful of batch shapes.
The reference's int16 upload and overlapped fetch are not kept: the pass
is bound by the decode on the host, and on an H100 each of them made it
slower (``chip_smoke.py``'s corpus phase measures all four settings).

  python -m tpufeat_torch.pipeline /corpus/wavs feats.ark --preset kaldi39

``resample=True`` / ``--resample`` takes corpora of mixed rates: a batch
(one rate, from the bucketing) is resampled on ``device`` by the decode
thread, as part of getting the batch ready, so the card's side only ever
sees ``cfg.sample_rate``.

``ivector=`` / ``--ivector-extractor`` adds one utterance i-vector per
file (``ivector-extract``), written with ``--ivector-ark``;
``--fmllr-ubm`` estimates one fMLLR transform per speaker
(``gmm-est-fmllr``), written with ``--fmllr-ark``; both on ``device``.

Not ported yet, and refused with ``NotImplementedError``: ``dp=`` /
``--dp`` (ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Iterator

import numpy as np
import torch

from tpufeat_torch import cli, data, features, feats_io, fmllr, io
from tpufeat_torch import ivector as ivmod
from tpufeat_torch import resampling
from tpufeat_torch.config import PRESETS, FeatureConfig

#: extract-segments' end-time forgiveness: segment specs are usually
#: written against rounded durations, so an end that overshoots the file
#: by up to this many seconds is clamped; beyond it the line is an error.
SEGMENT_END_TOLERANCE_S = 0.1

#: the name of the decode thread (one at a time, joined before the
#: generator returns, raises or is closed)
DECODE_THREAD = "tpufeat_torch-decode"


def _refuse(what: str, item: int) -> None:
    raise NotImplementedError(f"{what} is not ported to tpufeat_torch yet: "
                              f"ROADMAP.md queue 1, item {item}")


def _native(native: bool | None) -> bool:
    """Whether to decode with the C++ decoder: ``native`` as in
    ``io.read_wav`` (None: when it builds)."""
    if native is None:
        from tpufeat_torch import cpp_golden
        return cpp_golden.available()
    return native


def _scan_corpus(wav_dir: str, native: bool | None = None
                 ) -> list[tuple[str, int, int]]:
    """[(path, n_samples, rate)] from the WAV headers alone (no decode):
    the C++ parser's header scan when ``native`` (as in ``io.read_wav``),
    this package's parser for what it cannot read."""
    from tpufeat_torch import cpp_golden
    use_native = _native(native)
    out = []
    for root, _, names in sorted(os.walk(wav_dir)):
        for name in sorted(names):
            if name.lower().endswith(".wav"):
                full = os.path.join(root, name)
                header = None
                if use_native:
                    try:
                        header = cpp_golden.wav_header(full)
                    except ValueError:
                        pass
                n, rate = header or io.wav_info(full)
                out.append((full, n, rate))
    return out


def _read_segments(path: str) -> list[tuple[str, str, float, float]]:
    """Kaldi ``segments`` file: ``<utt-id> <rec-id> <start-s> <end-s>`` per
    line. Recording ids name corpus files by relpath (``sub/a.wav``) or
    sanitized stem (``sub/a``), the key scheme of utt2spk."""
    out = []
    seen = set()
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 4:
                raise ValueError(f"{path}:{ln}: expected '<utt> <rec> "
                                 f"<start> <end>', got {line!r}")
            utt, rec, start, end = parts
            try:
                start_f, end_f = float(start), float(end)
            except ValueError:
                raise ValueError(f"{path}:{ln}: non-numeric times "
                                 f"{start!r} {end!r}") from None
            if utt in seen:
                raise ValueError(f"{path}:{ln}: duplicate utterance "
                                 f"{utt!r}")
            if not 0.0 <= start_f < end_f:
                raise ValueError(f"{path}:{ln}: need 0 <= start < end, "
                                 f"got [{start_f}, {end_f}]")
            seen.add(utt)
            out.append((utt, rec, start_f, end_f))
    return out


def _segment_entries(segments_path: str, entries, wav_dir: str):
    """Resolve a segments file against the scanned corpus: each segment
    becomes one entry (path, n_samples, rate, offset, utt_id)."""
    by_key: dict[str, tuple[str, int, int]] = {}
    for e in entries:
        rel = os.path.relpath(e[0], wav_dir)
        by_key[rel] = e
        by_key.setdefault("_".join(os.path.splitext(rel)[0].split()), e)
    out = []
    for utt, rec, start, end in _read_segments(segments_path):
        if rec not in by_key:
            raise ValueError(f"{segments_path}: recording {rec!r} not "
                             f"found under {wav_dir}")
        path, n, rate = by_key[rec]
        s = int(round(start * rate))
        t = int(round(end * rate))
        if s >= n:
            raise ValueError(f"{segments_path}: {utt!r} starts at sample "
                             f"{s} but {rec!r} has only {n}")
        if t > n:
            if (t - n) / rate > SEGMENT_END_TOLERANCE_S:
                raise ValueError(
                    f"{segments_path}: {utt!r} ends {(t - n) / rate:.3f} s "
                    f"past the end of {rec!r} (tolerance "
                    f"{SEGMENT_END_TOLERANCE_S} s)")
            t = n
        out.append((path, t - s, rate, s, utt))
    return out


def _plan_batches(entries, batch_size: int, grid: float = 2 ** 0.5
                  ) -> list[tuple[list, int, int, int]]:
    """Bucket by (rate, padded length) -> [(entries, padded_len,
    padded_rows, rate)]. A bucket's remainder batch is padded up to
    ``batch_size`` zero rows (length 0, masked out) when the bucket has a
    full batch too, so the bucket keeps one shape."""
    buckets: dict[tuple[int, int], list] = {}
    for e in entries:
        key = (e[2], data.bucket_length(e[1], grid=grid))
        buckets.setdefault(key, []).append(e)
    plans = []
    for rate, width in sorted(buckets):
        group = buckets[(rate, width)]
        for i in range(0, len(group), batch_size):
            part = group[i: i + batch_size]
            rows = batch_size if len(group) >= batch_size else len(part)
            plans.append((part, width, rows, rate))
    return plans


def _decode_batch(entries, width: int, rows: int, sample_rate: int,
                  native: bool | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """A zero-padded [rows, width] f32 arena of the batch (rows >=
    len(entries); extra rows stay zero with length 0) and its lengths.
    Whole files decode on the C++ decoder's threads when ``native`` (as in
    ``io.read_wav``); a batch it cannot read, or not at ``sample_rate``,
    decodes again file by file, which raises the reason. Segment entries
    slice their recording, each recording decoded once."""
    if entries and len(entries[0]) != 5 and _native(native):
        from tpufeat_torch import cpp_golden
        arena, n, rates = cpp_golden.read_wav_batch(
            [e[0] for e in entries], width)
        if (n >= 0).all() and (rates == sample_rate).all():
            if rows > len(entries):        # a bucket's remainder batch
                arena = np.concatenate([arena, np.zeros(
                    (rows - len(entries), width), np.float32)])
            lengths = np.zeros(rows, np.int32)
            lengths[: len(entries)] = n
            return arena, lengths
    arena = np.zeros((rows, width), np.float32)
    lengths = np.zeros(rows, np.int32)
    cache: dict[str, np.ndarray] = {}
    for b, e in enumerate(entries):
        path, n = e[0], e[1]
        offset = e[3] if len(e) == 5 else 0
        if path not in cache:
            s, r = io.read_wav(path, native=native)
            if r != sample_rate:
                raise ValueError(f"{path}: rate {r} != {sample_rate}; "
                                 "resample it first")
            cache[path] = s
        seg = cache[path][offset: offset + n]
        arena[b, : len(seg)] = seg
        lengths[b] = len(seg)
    return arena, lengths


def _pinned(arena: np.ndarray, pin: bool) -> torch.Tensor:
    """The arena as the host tensor to upload, page-locked when ``pin``
    (the card's ``non_blocking`` copies need it)."""
    t = torch.from_numpy(arena)
    return t.pin_memory() if pin else t


def _rows(res: features.FeatureResult, entries) -> list:
    """(key, [F, D] float32 features) per utterance of a batch, valid
    frames only, on the host (bfloat16 output comes back as float32: numpy
    has no bf16). Segment entries carry their utterance id, whole files
    their path."""
    feats = res.features.cpu().float().numpy()
    nf = res.num_frames.cpu().numpy()
    return [(e[4] if len(e) == 5 else e[0], feats[b, : nf[b]])
            for b, e in enumerate(entries)]


def extract_corpus(wav_dir: str, cfg: FeatureConfig, batch_size: int = 64,
                   stats: dict | None = None,
                   generator: torch.Generator | None = None,
                   resample: bool = False, dp: bool = False,
                   segments: str | None = None, ivector=None,
                   ivectors: dict | None = None,
                   bucket_grid: float = 2 ** 0.5, native: bool | None = None,
                   device=None) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (wav_path, features [F, D]) for every WAV under ``wav_dir``,
    computed on ``device`` (default the card).

    ``segments``: a Kaldi ``segments`` file; each segment is one
    utterance, sliced from its recording and bucketed by its own length,
    and the iterator yields ``(utt_id, features)``.

    Batch k+1 decodes on a host thread while batch k is on the card;
    batches are length-bucketed (``bucket_grid``: the geometric step) and
    padding frames are stripped before yielding.

    ``generator``: the dither's noise source on ``device``, required iff
    ``cfg.dither > 0``; the batches draw from it in turn.

    ``ivector``: an :class:`tpufeat_torch.ivector.IvectorExtractor` trained
    on this config's features; each batch also computes one utterance
    i-vector per row (masked batched statistics and one K×K solve on
    ``device``) into the ``ivectors`` dict (``{key: [K] float32}``, the
    ``ivector-extract`` flow; write it with
    ``feats_io.write_kaldi_vec_ark``).

    ``resample``: accept files at other rates than ``cfg.sample_rate``;
    each such batch is resampled on ``device`` in the decode thread (a
    padded row's valid prefix resamples as the lone file does: the
    resampler zero-pads its edges), and the features equal ``extract`` of
    ``resampling.resample`` of each file.

    ``native``: decode with the C++ decoder (``io.read_wav``'s argument:
    None prefers it when it builds, True requires it, False decodes in
    Python).

    ``stats``: a dict to fill with ``files``, ``batches``, ``audio_s``,
    ``device_s`` (upload, dispatch and waiting for the features: the
    consumer's time between items is not in it), ``decode_s`` (the decode
    thread's time), ``decode_wait_s`` (the time the card's side waited for
    a decode: 0 when decoding hid behind the card), ``n_shapes`` (distinct
    batch shapes) and ``padding_waste`` (the share of padded samples).

    The decode thread is joined before the generator returns, raises or is
    closed by its consumer."""
    if dp:
        _refuse("extract_corpus's dp=", 13)
    device = features.default_device(device)
    if cfg.dither > 0 and generator is None:
        raise ValueError("cfg.dither > 0 requires a generator: "
                         "extract_corpus(..., generator=torch.Generator("
                         "device).manual_seed(s))")
    entries = _scan_corpus(wav_dir, native)
    if segments is not None:
        entries = _segment_entries(segments, entries, wav_dir)
    if not entries:
        return
    bad = [e for e in entries if e[2] != cfg.sample_rate]
    if bad and not resample:
        raise ValueError(
            f"{len(bad)} file(s) not at {cfg.sample_rate} Hz (first: "
            f"{bad[0][0]} @ {bad[0][2]}); resample them first, or pass "
            "resample=True / --resample")
    if ivector is not None:
        if ivectors is None:
            raise ValueError("ivector= needs an ivectors= dict to fill")
        if ivector.ubm.dim != cfg.feature_dim:
            raise ValueError(
                f"ivector UBM dim {ivector.ubm.dim} != cfg.feature_dim "
                f"{cfg.feature_dim} (train the extractor on this "
                "config's features)")
    plans = _plan_batches(entries, batch_size, bucket_grid)
    pin = device.type == "cuda"

    decoded: dict = {}
    clock = {"decode_s": 0.0, "decode_wait_s": 0.0, "device_s": 0.0}

    def decode(i: int) -> None:
        t0 = time.perf_counter()
        batch_entries, width, rows, rate = plans[i]
        try:
            arena, lengths = _decode_batch(batch_entries, width, rows, rate,
                                           native)
            x = _pinned(arena, pin)
            if rate != cfg.sample_rate:
                x = resampling.resample(x.to(device, non_blocking=True),
                                        rate, cfg.sample_rate)
                p, q = resampling._rational(rate, cfg.sample_rate)
                lengths = np.array([resampling.output_length(int(n), p, q)
                                    for n in lengths], np.int32)
            decoded[i] = (x, lengths)
        except Exception as e:          # raised again by the consumer side
            decoded[i] = e
        clock["decode_s"] += time.perf_counter() - t0

    shapes = set()
    true_samples = padded_samples = 0
    audio_seconds = 0.0
    thread = None
    t0 = time.perf_counter()
    decode(0)
    clock["decode_wait_s"] += time.perf_counter() - t0
    try:
        for i, (batch_entries, _, _, _) in enumerate(plans):
            if thread is not None:
                t0 = time.perf_counter()
                thread.join()
                clock["decode_wait_s"] += time.perf_counter() - t0
                thread = None
            got = decoded.pop(i)
            if isinstance(got, Exception):
                raise got
            arena, lengths = got
            if i + 1 < len(plans):
                thread = threading.Thread(target=decode, args=(i + 1,),
                                          name=DECODE_THREAD, daemon=True)
                thread.start()
            true_samples += int(lengths.sum())
            padded_samples += arena.numel()
            audio_seconds += float(lengths.sum()) / cfg.sample_rate
            shapes.add(tuple(arena.shape))
            t0 = time.perf_counter()
            x = arena.to(device, non_blocking=True)
            lx = torch.from_numpy(lengths).to(device, non_blocking=True)
            res = features.extract(x, lx, cfg, generator=generator)
            rows = _rows(res, batch_entries)
            if ivector is not None:
                ivb = ivmod.utterance_ivector(
                    ivector, res.features.float(), res.mask).cpu().numpy()
                for b, (key, _) in enumerate(rows):
                    ivectors[key] = ivb[b]
            clock["device_s"] += time.perf_counter() - t0
            yield from rows                 # the consumer's time is its own
    finally:
        if thread is not None:
            thread.join()
    if stats is not None:
        stats.update(
            files=len(entries), batches=len(plans),
            audio_s=round(audio_seconds, 1),
            device_s=round(clock["device_s"], 4),
            decode_s=round(clock["decode_s"], 4),
            decode_wait_s=round(clock["decode_wait_s"], 4),
            n_shapes=len(shapes),
            padding_waste=round(1.0 - true_samples / max(padded_samples, 1),
                                4))


def _read_utt2spk(path: str) -> dict[str, str]:
    """Kaldi utt2spk map: one ``<utt-key> <speaker>`` pair per line. Keys
    may be corpus relpaths (``sub/a.wav``) or their sanitized stems
    (``sub/a``)."""
    out: dict[str, str] = {}
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(
                    f"{path}:{ln}: expected '<utt> <spk>', got {line!r}")
            if parts[0] in out:
                raise ValueError(
                    f"{path}:{ln}: duplicate utterance {parts[0]!r}")
            out[parts[0]] = parts[1]
    return out


def _spk_of(utt2spk: dict[str, str], rel: str) -> str:
    if rel in utt2spk:
        return utt2spk[rel]
    stem = "_".join(os.path.splitext(rel)[0].split())
    if stem in utt2spk:
        return utt2spk[stem]
    raise ValueError(f"utt2spk has no entry for {rel!r} (or {stem!r})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpufeat_torch.pipeline",
        description="extract features for a directory of WAVs on a CUDA "
                    "card")
    p.add_argument("wav_dir")
    p.add_argument("out_npz",
                   help="output archive: .npz, or .ark for a Kaldi "
                        "binary archive + .scp index")
    p.add_argument("--preset", default="mfcc13", choices=sorted(PRESETS))
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; refuses to run without a card), "
                        "cuda:N or cpu")
    p.add_argument("--fused", action="store_true",
                   help="the card's kernel route: use_pallas + gemm_dft + "
                        "fused_framing at bf16x3")
    p.add_argument("--global-cmvn", metavar="STATS", default=None,
                   help="accumulate corpus-level CMVN statistics over all "
                        "valid frames and write them (Kaldi "
                        "compute-cmvn-stats; .ark writes Kaldi binary "
                        "double-matrix stats, anything else npz)")
    p.add_argument("--apply-cmvn", metavar="STATS", default=None,
                   help="normalize every utterance against previously "
                        "computed corpus statistics (mean; --norm-vars "
                        "for variance too)")
    p.add_argument("--norm-vars", action="store_true")
    p.add_argument("--utt2spk", metavar="FILE", default=None,
                   help="Kaldi utt2spk map ('<utt> <spk>' per line; utts "
                        "by corpus relpath or sanitized stem): "
                        "--global-cmvn/--apply-cmvn become per-speaker "
                        "statistics (one DM entry per speaker, .ark)")
    p.add_argument("--segments", metavar="FILE", default=None,
                   help="Kaldi segments file ('<utt> <rec> <start-s> "
                        "<end-s>' per line): features per segment, keyed "
                        "by utterance id")
    p.add_argument("--apply-fmllr", metavar="ARK", default=None,
                   help="apply per-speaker affine transforms (an FM "
                        "matrix archive keyed by speaker, or 'global') to "
                        "every utterance (transform-feats)")
    p.add_argument("--bucket-grid", type=float, default=2 ** 0.5,
                   help="geometric length-bucket step (default sqrt(2): "
                        "about two batch shapes per octave of length)")
    p.add_argument("--repeat", type=int, default=1,
                   help="passes over the corpus; the last pass's wall "
                        "time is reported")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override a FeatureConfig field (cli semantics; "
                        "repeatable)")
    p.add_argument("--resample", action="store_true",
                   help="accept WAVs at other rates: each batch is "
                        "resampled to the config's rate on the device")
    p.add_argument("--ivector-extractor", metavar="NPZ", default=None,
                   help="IvectorExtractor.save() file trained on this "
                        "preset's features: one utterance i-vector per "
                        "file (ivector-extract)")
    p.add_argument("--ivector-ark", metavar="ARK", default=None,
                   help="where to write the i-vectors (Kaldi binary FV "
                        "vector archive + .scp index); requires "
                        "--ivector-extractor")
    p.add_argument("--fmllr-ubm", metavar="NPZ", default=None,
                   help="DiagUbm.save() file trained on this preset's "
                        "(post-CMVN) features: accumulate fMLLR statistics "
                        "and estimate affine transforms (gmm-est-fmllr), "
                        "one per --utt2spk speaker or a single 'global' "
                        "entry; requires --fmllr-ark")
    p.add_argument("--fmllr-ark", metavar="ARK", default=None,
                   help="where to write the [D, D+1] fMLLR transforms "
                        "(Kaldi binary FM matrix archive + .scp index), "
                        "keyed by speaker")
    p.add_argument("--fmllr-min-count", type=float, default=500.0,
                   help="frames below which a speaker keeps the identity "
                        "transform (Kaldi --fmllr-min-count)")
    p.add_argument("--dp", default=None, nargs="?", const=True,
                   help="not ported yet: ROADMAP.md queue 1, item 13")
    return p


def _estimate_fmllr(ubm: ivmod.DiagUbm, rows: list, batch: int,
                    min_count: float, device) -> dict:
    """Per-speaker fMLLR transforms from ``rows`` [(speaker, [F, D]
    features)]: per-row statistics in padded batches of at most ``batch``
    rows, bucketed on a frame-domain length grid, summed per speaker in
    float64, then estimated -> {speaker: [D, D+1] float32}."""
    acc: dict = {}
    by_bucket: dict = {}
    for spk, feats in rows:
        nb = data.bucket_length(max(feats.shape[0], 1), minimum=128)
        by_bucket.setdefault(nb, []).append((spk, feats))
    step = max(batch, 1)
    for nb, group in by_bucket.items():
        for j in range(0, len(group), step):
            part = group[j: j + step]
            pad = np.zeros((len(part), nb, ubm.dim), np.float32)
            nf = np.zeros(len(part), np.int32)
            for i, (_, f) in enumerate(part):
                pad[i, : f.shape[0]] = f
                nf[i] = f.shape[0]
            bs, Ks, Gs = fmllr.fmllr_stats(ubm, pad, nf, per_row=True,
                                           device=device)
            for i, (spk, _) in enumerate(part):
                a = acc.get(spk)
                if a is None:
                    acc[spk] = [bs[i], Ks[i], Gs[i]]
                else:
                    a[0] += bs[i]
                    a[1] += Ks[i]
                    a[2] += Gs[i]
    return {s: fmllr.estimate_fmllr(b, K, G, min_count=min_count
                                    ).astype(np.float32)
            for s, (b, K, G) in sorted(acc.items())}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.dp is not None:
        _refuse("--dp", 13)
    cfg = cli.parse_overrides(PRESETS[args.preset], args.set)
    if args.fused:
        cfg = dataclasses.replace(cfg, use_pallas=True, gemm_dft=True,
                                  fused_framing=True,
                                  matmul_precision="bf16x3")
    device = cli.device_of(args.device)
    utt2spk = _read_utt2spk(args.utt2spk) if args.utt2spk else None
    if utt2spk and not all(
            p.endswith(".ark") for p in (args.global_cmvn, args.apply_cmvn)
            if p):
        raise ValueError("--utt2spk stats are per-speaker multi-entry "
                         "archives; use a .ark stats path")
    apply_stats = None
    if args.apply_cmvn:
        if utt2spk:
            apply_stats = {
                k: data.CmvnStats.from_kaldi(m) for k, m in
                feats_io.read_kaldi_ark(args.apply_cmvn).items()}
        else:
            apply_stats = data.CmvnStats.load(args.apply_cmvn)
    fmllr_ubm = None
    if args.fmllr_ubm:
        if not args.fmllr_ark:
            raise ValueError("--fmllr-ubm requires --fmllr-ark (where the "
                             "estimated transforms go)")
        fmllr_ubm = ivmod.DiagUbm.load(args.fmllr_ubm)
        if fmllr_ubm.dim != cfg.feature_dim:
            raise ValueError(
                f"fMLLR UBM dim {fmllr_ubm.dim} != feature dim "
                f"{cfg.feature_dim} (train the UBM on this preset's "
                "features)")
    elif args.fmllr_ark:
        raise ValueError("--fmllr-ark requires --fmllr-ubm")
    extractor = None
    if args.ivector_extractor:
        extractor = ivmod.IvectorExtractor.load(args.ivector_extractor)
    elif args.ivector_ark:
        raise ValueError("--ivector-ark requires --ivector-extractor")
    apply_fmllr = feats_io.read_kaldi_ark(args.apply_fmllr) \
        if args.apply_fmllr else None
    passes = []
    out: dict = {}
    stats: dict = {}
    cmvn_acc = None
    ivecs: dict = {}
    fmllr_rows: list = []
    for _ in range(max(1, args.repeat)):
        t0 = time.perf_counter()
        out, stats, ivecs, fmllr_rows = {}, {}, {}, []
        cmvn_acc = (({} if utt2spk else data.CmvnStats(cfg.feature_dim))
                    if args.global_cmvn else None)
        for key, feats in extract_corpus(
                args.wav_dir, cfg, args.batch, stats=stats,
                segments=args.segments, bucket_grid=args.bucket_grid,
                resample=args.resample, ivector=extractor,
                ivectors=ivecs if extractor else None, device=device):
            # segments mode yields utterance ids; whole-file mode paths
            rel = key if args.segments \
                else os.path.relpath(key, args.wav_dir)
            spk = _spk_of(utt2spk, rel) if utt2spk else None
            if cmvn_acc is not None:
                acc = cmvn_acc if spk is None else cmvn_acc.setdefault(
                    spk, data.CmvnStats(cfg.feature_dim))
                acc.accumulate(feats)
            if apply_stats is not None:
                st = apply_stats if spk is None else apply_stats.get(spk)
                if st is None:
                    raise ValueError(
                        f"{args.apply_cmvn}: no CMVN stats for speaker "
                        f"{spk!r} (utterance {rel!r})")
                feats = st.apply(feats, norm_vars=args.norm_vars)
            if apply_fmllr is not None:
                W = apply_fmllr.get(spk if spk is not None else "global")
                if W is None:
                    raise ValueError(
                        f"{args.apply_fmllr}: no fMLLR transform for "
                        f"speaker {spk or 'global'!r} (utterance {rel!r})")
                feats = data.apply_transform(feats, W).numpy()
            if fmllr_ubm is not None:
                fmllr_rows.append((spk if spk is not None else "global",
                                   feats))
            out[rel] = feats
        passes.append(time.perf_counter() - t0)
    if cmvn_acc is not None:
        if utt2spk:
            feats_io.write_kaldi_ark(
                args.global_cmvn,
                {s: st.to_kaldi() for s, st in sorted(cmvn_acc.items())},
                dtype="f64")
        else:
            cmvn_acc.save(args.global_cmvn)
    if fmllr_ubm is not None:
        feats_io.write_kaldi_ark(
            args.fmllr_ark,
            _estimate_fmllr(fmllr_ubm, fmllr_rows, args.batch,
                            args.fmllr_min_count, device),
            scp_path=os.path.splitext(args.fmllr_ark)[0] + ".scp")
    dt = passes[-1]
    if args.out_npz.lower().endswith(".ark"):
        keys = feats_io.ark_keys(list(out))
        feats_io.write_kaldi_ark(
            args.out_npz, dict(zip(keys, out.values())),
            scp_path=os.path.splitext(args.out_npz)[0] + ".scp")
    else:
        np.savez(args.out_npz, **out)
    if extractor is not None and args.ivector_ark:
        # the feature archive's sanitized key scheme
        rels = [k if args.segments else os.path.relpath(k, args.wav_dir)
                for k in ivecs]
        feats_io.write_kaldi_vec_ark(
            args.ivector_ark, dict(zip(feats_io.ark_keys(rels),
                                       ivecs.values())),
            scp_path=os.path.splitext(args.ivector_ark)[0] + ".scp")
    audio_s = sum(f.shape[0] for f in out.values()) * cfg.hop_length \
        / cfg.sample_rate
    print(json.dumps({"files": len(out), "audio_s": round(audio_s, 1),
                      "wall_s": round(dt, 3),
                      "rtfx": round(audio_s / max(dt, 1e-9), 1),
                      "pass_wall_s": [round(t, 3) for t in passes],
                      "device": str(device), **stats}))
    print(f"wrote {args.out_npz}: {len(out)} utterances", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
