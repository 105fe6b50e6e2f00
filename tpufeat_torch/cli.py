"""Command-line front-end of the port — counterpart of ``tpufeat/cli.py``:

  python -m tpufeat_torch.cli audio.wav out.npy --preset mfcc13
  python -m tpufeat_torch.cli a.wav b.wav out.npz --preset whisper80  # batch
  python -m tpufeat_torch.cli audio.wav out.npy --validate   # vs the golden
  python -m tpufeat_torch.cli audio.wav out.npy --profile DIR  # torch trace
  python -m tpufeat_torch.cli audio.wav out.htk --preset mfcc13  # HTK file
  python -m tpufeat_torch.cli a.wav b.wav out.ark --preset kaldi39  # ark+scp
  python -m tpufeat_torch.cli a48k.wav out.npy --resample --pitch

It computes on the card (``--device cuda``, the default) unless the CPU is
named (``--device cpu``); without a card the default refuses to run.
``--resample`` converts inputs at another rate with the polyphase
resampler; ``--pitch`` appends Kaldi-style pitch features.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from tpufeat_torch import features, feats_io, io
from tpufeat_torch.config import PRESETS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpufeat_torch",
        description="ASR feature extraction on a CUDA card (WAV -> "
                    "features)")
    p.add_argument("inputs", nargs="+",
                   help="input WAV file(s) followed by the output path "
                        "(.npy for one input, .npz for a batch; .htk/.mfc "
                        "writes HTK parameter files, .ark a Kaldi binary "
                        "archive + .scp index)")
    p.add_argument("--preset", default="mfcc13", choices=sorted(PRESETS),
                   help="pipeline preset (default: mfcc13)")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override a FeatureConfig field, e.g. --set n_mels=40 "
                        "--set lifter=22 (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="where to compute: cuda (default; refuses to run "
                        "without a card), cuda:N or cpu")
    p.add_argument("--validate", action="store_true",
                   help="also run the float64 NumPy golden and print the "
                        "max abs error")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of one more run "
                        "into DIR/trace.json (Chrome trace format)")
    p.add_argument("--time", action="store_true",
                   help="print wall-clock timings and RTFx")
    p.add_argument("--stream", type=int, metavar="CHUNK", default=0,
                   help="process through the streaming front-end in CHUNK-"
                        "sample chunks instead of one-shot")
    p.add_argument("--resample", action="store_true",
                   help="resample inputs whose rate differs from the "
                        "config's sample_rate (polyphase, matches "
                        "scipy.signal.resample_poly)")
    p.add_argument("--htk-compress", action="store_true",
                   help="write .htk outputs in HTKBook _C compressed "
                        "form (per-column int16 quantization, half the "
                        "file size)")
    p.add_argument("--pitch", action="store_true",
                   help="append Kaldi-style 3-dim pitch features (POV, "
                        "log-pitch, delta-log-pitch) to every frame; the "
                        "batch is truncated to the pitch tracker's frame "
                        "grid (its correlation window extends frame_length "
                        "+ max-lag samples)")
    return p


def parse_overrides(cfg, pairs):
    """``cfg`` with ``K=V`` field overrides, each value parsed as the
    field's current type (None parses as a float)."""
    fields = {f.name: f.type for f in dataclasses.fields(cfg)}
    kw = {}
    for pair in pairs:
        k, _, v = pair.partition("=")
        if k not in fields:
            raise SystemExit(f"unknown config field {k!r}; valid: "
                             f"{', '.join(sorted(fields))}")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            kw[k] = int(v)
        elif isinstance(cur, float) or cur is None:
            kw[k] = float(v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


def device_of(name: str) -> torch.device:
    """The ``--device`` argument as a device; a CUDA device without a card
    stops the command (nothing moves to the CPU unasked)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card, and torch sees "
                         "none: pass --device cpu to compute on the CPU")
    return dev


def _htk_layout(cfg):
    """(parmKind, column reorder) of an HTK file of ``cfg``'s features:
    the base kind of the family with D/A/T for the delta stages and Z for
    CMVN; c0 / energy moves last in each block, as HTKBook's _0 / _E
    order it."""
    quals = []
    if cfg.deltas:
        quals += ["D", "A", "T"][: cfg.delta_order]
    if cfg.cmvn != "none":
        quals += ["Z"]
    if cfg.plp_order > 0:
        # c0 is the residual log energy: _E, moved last in each block
        return (feats_io.parm_kind(feats_io.HTK_PLP, "E", *quals),
                lambda f: feats_io.to_htk_order(f, cfg.plp_order + 1))
    if cfg.n_mfcc > 0:
        q = ["E"] if cfg.use_energy else ["0"]
        return (feats_io.parm_kind(feats_io.HTK_MFCC, *q, *quals),
                lambda f: feats_io.to_htk_order(f, cfg.n_mfcc))
    if cfg.n_mels == 0:
        # (log-)power-spectrum features have no HTKBook base kind: USER
        return feats_io.parm_kind(feats_io.HTK_USER, *quals), lambda f: f
    if cfg.use_energy:
        # fbank with the energy column prepended (dim n_mels+1)
        return (feats_io.parm_kind(feats_io.HTK_FBANK, "E", *quals),
                lambda f: feats_io.to_htk_order(f, cfg.n_mels + 1))
    return feats_io.parm_kind(feats_io.HTK_FBANK, *quals), lambda f: f


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.inputs) < 2:
        raise SystemExit("need at least one input WAV and one output path")
    *wavs, out_path = args.inputs
    cfg = parse_overrides(PRESETS[args.preset], args.set)
    device = device_of(args.device)

    try:
        sigs, rates = zip(*(io.read_wav(w) for w in wavs))
    except FileNotFoundError as e:
        raise SystemExit(f"input not found: {e.filename}")
    sigs = list(sigs)
    for i, (w, r) in enumerate(zip(wavs, rates)):
        if r != cfg.sample_rate:
            if not args.resample:
                raise SystemExit(f"{w}: sample rate {r} != config "
                                 f"{cfg.sample_rate}; pass --resample to "
                                 "convert it")
            from tpufeat_torch import resampling
            sigs[i] = resampling.resample(sigs[i], r, cfg.sample_rate,
                                          device=device).cpu().numpy()
    lengths = np.array([len(s) for s in sigs], dtype=np.int32)
    batch = np.zeros((len(sigs), int(lengths.max())), dtype=np.float32)
    for b, s in enumerate(sigs):
        batch[b, : len(s)] = s

    def run() -> tuple[np.ndarray, np.ndarray]:
        if args.stream > 0:
            from tpufeat_torch import streaming
            fe = streaming.StreamingFrontend(cfg, batch_size=len(sigs),
                                             device=device)
            pad = (-batch.shape[1]) % args.stream
            padded = np.pad(batch, ((0, 0), (0, pad)))
            outs = [fe.process(padded[:, pos: pos + args.stream])[0]
                    for pos in range(0, padded.shape[1], args.stream)]
            streamed = torch.cat(outs, dim=1).float().cpu().numpy()
            # the batch was zero-padded (to the longest input and to a
            # chunk multiple) and the stream takes that padding for audio:
            # keep each input's own frames
            nf = np.array([cfg.num_frames(int(n)) for n in lengths])
            f = np.zeros((len(sigs), max(int(nf.max()), 1),
                          streamed.shape[-1]), np.float32)
            m = np.zeros(f.shape[:2], bool)
            for b in range(len(sigs)):
                f[b, : nf[b]] = streamed[b, : nf[b]]
                m[b, : nf[b]] = True
            return f, m
        res = features.extract(batch, lengths, cfg, device=device)
        # bfloat16 output (out_dtype) leaves as float32: numpy has no bf16
        return res.features.float().cpu().numpy(), res.mask.cpu().numpy()

    t0 = time.perf_counter()
    feats, mask = run()
    first_s = time.perf_counter() - t0

    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            run()               # its results come back to the host: synced
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profile trace written to {trace}", file=sys.stderr)

    ext = os.path.splitext(out_path)[1].lower()
    if args.pitch:
        if ext in (".htk", ".mfc", ".fea") or args.validate:
            raise SystemExit("--pitch composes with .npy/.npz/.ark outputs "
                             "only (no HTK parmKind describes appended "
                             "pitch, and --validate's goldens cover the "
                             "spectral features alone)")
        from tpufeat_torch import pitch as pitchmod
        # the tracker on the feature config's grid (rate, hop, centering),
        # so pitch frame t and spectral frame t are the same instant
        pf, pvalid = pitchmod.pitch_features(
            batch, lengths, pitchmod.config_for(cfg), device=device)
        pf, pvalid = pf.cpu().numpy(), pvalid.cpu().numpy()
        fp = min(pf.shape[1], feats.shape[1])    # the pitch window is
        feats = np.concatenate(                  # longer: truncate to it
            [feats[:, :fp], pf[:, :fp]], axis=-1)
        mask = mask[:, :fp] & pvalid[:, :fp]
    if ext in (".htk", ".mfc", ".fea"):
        # one utterance per file; a batch writes suffixed files
        kind, reorder = _htk_layout(cfg)
        shift = cfg.hop_length / cfg.sample_rate
        paths = [out_path] if len(wavs) == 1 else [
            f"{os.path.splitext(out_path)[0]}.{b}{ext}"
            for b in range(len(wavs))]
        for b, p in enumerate(paths):
            feats_io.write_htk(p, reorder(feats[b][mask[b]]),
                               frame_shift_s=shift, kind=kind,
                               compress=args.htk_compress)
    elif ext == ".ark":
        keys = feats_io.ark_keys([os.path.basename(w) for w in wavs])
        feats_io.write_kaldi_ark(
            out_path, {k: feats[b][mask[b]] for b, k in enumerate(keys)},
            scp_path=os.path.splitext(out_path)[0] + ".scp")
    elif len(wavs) == 1:
        np.save(out_path, feats[0][mask[0]])
    else:
        np.savez(out_path, features=feats, mask=mask, lengths=lengths)
    print(f"wrote {out_path}: batch={feats.shape[0]} frames={feats.shape[1]} "
          f"dim={feats.shape[2]}", file=sys.stderr)

    if args.time:
        t1 = time.perf_counter()
        run()
        steady = time.perf_counter() - t1
        audio_s = float(lengths.sum()) / cfg.sample_rate
        print(json.dumps({
            "first_run_s": round(first_s, 4),
            "steady_state_s": round(steady, 6),
            "audio_s": round(audio_s, 3),
            "rtfx": round(audio_s / steady, 1),
            "device": str(device),
        }))

    if args.validate:
        from tpufeat_torch import cpp_golden
        from tpufeat_torch.reference import cpu
        native = cpp_golden.plp_native if cfg.plp_order > 0 \
            else cpp_golden.mfcc_native
        errs = {"numpy_f64": 0.0}
        for b, s in enumerate(sigs):
            got = feats[b][mask[b]]
            gold = cpu.extract(s.astype(np.float64), cfg)
            errs["numpy_f64"] = max(errs["numpy_f64"],
                                    float(np.abs(got - gold).max()))
            if not cpp_golden.available():
                continue        # no g++: the numpy golden alone
            try:
                gold = native(s.astype(np.float64), cfg)
            except ValueError:
                continue        # the C++ golden covers classic configs only
            errs["cpp_golden"] = max(errs.get("cpp_golden", 0.0),
                                     float(np.abs(got - gold).max()))
        print(json.dumps({"max_abs_err": errs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
