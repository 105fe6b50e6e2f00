"""The JAX side of ``tests/test_torch_pitch.py``,
``tests/test_torch_resample.py`` and
``tests/test_torch_streaming_pipeline_rate_pitch.py``: the reference's
online pitch tracker, its ``StreamingPipeline`` with ``pitch=`` and
``input_rate=``, and its ``StreamingResampler`` fed the cases' chunks.

Run as a script (``python tests/_jax_pitch_oracle.py OUT.npz [GROUP
...]``, the groups among :data:`GROUPS`, all by default) in a process of
its own: XLA:CPU has crashed compiling the streaming-pitch
Viterbi in long-lived test processes (``tests/_streaming_pipeline_cases.py``
runs those reference tests in a subprocess for the same reason).
Importing this module imports no jax: the test files read the cases and
the inputs from it. States the reference saves mid-stream go to
:func:`state_path`.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np


def tone(f0: float, n: int, seed: int, sr: int = 16000,
         amp: float = 0.3) -> np.ndarray:
    """``tests/test_pitch.py``'s tone: a sine, its second harmonic and a
    little noise."""
    t = np.arange(n) / sr
    sig = amp * np.sin(2 * np.pi * f0 * t)
    sig += 0.1 * amp * np.sin(2 * np.pi * 2 * f0 * t + 0.3)
    sig += 0.01 * np.random.default_rng(seed).standard_normal(n)
    return sig.astype(np.float32)


def voiced(b: int, n: int, seed: int, sr: int = 16000) -> np.ndarray:
    """``tests/_streaming_pipeline_cases.py``'s voiced rows: one steady
    tone a row (120, 180, ... Hz) and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 120.0 + 60.0 * np.arange(b)[:, None]
    x = 0.4 * np.sin(2 * np.pi * f0 * t[None, :])
    return (x + 0.01 * rng.standard_normal((b, n))).astype(np.float32)


def noise(b: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)) * 0.1).astype(np.float32)


#: StreamingPitch / StreamingPitchFeatures cases: name -> (kind, signal,
#: PitchConfig changes, lookahead, plan, state saved after this many
#: chunks or None)
PITCH = {
    "track/k7": ("track", lambda: tone(150.0, 14000, 13)[None], {}, 7,
                 [1000, 3000, 750, 4250, 5000], None),
    "features/k9": ("features", lambda: tone(170.0, 12000, 21)[None],
                    dict(ballast=0.0), 9, [7000, 5000], 1),
}

#: StreamingPipeline cases: name -> (signal at the input rate, KALDI39
#: changes, pipeline options, plan, state saved after this many chunks or
#: None). Kept to two: the reference compiles each chunk shape's pitch
#: step, about 10 s a case here.
SLIDING = dict(cmvn="sliding", cmvn_window=30, cmvn_min_window=10)
PIPE = {
    "rate48/nocmvn": (lambda: noise(2, 96000, 91), dict(cmvn="none"),
                      dict(input_rate=48000),
                      [4800, 333, 14400, 48000, 28467], None),
    "rate48_pitch/sliding": (lambda: voiced(2, 48000, 93, sr=48000),
                             SLIDING, dict(input_rate=48000, pitch=True),
                             [4800] * 10, 4),
}

#: StreamingResampler cases: name -> (rates, signal, plan, state saved
#: after this many chunks)
RESAMPLER = {
    "44100": ((44100, 16000), lambda: noise(1, 9000, 3), [4000, 5000], 1),
    "48000": ((48000, 16000), lambda: noise(2, 24000, 5), [1536] * 15
              + [960], 7),
}


def state_path(out: str, case: str) -> str:
    """Where the reference's state of ``case`` is saved beside ``out``."""
    return f"{out}.{case.replace('/', '-')}.state.npz"


GROUPS = ("pitch", "pipeline", "resampler")


def main(out: str, groups=GROUPS) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tpufeat import pitch, resampling, streaming
    from tpufeat.config import KALDI39

    results = {}

    def feed(obj, x, plan, save_at, name, state):
        outs, pos = [], 0
        for k, c in enumerate(plan):
            if k == save_at:
                streaming.save_state(state_path(out, name), state())
                results[f"{name}/at"] = np.asarray(pos)
            outs.append(obj.process(x[:, pos: pos + c]))
            pos += c
        assert pos == x.shape[1]
        outs.append(obj.flush())
        return outs

    pitch_cases = PITCH if "pitch" in groups else {}
    pipe_cases = PIPE if "pipeline" in groups else {}
    resampler_cases = RESAMPLER if "resampler" in groups else {}
    for name, (kind, sig, change, k, plan, save_at) in pitch_cases.items():
        cfg = dataclasses.replace(pitch.PitchConfig(), **change)
        x = sig()
        if kind == "track":
            sp = pitch.StreamingPitch(cfg, batch_size=x.shape[0],
                                      lookahead=k)
            outs = feed(sp, x, plan, save_at, name, lambda: sp.state)
            results[f"{name}/hz"] = np.concatenate(
                [np.asarray(o[0]) for o in outs], axis=1)
            results[f"{name}/pov"] = np.concatenate(
                [np.asarray(o[1]) for o in outs], axis=1)
        else:
            spf = pitch.StreamingPitchFeatures(cfg, batch_size=x.shape[0],
                                               lookahead=k)
            outs = feed(spf, x, plan, save_at, name, spf.state)
            results[name] = np.concatenate([np.asarray(o) for o in outs],
                                           axis=1)

    for name, (sig, change, opts, plan, save_at) in pipe_cases.items():
        cfg = dataclasses.replace(KALDI39, **change)
        x = sig()
        kw = dict(opts)
        pipe = streaming.StreamingPipeline(cfg, batch_size=x.shape[0],
                                           **kw)
        outs = feed(pipe, x, plan, save_at, name, pipe.state)
        results[name] = np.concatenate([np.asarray(o) for o in outs],
                                       axis=1)

    for name, ((sr_in, sr_out), sig, plan, save_at) in \
            resampler_cases.items():
        x = sig()
        r = resampling.StreamingResampler(sr_in, sr_out, x.shape[0])
        outs, pos = [], 0
        for k, c in enumerate(plan):
            if k == save_at:
                st = r.state()
                for key, v in st.items():
                    results[f"resampler/{name}/state/{key}"] = np.asarray(v)
                results[f"resampler/{name}/at"] = np.asarray(pos)
            outs.append(np.asarray(r.process(x[:, pos: pos + c])))
            pos += c
        outs.append(np.asarray(r.flush()))
        results[f"resampler/{name}"] = np.concatenate(outs, axis=1)
    np.savez(out, **results)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1], sys.argv[2:] or GROUPS)
