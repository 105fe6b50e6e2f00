"""Online serving loop, end to end.

A live 48 kHz "microphone" stream drives the full online chain: the
streaming resampler (48k -> 16k, inside StreamingPipeline) -> front-end ->
online deltas -> sliding CMVN, with StreamingEnergyVAD +
StreamingEndpointer as the host-side utterance control loop.

    python -m tpufeat_torch.examples.online_serving [--device cpu]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np


def main(device=None):
    import tpufeat_torch as tt
    from tpufeat_torch import features

    device = features.default_device(device)
    # 3 s of speech-like tone bursts, then 2 s of near-silence, at 48 kHz
    rng = np.random.default_rng(0)
    sr_mic = 48000
    x = 1e-4 * rng.standard_normal(5 * sr_mic).astype(np.float32)
    t = np.arange(3 * sr_mic) / sr_mic
    x[: 3 * sr_mic] += (0.4 * np.sin(2 * np.pi * 220 * t)
                        * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
                        ).astype(np.float32)

    cfg = dataclasses.replace(tt.KALDI39, cmvn="sliding")
    pipe = tt.StreamingPipeline(cfg, input_rate=sr_mic, device=device)
    vad = tt.StreamingEnergyVAD(device=device)
    ep = tt.StreamingEndpointer()

    chunk = 4800                       # 100 ms at the mic rate
    rows = 0
    for i in range(0, len(x), chunk):
        c48 = x[None, i: i + chunk]
        rows += pipe.process(c48).shape[1]
        # VAD runs on the 16 kHz grid: resample a control copy (cheap at
        # 100 ms)
        c16 = tt.resample(c48, sr_mic, 16000, device=device)
        done = ep.update(vad.process(c16))
        if done[0]:
            print(f"endpoint at {(i + chunk) / sr_mic:.1f} s "
                  f"({rows} feature rows emitted)")
            break
    rows += pipe.flush().shape[1]
    print(f"total {rows} x {pipe.out_dim}-dim rows; "
          f"state checkpoint keys: {sorted(pipe.state())}")
    assert rows > 0 and done[0]


if __name__ == "__main__":
    from tpufeat_torch.examples import run
    sys.exit(run("online_serving", main))
