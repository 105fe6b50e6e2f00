"""Multi-stream serving with StreamPool — the batched control loop.

``online_serving`` walks ONE live stream end to end; this example runs the
shape production serving takes: a fixed-capacity StreamingPipeline batch
whose rows are leased and recycled across callers. Per 100 ms tick:

  1. assemble the ingest block [capacity, 1600] straight from the
     callers' buffers (unleased rows: zeros);
  2. ``pool.process_batch(block)`` — one step for every stream; consume
     the tick via ``rows.block()`` (one bulk fetch);
  3. run VAD + endpointer on the same block; where an endpoint fires:
     ``pool.detach`` -> reset the VAD/endpointer rows -> ``pool.attach``
     for the next caller (slot recycling, per-row reset).

    python -m tpufeat_torch.examples.serving_pool [--device cpu]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np


def make_caller(seed: int, speech_s: float, total_s: float, sr=16000):
    """A caller: ``speech_s`` seconds of tone bursts, then near-silence."""
    rng = np.random.default_rng(seed)
    x = 1e-4 * rng.standard_normal(int(total_s * sr)).astype(np.float32)
    n = int(speech_s * sr)
    t = np.arange(n) / sr
    x[:n] += (0.3 * np.sin(2 * np.pi * (150 + 40 * seed) * t)
              * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    return x


def main(device=None):
    import tpufeat_torch as tt
    from tpufeat_torch import augment, features

    device = features.default_device(device)
    cfg = dataclasses.replace(tt.KALDI39, cmvn="none")
    capacity, chunk = 3, 1600                      # 100 ms ticks at 16 kHz
    pool = tt.StreamPool(tt.StreamingPipeline(cfg, batch_size=capacity,
                                              device=device))
    vad = augment.StreamingEnergyVAD(batch_size=capacity, device=device)
    ep = augment.StreamingEndpointer(batch_size=capacity)

    # callers queue up; two connect immediately, one replaces the first
    # endpointed slot mid-run
    waiting = [make_caller(2, 0.8, 6.0), make_caller(3, 3.0, 6.0),
               make_caller(5, 0.8, 6.0)]
    feed = {}                                      # slot -> (signal, pos)
    for _ in range(2):
        feed[pool.attach()] = [waiting.pop(0), 0]

    emitted = {s: 0 for s in feed}
    turnovers = 0
    for tick in range(48):                         # 4.8 s of serving
        block = np.zeros((capacity, chunk), np.float32)
        for s, sp in feed.items():
            sig, pos = sp
            block[s] = sig[pos: pos + chunk]
            sp[1] += chunk
        rows = pool.process_batch(block)
        out, skips = rows.block()                  # ONE bulk fetch per tick
        for s in rows:
            emitted[s] += out.shape[1] - skips[s]
        done = ep.update(vad.process(block))
        for s in [s for s in np.flatnonzero(done) if s in feed]:
            print(f"tick {tick:2d}: endpoint on slot {s} "
                  f"({emitted[s]} rows served)")
            pool.detach(int(s))
            vad.reset_rows([int(s)])
            ep.reset_rows([int(s)])
            del feed[int(s)]
            turnovers += 1
            if waiting:                            # next caller takes it
                slot = pool.attach()
                feed[slot] = [waiting.pop(0), 0]
                emitted[slot] = 0
                print(f"         slot {slot} re-leased to a new caller")
    print(f"{turnovers} utterance turnovers on {capacity} slots; "
          f"active at shutdown: {pool.active}")
    assert turnovers >= 2 and not waiting


if __name__ == "__main__":
    from tpufeat_torch.examples import run
    sys.exit(run("serving_pool", main))
