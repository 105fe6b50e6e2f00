"""The JAX side of ``tests/test_torch_stream_pool.py``: the reference
``tpufeat.streaming.StreamPool`` driven through :data:`SCRIPT`, over each
wrapper of :data:`WRAPPERS` (the "ivector" pipeline's extractor is the one
``tests/_jax_speaker_oracle.py`` trains; its arrays go to OUT.npz as
``model/<field>``).

Run as a script (``python tests/_jax_pool_oracle.py OUT.npz``) in a process
of its own, as ``tests/_jax_pipeline_oracle.py`` runs the reference's
pipeline (XLA:CPU has crashed compiling pipeline programs in long-lived
test processes). Importing this module imports no jax: the test file
reads the script, the wrappers and the inputs from it, and drives the
port's pool with :func:`drive`.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

CAP, C = 4, 1600                    # slots, samples per tick (100 ms)
SLIDING = dict(cmvn="sliding", cmvn_window=30, cmvn_min_window=10)
#: name -> (wrapper kind, KALDI39 changes)
WRAPPERS = {
    "nocmvn": ("pipeline", dict(cmvn="none")),
    "sliding": ("pipeline", SLIDING),
    "sliding600": ("pipeline", dict(cmvn="sliding")),   # window 600, min 100
    "frontend": ("frontend", {}),
    "ivector": ("ivector", dict(cmvn="none")),
}
#: the pool's life: ("attach", n) leases n slots, ("detach", [slots])
#: returns them, ("tick", "dict") feeds every attached slot its chunk,
#: ("tick", "batch") hands the whole [CAP, C] block to process_batch
SCRIPT = (
    [("attach", 3), ("tick", "dict"), ("tick", "batch"),
     ("detach", [1]), ("attach", 1), ("tick", "dict")]
    + [("tick", "batch")] * 3
    + [("detach", [0, 2]), ("attach", 3), ("tick", "dict")]
    + [("tick", "batch")] * 65)     # past the 608 warmup rows of window 600
TICKS = sum(1 for op, _ in SCRIPT if op == "tick")


def signal(seed: int = 77) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((CAP, TICKS * C)) * 0.1).astype(np.float32)


def drive(pool, x) -> dict:
    """Run :data:`SCRIPT` on ``pool`` over the signal ``x``: {"attach/i":
    the slots the i-th attach leased, "tick/k/<slot>": tick k's rows of
    that slot, as numpy}."""
    out, k, attaches = {}, 0, 0
    for op, arg in SCRIPT:
        if op == "attach":
            out[f"attach/{attaches}"] = np.array(
                [pool.attach() for _ in range(arg)])
            attaches += 1
        elif op == "detach":
            for slot in arg:
                pool.detach(slot)
        else:
            block = x[:, k * C:(k + 1) * C]
            rows = pool.process({s: block[s] for s in pool.active}) \
                if arg == "dict" else pool.process_batch(block)
            for s in rows:
                out[f"tick/{k}/{s}"] = np.asarray(
                    rows[s].cpu() if hasattr(rows[s], "cpu") else rows[s])
            k += 1
    return out


def main(out: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tpufeat import streaming
    from tpufeat.config import KALDI39, MFCC13_HTK

    import _jax_speaker_oracle as speaker
    ext = speaker.train_extractor()
    results = speaker.model_arrays(ext)
    for name, (kind, change) in WRAPPERS.items():
        wrapper = streaming.StreamingFrontend(MFCC13_HTK, CAP) \
            if kind == "frontend" else streaming.StreamingPipeline(
                dataclasses.replace(KALDI39, **change), batch_size=CAP,
                ivector=ext if kind == "ivector" else None)
        got = drive(streaming.StreamPool(wrapper), signal())
        results.update({f"{name}/{k}": v for k, v in got.items()})
    np.savez(out, **results)


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    main(sys.argv[1])
