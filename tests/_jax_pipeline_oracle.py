"""The JAX side of ``tests/test_torch_streaming_pipeline.py``: the reference
``tpufeat.streaming.StreamingPipeline`` fed the cases' chunks.

Run as a script (``python tests/_jax_pipeline_oracle.py OUT.npz``) in a
process of its own: XLA:CPU has crashed compiling StreamingPipeline
programs in long-lived test processes (``tests/test_streaming_pipeline.py``
runs the reference's own pipeline tests in a subprocess for the same
reason). Importing this module imports no jax: the test file reads
:data:`CASES` and the inputs from it.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

B, N = 2, 9600                      # two streams of 0.6 s
PLANS = {
    "steady": [1600] * 6,                           # 100 ms chunks
    "ragged": [4800, 1600, 160, 2560, 480],         # hop-aligned, ragged
    "one_frame": [160] * 60,                        # one frame a step
}
SLIDING = dict(cmvn="sliding", cmvn_window=30, cmvn_min_window=10)
NOCMVN = dict(cmvn="none")
#: name -> (KALDI39 changes, plan, pipeline options)
CASES = {
    **{f"kaldi39/{p}": ({}, p, {}) for p in PLANS},
    **{f"sliding/{p}": (SLIDING, p, {}) for p in PLANS},
    "sliding_meanvar/ragged": (dict(SLIDING, cmvn="sliding-meanvar"),
                               "ragged", {}),
    "meanvar/ragged": (dict(cmvn="meanvar"), "ragged", {}),
    "order1/ragged": (dict(NOCMVN, delta_order=1), "ragged", {}),
    "order3/ragged": (dict(NOCMVN, delta_order=3), "ragged", {}),
    "online_cmvn/ragged": (NOCMVN, "ragged", {"online_cmvn": True}),
    "transform/ragged": (NOCMVN, "ragged", {"transform": True}),
}
#: the checkpoint case: the reference's state saved after RESUME_AT chunks
RESUME_CASE, RESUME_AT = "sliding/ragged", 2


def signal(seed: int = 90) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N)) * 0.1).astype(np.float32)


def prior_frames() -> np.ndarray:
    """The frames both packages' CmvnStats priors accumulate."""
    rng = np.random.default_rng(96)
    return (rng.standard_normal((150, 39)) * 2 + 1).astype(np.float32)


def transform() -> np.ndarray:
    """An affine [20, 40] transform of 39-dim rows."""
    rng = np.random.default_rng(42)
    return np.concatenate([rng.standard_normal((20, 39)) * 0.3,
                           rng.standard_normal((20, 1))],
                          axis=1).astype(np.float32)


ONLINE_CMVN = dict(window=120, norm_vars=True)


def main(out: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tpufeat import data, streaming
    from tpufeat.config import KALDI39

    x = signal()
    spk = data.CmvnStats(39)
    spk.accumulate(prior_frames())
    results = {}
    for name, (change, plan, options) in CASES.items():
        cfg = dataclasses.replace(KALDI39, **change)
        kw = {}
        if options.get("online_cmvn"):
            kw["online_cmvn"] = streaming.OnlineCmvn(
                39, batch_size=B, speaker_stats=spk, **ONLINE_CMVN)
        if options.get("transform"):
            kw["transform"] = transform()
        pipe = streaming.StreamingPipeline(cfg, batch_size=B, **kw)
        outs, pos = [], 0
        for k, c in enumerate(PLANS[plan]):
            if name == RESUME_CASE and k == RESUME_AT:
                streaming.save_state(out + ".state.npz", pipe.state())
                results["resume/at"] = np.asarray(pos)
            outs.append(np.asarray(pipe.process(x[:, pos: pos + c])))
            pos += c
        outs.append(np.asarray(pipe.flush()))
        results[name] = np.concatenate(outs, axis=1)
    np.savez(out, **results)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1])
