"""The JAX side of ``tests/test_torch_streaming_pipeline_ivector.py`` (and
of the i-vector wrapper of ``tests/test_torch_stream_pool.py``): the
reference's ``StreamingPipeline(ivector=)`` fed the cases' chunks, over an
extractor the reference trains here on its own base features.

Run as a script (``python tests/_jax_speaker_oracle.py OUT.npz``) in a
process of its own, as the other pipeline oracles run (XLA:CPU has
crashed compiling pipeline programs in long-lived test processes).
Importing this module imports no jax: the test file reads :data:`CASES`,
the inputs and the extractor's arrays (``model/<field>`` in OUT.npz) from
it. States the reference saves mid-stream go to :func:`state_path`.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from _jax_pitch_oracle import noise, voiced

SLIDING = dict(cmvn="sliding", cmvn_window=30, cmvn_min_window=10)
MODEL_FIELDS = ("weights", "means", "vars", "M")

#: name -> (signal, KALDI39 changes, pipeline options, plan, state saved
#: after this many chunks or None)
CASES = {
    "nocmvn": (lambda: noise(2, 16000, 91), dict(cmvn="none"), {},
               [4800, 1600, 3200, 6400], None),
    "sliding_period7": (lambda: noise(2, 12800, 94), SLIDING,
                        dict(ivector_period=7, ivector_max_count=2.0),
                        [1600] * 8, 3),
    "pitch": (lambda: voiced(1, 16000, 92), dict(cmvn="none"),
              dict(pitch=True), [8000, 8000], None),
}


def state_path(out: str, case: str) -> str:
    return f"{out}.{case}.state.npz"


def train_extractor():
    """The reference's UBM (G=4) and extractor (K=4) on its KALDI39 base
    rows of seeded noise (``tests/_streaming_pipeline_cases.py``'s)."""
    from tpufeat import features
    from tpufeat import ivector as iv
    from tpufeat.config import KALDI39
    base = dataclasses.replace(KALDI39, deltas=False, cmvn="none")
    train = np.asarray(features.extract(noise(4, 16000, 90),
                                        cfg=base).features).reshape(-1, 13)
    ubm = iv.train_diag_ubm(train, 4, iters=2, final_iters=4, seed=0)
    return iv.train_ivector_extractor(ubm, [train[i::4] for i in range(4)],
                                      ivector_dim=4, iters=2, seed=1)


def model_arrays(ext) -> dict:
    return {"model/weights": ext.ubm.weights, "model/means": ext.ubm.means,
            "model/vars": ext.ubm.vars, "model/M": ext.M}


def main(out: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tpufeat import streaming
    from tpufeat.config import KALDI39

    ext = train_extractor()
    results = model_arrays(ext)
    for name, (sig, change, opts, plan, save_at) in CASES.items():
        x = sig()
        pipe = streaming.StreamingPipeline(
            dataclasses.replace(KALDI39, **change), batch_size=x.shape[0],
            ivector=ext, **opts)
        outs, pos = [], 0
        for k, c in enumerate(plan):
            if k == save_at:
                streaming.save_state(state_path(out, name), pipe.state())
            outs.append(np.asarray(pipe.process(x[:, pos: pos + c])))
            pos += c
        outs.append(np.asarray(pipe.flush()))
        results[name] = np.concatenate(outs, axis=1)
    np.savez(out, **results)


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    main(sys.argv[1])
