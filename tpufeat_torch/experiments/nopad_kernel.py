"""Port of ``benchmarks/experiments/nopad_kernel.py`` (K5a) to the Hopper
anatomy kernel (``tpufeat_torch/csrc/anatomy.cu``).

Rows of 160 samples (one hop, no pre-pad copy): a 400-sample frame spans
three rows, so frame t is rows t, t + 1 and t + 2, each contracted in
full with its own [160, 512] DFT matrix (the script's comment says
shift 2 "only needs 80", but its matrix is random over all 160 rows, so
all 160 count). One mode.

    python -m tpufeat_torch.experiments.nopad_kernel

times the mode on the card (median of CUDA-event runs) and prints
``mode: ms`` beside the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np

from tpufeat_torch.experiments import _common
from tpufeat_torch.kernels import anatomy

MODES = {"kernel": ("bf16x3", "bf16x3", "sqlog")}
SAME: dict = {}


def terms(d0, d1, d2) -> list:
    """The script's three shift matrices as the one-phase term table."""
    return [[(0, 0, d0), (1, 0, d1), (2, 0, d2)]]


def inputs(device=None, B: int = 128, F: int = 3072,
           TF: int = 512) -> _common.Inputs:
    """The script's arrays at its sizes (or smaller ones): main [B, F, 160],
    bnd [B, F/TF, 8, 160], then D0, D1, D2 [160, 512] and FB [512, 128]."""
    rng = np.random.default_rng(0)
    main, bnd, dev = _common.signal(rng, (B, F, _common.HOP),
                                    (B, F // TF, 8, _common.HOP), device)
    mats = [rng.standard_normal(shape).astype(np.float32)
            for shape in [(_common.HOP, _common.NCS)] * 3
            + [(_common.NCS, _common.NM)]]
    return _common.Inputs(main, bnd, anatomy.constants_from_numpy(
        terms(*mats[:3]), mats[3], dev))


def main() -> int:
    return _common.run("nopad_kernel", MODES, inputs, SAME)


if __name__ == "__main__":
    sys.exit(main())
