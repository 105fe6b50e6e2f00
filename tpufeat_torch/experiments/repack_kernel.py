"""Port of ``benchmarks/experiments/repack_kernel.py`` (K5b) to the Hopper
anatomy kernel (``tpufeat_torch/csrc/anatomy.cu``).

The TPU kernel takes 160-lane rows, repacks lanes 0:80 and 80:160 to
lanes 0:80 and 128:208 of 256 with zeros between, and contracts K = 256,
256 and 128 lanes of rows t, t + 1 and t + 2 (a 400-sample frame). The
zero lanes contribute exactly 0, so the port contracts only the 400 real
samples: rows t and t + 1 in full against rows 0:80 and 128:208 of D0 and
D1, and lanes 0:80 of row t + 2 against rows 0:80 of D2. One mode.

    python -m tpufeat_torch.experiments.repack_kernel

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
QL = 256                      # the repacked row width
REAL = np.r_[0:80, 128:208]   # the repacked lanes that hold samples


def terms(d0, d1, d2) -> list:
    """The script's [256, 512], [256, 512] and [128, 512] matrices as the
    one-phase term table over the 160 real lanes."""
    return [[(0, 0, _common.rows(d0, REAL)), (1, 0, _common.rows(d1, REAL)),
             (2, 0, _common.rows(d2, slice(0, 80)))]]


def inputs(device=None, B: int = 128, F: int = 3072,
           TF: int = 512) -> _common.Inputs:
    """The script's arrays at its sizes (or smaller ones): main [B, F, 160],
    bnd [B, F/TF, 8, 160], then D0, D1 [256, 512], D2 [128, 512] and
    FB [512, 128]."""
    rng = np.random.default_rng(0)
    main, bnd, dev = _common.signal(rng, (B, F, _common.HOP),
                                    (B, F // TF, 8, _common.HOP), device)
    mats = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((QL, _common.NCS), (QL, _common.NCS),
                          (128, _common.NCS), (_common.NCS, _common.NM))]
    return _common.Inputs(main, bnd, anatomy.constants_from_numpy(
        terms(*mats[:3]), mats[3], dev))


def main() -> int:
    return _common.run("repack_kernel", MODES, inputs, SAME)


if __name__ == "__main__":
    sys.exit(main())
