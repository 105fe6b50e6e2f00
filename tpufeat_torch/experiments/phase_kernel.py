"""Port of ``benchmarks/experiments/phase_kernel.py`` (K5c) to the Hopper
anatomy kernel (``tpufeat_torch/csrc/anatomy.cu``).

The four-phase layout: rows of 640 samples (four hops), a block of TR = 128
rows gives 4 * TR frames; phase p contracts its aligned window of row r
and, for p = 2, 3, the first k1 lanes of row r + 1. One mode.

    python -m tpufeat_torch.experiments.phase_kernel

times every mode on the card (median of CUDA-event runs) and prints
``mode: ms`` beside the card's name and power limit.
"""

import sys

from tpufeat_torch.experiments import _common

MODES = {"kernel": ("bf16x3", "bf16x3", "sqlog")}
SAME: dict = {}
inputs, main = _common.phase_runner("phase_kernel", MODES, SAME, tr=128)


if __name__ == "__main__":
    sys.exit(main())
