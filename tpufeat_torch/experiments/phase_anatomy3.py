"""Port of ``benchmarks/experiments/phase_anatomy3.py`` (K5f) to the Hopper
anatomy kernel (``tpufeat_torch/csrc/anatomy.cu``).

``zconcat`` (the phases' z concatenated phase-major, one mel product, the
output interleaved after it: ``full``'s function), and the two-pass bf16
mel product, ``melx2`` (per phase) and ``zconcat2`` (concatenated: the
same function as ``melx2``).

    python -m tpufeat_torch.experiments.phase_anatomy3

times every mode on the card (median of CUDA-event runs) and prints
``mode: ms`` beside the card's name and power limit.
"""

import sys

from tpufeat_torch.experiments import _common

MODES = {
    "zconcat": ("bf16x3", "bf16x3", "sqlog"),
    "melx2": ("bf16x3", "bf16x2", "sqlog"),
    "zconcat2": ("bf16x3", "bf16x2", "sqlog"),
}
SAME = {"zconcat": "phase_anatomy full", "zconcat2": "melx2"}
inputs, main = _common.phase_runner("phase_anatomy3", MODES, SAME, tr=256)


if __name__ == "__main__":
    sys.exit(main())
