"""Port of ``benchmarks/experiments/phase_anatomy2.py`` (K5e) to the Hopper
anatomy kernel (``tpufeat_torch/csrc/anatomy.cu``).

Two orderings of ``phase_anatomy``'s ``full``: ``reorder`` (every DFT
before any mel) and ``zstack`` (the phases' z stacked, one mel product).
Both compute ``full``'s function; only the order of the work differs.

    python -m tpufeat_torch.experiments.phase_anatomy2

times every mode on the card (median of CUDA-event runs) and prints
``mode: ms`` beside the card's name and power limit.
"""

import sys

from tpufeat_torch.experiments import _common

MODES = {
    "reorder": ("bf16x3", "bf16x3", "sqlog"),
    "zstack": ("bf16x3", "bf16x3", "sqlog"),
}
SAME = {"reorder": "phase_anatomy full", "zstack": "phase_anatomy full"}
inputs, main = _common.phase_runner("phase_anatomy2", MODES, SAME, tr=256)


if __name__ == "__main__":
    sys.exit(main())
