"""Port of ``benchmarks/experiments/phase_anatomy.py`` (K5d) to the Hopper
anatomy kernel (``tpufeat_torch/csrc/anatomy.cu``).

The phase kernel of ``phase_kernel`` at TR = 256, taken apart: ``full``;
``nostack``, which interleaves the phases by a concat and a reshape, the
same frames as the stack, so the same function; ``nolog`` (the mel before
the log); ``bf16x1`` (one bf16 pass in both products); ``dftonly`` (the
first 128 DFT columns, no mel).

    python -m tpufeat_torch.experiments.phase_anatomy

times every mode on the card (median of CUDA-event runs) and prints
``mode: ms`` beside the card's name and power limit.
"""

import sys

from tpufeat_torch.experiments import _common

MODES = {
    "full": ("bf16x3", "bf16x3", "sqlog"),
    "nostack": ("bf16x3", "bf16x3", "sqlog"),
    "nolog": ("bf16x3", "bf16x3", "nolog"),
    "bf16x1": ("bf16x1", "bf16x1", "sqlog"),
    "dftonly": ("bf16x3", None, "dftonly"),
}
SAME = {"nostack": "full"}
inputs, main = _common.phase_runner("phase_anatomy", MODES, SAME, tr=256)


if __name__ == "__main__":
    sys.exit(main())
