"""Port of ``benchmarks/experiments/phase_anatomy4.py`` (K5g) to the Hopper
anatomy kernel (``tpufeat_torch/csrc/anatomy.cu``).

The TPU's hardware precisions instead of explicit splits: ``allhigh``
(both products on f32 operands at ``Precision.HIGH``), ``melhigh``
(explicit bf16x3 DFT, mel at HIGH) and ``allhighest`` (f32 at HIGHEST).
HIGH is a bf16 three-pass product on the TPU and is ported as bf16x3, so
``allhigh`` and ``melhigh`` compute ``phase_anatomy``'s ``full``.
HIGHEST is the TPU's six bf16 passes (XLA's f32 emulation: the script's
own note, "6-pass, reference point") and is ported as ``bf16x6``. The
script carries each matrix as (hi, lo, f32); the f32 matrices are drawn
here and split into three pieces.

    python -m tpufeat_torch.experiments.phase_anatomy4

times every mode on the card (median of CUDA-event runs) and prints
``mode: ms`` beside the card's name and power limit.
"""

import sys

from tpufeat_torch.experiments import _common

MODES = {
    "allhigh": ("bf16x3", "bf16x3", "sqlog"),
    "melhigh": ("bf16x3", "bf16x3", "sqlog"),
    "allhighest": ("bf16x6", "bf16x6", "sqlog"),
}
SAME = {"allhigh": "phase_anatomy full", "melhigh": "phase_anatomy full"}
inputs, main = _common.phase_runner("phase_anatomy4", MODES, SAME, tr=256)


if __name__ == "__main__":
    sys.exit(main())
