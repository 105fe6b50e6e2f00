"""Port of ``benchmarks/experiments/phase_anatomy5.py`` (K5h) to the Hopper
anatomy kernel (``tpufeat_torch/csrc/anatomy.cu``).

bf16x3 as one stacked-K product ``[hi | hi | lo] @ [chi; clo; chi]``:
``base`` (three products), ``stackmel``, ``stackall``, ``melpair2`` and
``melpair4`` (the mel product over two or four phases at once). The
stacked sum has the same exact products as the three-pass one, so all
five compute one function, with the ``log`` tail log10(max(m, 1e-10)).
The script draws D1 only for the phases that use it (k1 > 0).

    python -m tpufeat_torch.experiments.phase_anatomy5

times every mode on the card (median of CUDA-event runs) and prints
``mode: ms`` beside the card's name and power limit.
"""

import sys

from tpufeat_torch.experiments import _common

MODES = {
    "base": ("bf16x3", "bf16x3", "log"),
    "stackmel": ("bf16x3", "bf16x3", "log"),
    "stackall": ("bf16x3", "bf16x3", "log"),
    "melpair2": ("bf16x3", "bf16x3", "log"),
    "melpair4": ("bf16x3", "bf16x3", "log"),
}
SAME = {m: "base" for m in ("stackmel", "stackall", "melpair2", "melpair4")}
inputs, main = _common.phase_runner("phase_anatomy5", MODES, SAME,
                                    tr=256, k1_only=True)


if __name__ == "__main__":
    sys.exit(main())
