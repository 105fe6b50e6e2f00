"""Runners of the phase-kernel anatomy family (K5a-h) on the Hopper
kernel: one module per script of ``benchmarks/experiments/``, with the
script's name, each runnable as ``python -m tpufeat_torch.experiments.<name>``.
"""

#: the runners, in the order their kernels were ported
RUNNERS = ("phase_anatomy", "phase_kernel", "phase_anatomy5",
           "phase_anatomy2", "phase_anatomy3", "phase_anatomy4",
           "nopad_kernel", "repack_kernel")
