"""The reference's ``examples/`` rewritten on the port: the same synthetic
data and the same steps, on the card unless the caller asks for the CPU.

    python -m tpufeat_torch.examples.offline_corpus [workdir] [--device cpu]
    python -m tpufeat_torch.examples.online_serving [--device cpu]
    python -m tpufeat_torch.examples.serving_pool [--device cpu]
    python -m tpufeat_torch.examples.speaker_id [--device cpu]
    python -m tpufeat_torch.examples.train_eval [--device cpu]

Each module's ``main(..., device=None)`` runs the example.
"""

from __future__ import annotations

import argparse

NAMES = ("offline_corpus", "online_serving", "serving_pool", "speaker_id",
         "train_eval")


def run(name: str, main, *positional: str, argv=None) -> int:
    """The examples' command line: ``positional`` optional arguments, then
    ``--device`` (default cuda; without a card the command stops)."""
    p = argparse.ArgumentParser(prog=f"tpufeat_torch.examples.{name}")
    for arg in positional:
        p.add_argument(arg, nargs="?", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; refuses to run without a card), "
                        "cuda:N or cpu")
    args = p.parse_args(argv)
    from tpufeat_torch.cli import device_of
    main(*(getattr(args, arg) for arg in positional),
         device=device_of(args.device))
    return 0
