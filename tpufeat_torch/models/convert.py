"""Weights across: a flax params tree (nested dicts of numpy arrays) ->
the state dict of the port's model of the same architecture.

The port's modules carry flax's names (``Conv_0``, ``MHSA_0/q``,
``tdnn0``, ``pred_embed``, ...), so a leaf's path names its module; only
the layout differs, by the module's type:

- ``nn.Linear``: flax ``Dense`` kernel [in, out] -> weight [out, in];
- ``nn.Conv1d``: flax ``Conv`` kernel [width, in/groups, out] -> weight
  [out, in/groups, width];
- ``nn.LayerNorm``: ``scale`` -> weight;
- ``nn.Embedding``: ``embedding`` [n, dim] -> weight, as is.

Nothing here imports flax or jax: the caller turns the tree into numpy
(``jax.tree_util.tree_map(np.asarray, params)``).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

__all__ = ["state_dict_from_flax"]

_LEAVES = {
    # module type -> {flax leaf: (torch leaf, layout)}
    nn.Linear: {"kernel": ("weight", lambda a: a.T),
                "bias": ("bias", None)},
    nn.Conv1d: {"kernel": ("weight", lambda a: a.transpose(2, 1, 0)),
                "bias": ("bias", None)},
    nn.LayerNorm: {"scale": ("weight", None), "bias": ("bias", None)},
    nn.Embedding: {"embedding": ("weight", None)},
}


def _flat(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_flax(params: dict, model: nn.Module) -> OrderedDict:
    """``params`` (as ``model.init`` gives it, with or without the outer
    ``{"params": ...}``) as ``model``'s state dict, float32 on the CPU.
    Raises when a leaf has no counterpart, a shape disagrees, or a
    parameter of ``model`` is left out."""
    if set(params) == {"params"}:
        params = params["params"]
    out = OrderedDict()
    for path, value in _flat(params):
        module = model.get_submodule(".".join(path[:-1]))
        table = _LEAVES.get(type(module))
        if table is None or path[-1] not in table:
            raise ValueError(f"no counterpart for flax leaf "
                             f"{'/'.join(path)} in {type(module).__name__}")
        leaf, layout = table[path[-1]]
        a = np.array(value, np.float32)      # a writable copy
        if layout is not None:
            a = layout(a)
        key = ".".join(path[:-1] + (leaf,))
        want = tuple(getattr(module, leaf).shape)
        if a.shape != want:
            raise ValueError(f"{'/'.join(path)}: shape {a.shape} is not "
                             f"{key}'s {want}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise ValueError(f"flax params lack {sorted(missing)}")
    return out
