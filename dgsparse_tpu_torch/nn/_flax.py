"""What the port's models share with flax: its Dense initialisation, and
loading a JAX model's params by their flax paths.

Every model of `nn/` names its submodules and parameters as flax does
(`conv1/linear`, `gat1/proj`, `gin0/apply_func/Dense_0`, `readout`, ...),
so one loader serves all of them.
"""

import math
from typing import Optional

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def init_like_flax_dense(linear: nn.Linear,
                         generator: Optional[torch.Generator] = None) -> None:
    """flax Dense's defaults: a LeCun-normal kernel truncated at two
    standard deviations, and a zero bias (if any)."""
    std = math.sqrt(1.0 / linear.in_features) / .87962566103423978
    nn.init.trunc_normal_(linear.weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    if linear.bias is not None:
        linear.bias.zero_()


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@torch.no_grad()
def load_flax_params(model: nn.Module, params) -> nn.Module:
    """Copy flax params (numpy arrays, with or without the top-level
    'params' key) into a module whose submodules carry the flax names:
    path a/b/kernel goes to model.a.b.weight, transposed ([in, out] ->
    [out, in]); any other leaf to the attribute of that name. Raises
    unless every parameter of the model is written once, at its shape."""
    params = params.get("params", params)
    written = set()
    for path, value in _flat(params):
        *mods, leaf = path
        target = model
        for name in mods:
            target = getattr(target, name)
        value = np.asarray(value)
        if leaf == "kernel":
            target, value = target.weight, value.T
        else:
            target = getattr(target, leaf)
        if not isinstance(target, nn.Parameter) \
                or tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"{'/'.join(path)}: flax array of shape {value.shape} does "
                f"not fit {getattr(target, 'shape', target)}")
        target.copy_(torch.tensor(value))
        written.add(id(target))
    missing = [n for n, p in model.named_parameters() if id(p) not in written]
    if missing:
        raise ValueError(f"no flax params for {missing}")
    return model
