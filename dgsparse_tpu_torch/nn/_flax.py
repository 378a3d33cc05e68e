"""What the port's models share with flax: its Dense initialisation, and
loading a JAX model's params by their flax paths.

Every model of `nn/` names its submodules and parameters as flax does
(`conv1/linear`, `gat1/proj`, `gin0/apply_func/Dense_0`, `readout`, ...),
so one loader serves all of them.
"""

import math
from typing import Optional, Tuple

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


def flax_target(model: nn.Module, path) -> Tuple[nn.Parameter, bool]:
    """(parameter, transposed) of a flax param path a/b/leaf under `model`:
    a Dense `kernel` [in, out] is model.a.b.weight transposed; a sparse
    conv's 3-D `kernel` [k_vol, c_in, c_out] is model.a.b.kernel as it is;
    a LayerNorm's `scale` is its weight; any other leaf is the attribute of
    that name."""
    *mods, leaf = path.split("/") if isinstance(path, str) else path
    for name in mods:
        model = getattr(model, name)
    if leaf == "kernel" and not isinstance(getattr(model, "kernel", None),
                                           nn.Parameter):
        return model.weight, True
    if leaf == "scale":
        return model.weight, False
    return getattr(model, leaf), False


@torch.no_grad()
def load_flax_params(model: nn.Module, params) -> nn.Module:
    """Copy flax params (numpy arrays, with or without the top-level
    'params' key) into a module whose submodules carry the flax names
    (`flax_target` maps each path). Raises unless every parameter of the
    model is written once, at its shape. Values are cast to each
    parameter's type; a bfloat16 leaf (flax's `param_dtype=jnp.bfloat16`)
    crosses exactly through float32."""
    params = params.get("params", params)
    written = set()
    for path, value in _flat(params):
        target, transposed = flax_target(model, path)
        value = np.asarray(value)
        if transposed:
            value = value.T
        if not isinstance(target, nn.Parameter) \
                or tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"{'/'.join(path)}: flax array of shape {value.shape} does "
                f"not fit {getattr(target, 'shape', target)}")
        if value.dtype.name == "bfloat16":   # numpy has no such type
            src = torch.tensor(value.astype(np.float32)).to(torch.bfloat16)
        else:
            src = torch.tensor(value)
        target.copy_(src)
        written.add(id(target))
    missing = [n for n, p in model.named_parameters() if id(p) not in written]
    if missing:
        raise ValueError(f"no flax params for {missing}")
    return model
