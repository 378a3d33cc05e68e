"""Checkpoint and restore of training state over `torch.save` /
`torch.load` (counterpart of `dgsparse_tpu/utils/checkpoint.py`, which
wraps orbax).

`state` is a nested dict (or list) of tensors, numbers, strings, model
`state_dict()`s and optimizer `state_dict()`s, which is what
`torch.load(..., weights_only=True)` reads back, so no pickled code runs
on restore.
"""

import os
from typing import Any, Optional

import torch


def save(path: str, state: Any) -> None:
    """Write `state` to `path`, atomically (a temporary file renamed into
    place, so a crash never leaves half a checkpoint)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def _like(value, template):
    """`value` with each tensor on its template tensor's device and in its
    type, recursing through dicts, lists and tuples."""
    if isinstance(template, torch.Tensor) and isinstance(value, torch.Tensor):
        return value.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict) and isinstance(value, dict):
        return {k: _like(v, template[k]) if k in template else v
                for k, v in value.items()}
    if isinstance(template, (list, tuple)) and \
            isinstance(value, (list, tuple)) and len(template) == len(value):
        return type(value)(_like(v, t) for v, t in zip(value, template))
    return value


def restore(path: str, template: Optional[Any] = None) -> Any:
    """Read a state written by `save`, its tensors on the CPU; with a
    `template` of the same structure (e.g. a fresh model's and optimizer's
    state dicts), each tensor comes back on the template's device and in
    its type."""
    state = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    return state if template is None else _like(state, template)
