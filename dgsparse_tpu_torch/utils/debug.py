"""Opt-in input validation before any device work.

Counterpart of `dgsparse_tpu/utils/debug.py`. With the mode on, either
through `DGSPARSE_TPU_VALIDATE=1` in the environment or
`debug.set_validate(True)`, `spmm`, `sddmm` and `gspmm` run
`SparseTensor.validate()` first and raise its typed ValueError before
they launch anything. On the card that matters beyond the data: an
out-of-range column reaching a CUDA kernel is an illegal address, which
poisons the CUDA context for the rest of the process. Off by default:
validation copies the index arrays to the host, O(nnz) a call. The port
is eager, so there is no traced case to skip.
"""

import os

_validate = [os.environ.get("DGSPARSE_TPU_VALIDATE", "0") not in
             ("0", "", "false", "False")]


def set_validate(on: bool) -> None:
    _validate[0] = bool(on)


def validate_enabled() -> bool:
    return _validate[0]


def maybe_validate(sparse) -> None:
    """Called by the op entry points; a no-op unless enabled."""
    if _validate[0]:
        sparse.validate()
