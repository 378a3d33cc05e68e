"""Format-transform entry points on SparseTensor.

Counterpart of `dgsparse_tpu/core/ftransform.py` (reference:
dgsparse/ftransform.py:6-10). The CSC view is cached on the Storage, so
these are accessors plus the value permutation.
"""

from typing import Optional, Tuple

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor


def csr2csc(sparse: SparseTensor) -> Tuple[torch.Tensor, torch.Tensor,
                                           Optional[torch.Tensor]]:
    """(colptr, row, values_transposed) — reference ftransform.csr2csc."""
    st = sparse.storage
    values_t = None
    if sparse.has_value and st.values() is not None:
        values_t = st.values()[st.csr2csc().long()]
    return st.colptr(), st.row(), values_t


def csr2coo(sparse: SparseTensor) -> Tuple[torch.Tensor, torch.Tensor,
                                           Optional[torch.Tensor]]:
    """(row, col, values) in CSR edge order."""
    st = sparse.storage
    return st.coo_row(), st.col(), st.values()
