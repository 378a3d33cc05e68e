"""dgsparse_tpu_torch — the PyTorch and CUDA port of dgsparse_tpu.

The JAX package `dgsparse_tpu` stays beside it as the reference; each
ported piece keeps its counterpart's module path and names and is tested
against it. This package imports torch and never JAX. What is ported so
far: CSR formats, SpMM with SUM/MEAN/MAX/MIN (single- and multi-head,
CSR and COO) with both gradients, the semiring `gspmm` grid, SDDMM, edge
softmax, the sorted segment sum, the GCN, GAT, GIN, SAGE and DGCNN models,
and GCN, GAT and GIN-max serving and training (`entry.py`). Three kernel
sources, CUDA C++ for Hopper (sm_90a), carry them: `csrc/spmm_csr.cu`
replaces the Pallas `segment_matmul`, `csrc/sddmm_csr.cu` the Pallas
`sddmm_esc`, and `csrc/spmm_maxmin.cu` the Pallas `spmm_maxmin_esc` and
its XLA winner-mask backward; tensors on the CPU run their plain PyTorch
versions.
"""

__version__ = "0.1.0"

from dgsparse_tpu_torch.core import ftransform
from dgsparse_tpu_torch.core.formats import SparseTensor, Storage
from dgsparse_tpu_torch.core.transform import coo2csr, csr2coo, csr2csc
from dgsparse_tpu_torch.ops.edge_softmax import edge_softmax
from dgsparse_tpu_torch.ops.gspmm import GSpMM_u, GSpMM_u_e, gspmm
from dgsparse_tpu_torch.ops.sddmm import sddmm, sddmm_coo
from dgsparse_tpu_torch.ops.segment import sorted_segment_sum
from dgsparse_tpu_torch.ops.spmm import (spmm, spmm_max, spmm_mean, spmm_min,
                                         spmm_sum)
from dgsparse_tpu_torch.ops.spmm_coo import spmm_coo
from dgsparse_tpu_torch.ops.spmm_mh import spmm_multihead
from dgsparse_tpu_torch.ops.types import Algorithm, ComputeOp, ReduceOp
from dgsparse_tpu_torch import nn  # noqa: E402  (nn.GCN, nn.GIN, ...)


def version() -> dict:
    """Package, torch and CUDA versions, and the device name when a card
    is present."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "dgsparse_tpu_torch": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else None,
    }


def self_check(device="cuda") -> None:
    """One SpMM on a tiny graph on `device` (the card unless the caller
    names the CPU), checked against a numpy oracle. On a CUDA device this
    builds and launches the kernel."""
    import numpy as np
    import torch

    from dgsparse_tpu_torch.entry import resolve_device

    device = resolve_device(device)

    rowptr = np.array([0, 2, 3, 3, 5], np.int32)
    col = np.array([1, 3, 0, 2, 2], np.int32)
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    sp = SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                               sparse_sizes=(4, 4), device=device)
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    out = spmm(sp, torch.from_numpy(x).to(device), "sum").cpu().numpy()
    ref = np.zeros((4, 2), np.float32)
    for r in range(4):
        for e in range(rowptr[r], rowptr[r + 1]):
            ref[r] += vals[e] * x[col[e]]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


__all__ = [
    "SparseTensor",
    "Storage",
    "ftransform",
    "csr2csc",
    "coo2csr",
    "csr2coo",
    "ReduceOp",
    "ComputeOp",
    "Algorithm",
    "spmm",
    "spmm_sum",
    "spmm_mean",
    "spmm_max",
    "spmm_min",
    "spmm_multihead",
    "spmm_coo",
    "gspmm",
    "GSpMM_u_e",
    "GSpMM_u",
    "sorted_segment_sum",
    "sddmm",
    "sddmm_coo",
    "edge_softmax",
    "nn",
    "self_check",
    "version",
    "__version__",
]
