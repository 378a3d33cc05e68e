"""dgsparse_tpu_torch — the PyTorch and CUDA port of dgsparse_tpu.

The JAX package `dgsparse_tpu` stays beside it as the reference; each
ported piece keeps its counterpart's module path and names and is tested
against it. This package imports torch and never JAX. What is ported so
far is the GCN forward: CSR formats, SUM/MEAN SpMM, and the GCN model. Its
one kernel, `csrc/spmm_csr.cu` (CUDA C++ for Hopper, sm_90a), replaces the
Pallas `segment_matmul`; tensors on the CPU run its plain PyTorch version.
"""

__version__ = "0.1.0"

from dgsparse_tpu_torch.core import ftransform
from dgsparse_tpu_torch.core.formats import SparseTensor, Storage
from dgsparse_tpu_torch.core.transform import coo2csr, csr2coo, csr2csc
from dgsparse_tpu_torch.ops.spmm import spmm, spmm_mean, spmm_sum
from dgsparse_tpu_torch.ops.types import Algorithm, ComputeOp, ReduceOp


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


def self_check(device="cpu") -> None:
    """One SpMM on a tiny graph on `device`, checked against a numpy
    oracle. On a CUDA device this builds and launches the kernel."""
    import numpy as np
    import torch

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
    "self_check",
    "version",
    "__version__",
]
