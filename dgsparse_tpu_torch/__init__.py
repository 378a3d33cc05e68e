"""dgsparse_tpu_torch — the PyTorch and CUDA port of dgsparse_tpu.

The JAX package `dgsparse_tpu` stays beside it as the reference; each
ported piece keeps its counterpart's module path and names and is tested
against it. This package imports torch and never JAX. What is ported so
far: CSR formats, SpMM with SUM/MEAN/MAX/MIN (single- and multi-head,
CSR and COO) with both gradients, the semiring `gspmm` grid, SDDMM, edge
softmax, the sorted segment sum, the hybrid tiers on clustered graphs,
slot-space edge values and the fused slot-space GAT attention
(`ops/slot.py`, `ops/attention.py`), the GE-SpMM C-API surface
(`ge_spmm`, a submodule as in JAX), the sharded ops and training steps
of `dist/` on `torch.distributed` (a submodule as in JAX), sparse 3-D
convolution with its host
rulebook (native C++ builder for large clouds, `native.py`) on fused
pair kernels, the GCN, GAT, GIN, SAGE, DGCNN and point-cloud UNet
models, their serving and training (`entry.py`), RCM reordering
(`core/reorder.py`), and the utilities of `utils/`: opt-in validation
(`debug`), dispatch counters (`metrics`), degree statistics (`stats`),
the route tuner that `spmm`'s AUTO consults (`tune`) and checkpoints
(`checkpoint`). Every Pallas kernel of the JAX package has a CUDA C++
counterpart for Hopper (sm_90a) under `csrc/`: `spmm_csr.cu`
(`segment_matmul`), `sddmm_csr.cu` (`sddmm_esc`), `spmm_maxmin.cu`
(`spmm_maxmin_esc` and its XLA winner-mask backward), `spmm_cells.cu`
(`spmm_dense_cells`, `sddmm_cells`), `spmm_bell.cu` (`spmm_bell`) and
`spconv.cu` (`fused_pair_matmul`, `fused_pair_dw`); tensors on the CPU
run their plain PyTorch versions.
"""

__version__ = "0.1.0"

from dgsparse_tpu_torch.core import ftransform
from dgsparse_tpu_torch.core.formats import SparseTensor, Storage
from dgsparse_tpu_torch.core.transform import coo2csr, csr2coo, csr2csc
from dgsparse_tpu_torch.ops.attention import gat_attention
from dgsparse_tpu_torch.ops.edge_softmax import edge_softmax
from dgsparse_tpu_torch.ops.gspmm import GSpMM_u, GSpMM_u_e, gspmm
from dgsparse_tpu_torch.ops.sddmm import sddmm, sddmm_coo
from dgsparse_tpu_torch.ops.segment import sorted_segment_sum
from dgsparse_tpu_torch.ops.slot import (SlotValues, edge_softmax_slots,
                                         edges_to_slots, sddmm_slots,
                                         slots_to_edges, spmm_slots)
from dgsparse_tpu_torch.ops.spmm import (spmm, spmm_max, spmm_mean, spmm_min,
                                         spmm_sum)
from dgsparse_tpu_torch.ops.spmm_coo import spmm_coo
from dgsparse_tpu_torch.ops.spconv import (SparseConvTensor, build_rulebook,
                                           inverse_plan, spconv)
from dgsparse_tpu_torch.ops.spmm_mh import spmm_multihead
from dgsparse_tpu_torch.ops.types import Algorithm, ComputeOp, ReduceOp
from dgsparse_tpu_torch import nn  # noqa: E402  (nn.GCN, nn.GIN, ...)


def version() -> dict:
    """Package, torch and CUDA versions, the device name when a card is
    present, and the native host library's version (None without it)."""
    import torch

    from dgsparse_tpu_torch import native

    cuda = torch.cuda.is_available()
    return {
        "dgsparse_tpu_torch": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else None,
        "native": native.version(),
    }


def self_check(device="cuda", require_native: bool = False) -> None:
    """One SpMM on a tiny graph on `device` (the card unless the caller
    names the CPU), checked against a numpy oracle. On a CUDA device this
    builds and launches the kernel. `require_native` also asserts that
    the native host library built and loaded (`native.py`)."""
    import numpy as np
    import torch

    from dgsparse_tpu_torch.entry import resolve_device

    if require_native:
        from dgsparse_tpu_torch import native

        if not native.available():
            raise RuntimeError(
                "native host library (libdgsparse_host.so) did not load: "
                f"build it with native.build() ({native.library_path()})")
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
    "SlotValues",
    "sddmm_slots",
    "edge_softmax_slots",
    "spmm_slots",
    "slots_to_edges",
    "edges_to_slots",
    "gat_attention",
    "SparseConvTensor",
    "build_rulebook",
    "inverse_plan",
    "spconv",
    "nn",
    "self_check",
    "version",
    "__version__",
]
