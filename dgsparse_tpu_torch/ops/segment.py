"""Public sorted segment sum on the CSR segment-sum kernel.

Counterpart of `dgsparse_tpu/ops/segment.py::sorted_segment_sum`, which
runs the Pallas `segment_matmul` over a plan built from the ids. Here the
sorted ids become a CSR rowptr and `kernels/spmm_csr.py::segment_sum_csr`
sums each segment's rows in order (the Hopper kernel on CUDA, its plain
version on the CPU). Differentiable in `data`: the gradient of row i is
g[segment_ids[i]].
"""

import torch

from dgsparse_tpu_torch.core.transform import compress_rowids
from dgsparse_tpu_torch.kernels.spmm_csr import segment_sum_csr


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, rowptr):
        ctx.save_for_backward(ids)
        return segment_sum_csr(rowptr, data, coo_row=ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return g.index_select(0, ids.long()), None, None


def sorted_segment_sum(data: torch.Tensor, segment_ids,
                       num_segments: int) -> torch.Tensor:
    """segment_sum of data [n, F] for ids [n] sorted ascending; segments
    with no rows give 0. Raises ValueError for unsorted or out-of-range
    ids."""
    ids = torch.as_tensor(segment_ids, device=data.device).to(torch.int32)
    if data.dim() != 2 or ids.shape != (data.shape[0],):
        raise ValueError(
            f"data [n, F] and segment_ids [n] expected, got "
            f"{tuple(data.shape)} and {tuple(ids.shape)}")
    if ids.numel() and (bool((ids[1:] < ids[:-1]).any())
                        or int(ids[0]) < 0
                        or int(ids[-1]) >= num_segments):
        raise ValueError(
            f"segment_ids must be sorted ascending in [0, {num_segments})")
    rowptr = compress_rowids(ids, num_segments)
    return _SortedSegmentSum.apply(data.contiguous(), ids, rowptr)
