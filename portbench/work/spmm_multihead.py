"""Work of `spmm_multihead(sparse, values, dense)` with SUM: per head h of
H, the SpMM of the [m, n] structure (nnz entries) weighted by values
[nnz, H] with dense [n, H, f], and its backward.

FLOPs: 2 nnz H f a product (forward; the transpose for `d_dense`; the
SDDMM for `d_values`). Compulsory bytes, each input read once and each
output written once, 4 bytes an element or index: the CSR structure
(m + 1 offsets, nnz columns), values, dense, out; the backward reads the
cotangent [m, H, f] and the structure, for `d_dense` the values and
writes [n, H, f], for `d_values` reads dense and writes [nnz, H].

An input left in the card's 50 MB L2 by the op before can let one call
read less than these bytes, never the ops of a step together (see
`spmm_sum.py`).
"""

TARGETS = ("dgsparse_tpu_torch.nn.gat:spmm_multihead",
           "dgsparse_tpu_torch.ops.spmm_mh:spmm_multihead")


def shapes(args, kwargs, out) -> dict:
    sparse, values, dense = args[0], args[1], args[2]
    m, n = sparse.sparse_sizes()
    return dict(m=m, n=n, nnz=sparse.nnz, heads=dense.shape[1],
                f=dense.shape[2], d_dense=dense.requires_grad,
                d_values=values is not None and values.requires_grad)


def forward(m, n, nnz, heads, f, **_):
    """(FLOPs, bytes) of the forward."""
    hf = heads * f
    return 2.0 * nnz * hf, 4.0 * (m + 1 + nnz + nnz * heads + n * hf + m * hf)


def backward(m, n, nnz, heads, f, d_dense, d_values, **_):
    """(FLOPs, bytes) of the backward, for the gradients it computes."""
    hf = heads * f
    nbytes = 4.0 * (m + 1 + nnz + m * hf)
    if d_dense:
        nbytes += 4.0 * (nnz * heads + n * hf)
    if d_values:
        nbytes += 4.0 * (n * hf + nnz * heads)
    return 2.0 * nnz * hf * (d_dense + d_values), nbytes
