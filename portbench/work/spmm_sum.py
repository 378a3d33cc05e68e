"""Work of `spmm_sum(sparse, dense)`: the SpMM of an [m, n] CSR of nnz
entries with dense [n, f], and its backward.

FLOPs: 2 nnz f a product (forward; the transpose for `d_dense`; the SDDMM
for `d_values`). Compulsory bytes, each input read once and each output
written once, 4 bytes an element or index: the structure as CSR (m + 1
offsets and nnz columns; the backward's least needs one structure, not
the CSC view besides), the values where there are, dense, and out; the
backward reads the cotangent g [m, f], and for `d_dense` the values and
writes [n, f], for `d_values` reads dense and writes nnz values.

An input that the op before left in the card's 50 MB L2 (dense at f = 40
on ogbn-arxiv is 27 MB) can let one call read less than these bytes from
memory, so one op can run under its bound; the ops of a step together
cannot, since each of their inputs was written to memory at least once.
"""

# where the models of the port call it, and the op itself
TARGETS = ("dgsparse_tpu_torch.nn.gcn:spmm_sum",
           "dgsparse_tpu_torch.ops.spmm:spmm_sum")


def shapes(args, kwargs, out) -> dict:
    sparse, dense = args[0], args[1]
    m, n = sparse.sparse_sizes()
    values = sparse.storage.values() if sparse.has_value else None
    return dict(m=m, n=n, nnz=sparse.nnz, f=dense.shape[1],
                has_values=values is not None,
                d_dense=dense.requires_grad,
                d_values=values is not None and values.requires_grad)


def forward(m, n, nnz, f, has_values, **_):
    """(FLOPs, bytes) of the forward."""
    index = (m + 1 + nnz) * 4
    return 2.0 * nnz * f, index + 4.0 * (nnz * has_values + n * f + m * f)


def backward(m, n, nnz, f, has_values, d_dense, d_values, **_):
    """(FLOPs, bytes) of the backward, for the gradients it computes."""
    flops = 2.0 * nnz * f * (d_dense + d_values)
    nbytes = (m + 1 + nnz) * 4 + 4.0 * m * f
    if d_dense:
        nbytes += 4.0 * (nnz * has_values + n * f)
    if d_values:
        nbytes += 4.0 * (n * f + nnz)
    return flops, nbytes
