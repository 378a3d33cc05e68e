"""Work of `edge_softmax(sparse, logits)`: the softmax of logits [nnz, H]
over each of the m rows' edges, and its backward.

FLOPs, per element: the row max, the shift, exp, the row sum and the
division, 5 (forward); the backward alpha (g - rowsum(g alpha)), 4.
Compulsory bytes, 4 bytes an element or index: the row offsets (m + 1:
the least structure that groups edges by row), logits in and alpha out;
the backward reads alpha and the cotangent and writes the logits'
gradient.
"""

TARGETS = ("dgsparse_tpu_torch.nn.gat:edge_softmax",
           "dgsparse_tpu_torch.ops.edge_softmax:edge_softmax")


def shapes(args, kwargs, out) -> dict:
    sparse, logits = args[0], args[1]
    nnz = sparse.nnz
    return dict(m=sparse.sparse_sizes()[0], nnz=nnz,
                heads=logits.numel() // max(nnz, 1),
                d_logits=logits.requires_grad)


def forward(m, nnz, heads, **_):
    """(FLOPs, bytes) of the forward."""
    e = nnz * heads
    return 5.0 * e, 4.0 * (m + 1 + 2 * e)


def backward(m, nnz, heads, **_):
    """(FLOPs, bytes) of the backward."""
    e = nnz * heads
    return 4.0 * e, 4.0 * (m + 1 + 3 * e)
