"""Row-sharded multi-head GAT training step over the ranks of a process
group.

Counterpart of `dgsparse_tpu/dist/gat.py`. Edges live with their
destination row's shard, so the attention softmax over each destination's
in-edges is local; the only collectives of an aggregation are the two
all-gathers of the projected features [N, H, F] and of the source halves
[N, H] (backward: their reduce-scatters). Locally the softmax is the port's
`edge_softmax` on the rank's CSR and the alpha-weighted multi-head sum is
`spmm_multihead` (`csr_spmm` with a heads axis; its `d_values` is
`sddmm_csr`). A destination row without edges gets 0, as JAX's masked
segment sums give it.
"""

import torch
import torch.distributed as dist
from torch.nn import functional as F

from dgsparse_tpu_torch.core.transform import gather_rows
from dgsparse_tpu_torch.dist import comm
from dgsparse_tpu_torch.dist.gcn import (Params, _uniform, masked_nll,
                                         params_from_jax, sgd_step)
from dgsparse_tpu_torch.dist.shard import ShardedCSR
from dgsparse_tpu_torch.ops.edge_softmax import edge_softmax
from dgsparse_tpu_torch.ops.spmm_mh import spmm_multihead

__all__ = ["gat_aggregate_sharded", "init_params", "params_from_jax",
           "forward", "loss_fn", "make_train_step"]


def gat_aggregate_sharded(sharded: ShardedCSR, h: torch.Tensor,
                          sd: torch.Tensor, ss: torch.Tensor, group=None,
                          negative_slope: float = 0.2) -> torch.Tensor:
    """One attention aggregation of this rank's destination rows: logits
    leaky_relu(sd[dst] + ss[src]), their softmax over each destination's
    edges, the alpha-weighted multi-head neighbour sum. h [rps, H, F], sd
    and ss [rps, H] are this rank's node blocks; returns [rps, H, F]."""
    hg = comm.all_gather(h, group)                    # [N, H, F]
    ssg = comm.all_gather(ss, group)                  # [N, H]
    sp = sharded.local(dist.get_rank(group), h.device)
    st = sp.storage
    logits = gather_rows(sd, st.coo_row()) + gather_rows(ssg, st.col())
    alpha = edge_softmax(sp, F.leaky_relu(logits, negative_slope))
    return spmm_multihead(sp, alpha, hg).to(h.dtype)


def init_params(generator: torch.Generator, f_in: int, f_hidden: int,
                f_out: int, heads: int) -> Params:
    """Glorot-uniform weights and attention vectors from `generator`; the
    second layer has one head."""
    def glorot(shape):
        return _uniform(generator, shape,
                        (6.0 / (shape[-2] + shape[-1])) ** 0.5)

    return {"w1": glorot((f_in, heads * f_hidden)),
            "a1d": glorot((heads, f_hidden)),
            "a1s": glorot((heads, f_hidden)),
            "w2": glorot((heads * f_hidden, f_out)),
            "a2d": glorot((1, f_out)),
            "a2s": glorot((1, f_out))}


def forward(params: Params, adj: ShardedCSR, x: torch.Tensor, group=None,
            heads: int = 1) -> torch.Tensor:
    """This rank's logits [rps, C] of the 2-layer GAT from its node block
    x (square graphs: destination rows and source nodes share the
    partition)."""
    n = x.shape[0]
    h = (x @ params["w1"]).reshape(n, heads, -1)
    sd = torch.einsum("nhf,hf->nh", h, params["a1d"])
    ss = torch.einsum("nhf,hf->nh", h, params["a1s"])
    h = gat_aggregate_sharded(adj, h, sd, ss, group)
    h = F.elu(h.reshape(n, -1))
    h = (h @ params["w2"]).reshape(n, 1, -1)
    sd = torch.einsum("nhf,hf->nh", h, params["a2d"])
    ss = torch.einsum("nhf,hf->nh", h, params["a2s"])
    return gat_aggregate_sharded(adj, h, sd, ss, group).reshape(n, -1)


def loss_fn(params, adj, x, y, mask, group=None, heads: int = 1):
    """The global masked mean cross-entropy (see `dist/gcn.py`)."""
    return masked_nll(forward(params, adj, x, group, heads), y, mask, group)


def make_train_step(group, adj: ShardedCSR, heads: int, lr: float = 1e-2):
    """(params, x, y, mask) -> (params, loss): one SGD step."""
    def step(params, x, y, mask):
        return sgd_step(lambda p: loss_fn(p, adj, x, y, mask, group, heads),
                        params, lr, group)

    return step
