"""Row-sharded 2-layer GCN training step over the ranks of a process group.

Counterpart of `dgsparse_tpu/dist/gcn.py`: the adjacency row-block sharded
(`ShardedCSR`), node features and labels sharded by node, parameters
replicated (a dict of tensors, as JAX's pytree). The forward all-gathers
activations inside each `spmm_sharded`; the backward reduce-scatters their
gradients; the parameter gradients are then all-reduced once.

The loss is JAX's global masked mean, sum(nll * mask) / sum(mask) over all
ranks' rows: `loss_fn` returns it on every rank, with the gradient of this
rank's share sum_rank(nll * mask) / sum(mask). The all-gathers' backward
already sums the activations' gradients over the ranks, so summing the
shares' parameter gradients over the ranks (one `all_reduce`) gives the
global gradient; reducing anything twice would double it.
"""

from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from dgsparse_tpu_torch.dist import comm
from dgsparse_tpu_torch.dist.shard import ShardedCSR, shard_csr, spmm_sharded
from dgsparse_tpu_torch.entry import resolve_device

Params = Dict[str, torch.Tensor]


def _uniform(generator, shape, scale) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2 - 1) * scale


def init_params(generator: torch.Generator, f_in: int, f_hidden: int,
                f_out: int) -> Params:
    """Glorot-uniform weights from `generator`, zero biases (on the CPU;
    move them with `.to`)."""
    s1 = (6.0 / (f_in + f_hidden)) ** 0.5
    s2 = (6.0 / (f_hidden + f_out)) ** 0.5
    return {"w1": _uniform(generator, (f_in, f_hidden), s1),
            "b1": torch.zeros(f_hidden),
            "w2": _uniform(generator, (f_hidden, f_out), s2),
            "b2": torch.zeros(f_out)}


def params_from_jax(params, device="cpu") -> Params:
    """JAX's parameter dict (numpy or JAX arrays) as float32 tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in params.items()}


def forward(params: Params, adj: ShardedCSR, x: torch.Tensor,
            group=None) -> torch.Tensor:
    """This rank's logits [rows_per_shard, C] from its node block x: Dense
    then SpMM, twice (`dgsparse_tpu/dist/gcn.py:32-42`)."""
    h = x @ params["w1"] + params["b1"]
    h = torch.relu(spmm_sharded(adj, h, group))
    h = h @ params["w2"] + params["b2"]
    return spmm_sharded(adj, h, group)


def masked_nll(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
               group=None) -> torch.Tensor:
    """The global masked mean of the cross-entropy, with the gradient of
    this rank's share (see the module docstring). Padded rows carry y = -1
    and mask 0."""
    ls = torch.log_softmax(logits, dim=-1)
    nll = -ls.gather(1, y.clamp(min=0).long()[:, None])[:, 0]
    count, = comm.all_reduce([mask.sum()], group)
    share = (nll * mask).sum() / count.clamp(min=1)
    total, = comm.all_reduce([share], group)
    return share + (total - share.detach())


def loss_fn(params: Params, adj: ShardedCSR, x: torch.Tensor,
            y: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    return masked_nll(forward(params, adj, x, group), y, mask, group)


def value_and_grad(loss_of: Callable[[Params], torch.Tensor],
                   params: Params, group=None):
    """(loss, global gradient dict) of loss_of(params): the gradients of
    this rank's share all-reduced once."""
    params = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_of(params)
    grads = comm.all_reduce(torch.autograd.grad(loss, list(params.values())),
                            group)
    return loss.detach(), dict(zip(params, grads))


def sgd_step(loss_of: Callable[[Params], torch.Tensor], params: Params,
             lr: float, group=None):
    """(params - lr * global gradient, loss)."""
    loss, grads = value_and_grad(loss_of, params, group)
    return {k: (p - lr * grads[k]).detach() for k, p in params.items()}, loss


def make_train_step(group, adj: ShardedCSR, lr: float = 1e-2):
    """(params, x, y, mask) -> (params, loss): one SGD step on this rank's
    node block, every rank calling it with the same params."""
    def step(params, x, y, mask):
        return sgd_step(lambda p: loss_fn(p, adj, x, y, mask, group),
                        params, lr, group)

    return step


def _rank_rows(a: np.ndarray, lo: int, hi: int, rows: int,
               fill) -> np.ndarray:
    """Rows [lo, hi) of a, padded with `fill` to `rows`."""
    out = np.full((rows,) + a.shape[1:], fill, a.dtype)
    out[:hi - lo] = a[lo:hi]
    return out


def prepare_inputs(sp, x, y, group=None, device="cuda",
                   balance: str = "rows"):
    """(adj, x, y, mask) of this rank: the sharded adjacency and its node
    block of x, of the labels (-1 on padding) and of the mask (1 for a real
    labelled row) on `device`; the blocks follow `adj.to_block_layout`, so
    balance="edges" (square graphs) works as "rows" does."""
    device = resolve_device(device)
    adj = shard_csr(sp, dist.get_world_size(group), balance)
    rank, rps = dist.get_rank(group), adj.rows_per_shard
    lo, hi = adj.row_range(rank)
    xr = _rank_rows(np.asarray(x, np.float32), lo, hi, rps, 0.0)
    yr = _rank_rows(np.asarray(y).astype(np.int64), lo, hi, rps, -1)
    mask = (yr >= 0).astype(np.float32)
    return (adj,) + tuple(torch.from_numpy(a).to(device)
                          for a in (xr, yr, mask))
