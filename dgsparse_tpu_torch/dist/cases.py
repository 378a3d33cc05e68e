"""Rank bodies for `launch.run_ranks`: the sharded ops, training steps and
conv on inputs given as numpy, each rank returning its own blocks.

`run_cases(rank, world_size, device, cases, run_steps=None)` runs a list
of cases, each a dict with an "op" (a key of `OPS`) and its inputs, on the
default process group, and returns one dict of tensors a case. The CPU
tests hold them against the JAX package's `dist/`, `chip_smoke.py` against
the single-card path on the card; they live in the port so that a rank's
process imports no JAX. Graph cases carry a CSR (`rowptr`, `col`, `values`
or None, `shape`) and global features; a rank takes its block by the
plan's layout. The ops return their padded blocks; the models' logits and
the conv's rows are cut to the rank's real rows. Each op case also returns
the collective volumes of its forward (`utils.testing.collective_volumes`).

`run_steps(fn, n)` -> ([fn() for each of n calls], timing or None) runs
the repeated part of the "gcn" and "gat" cases (the SGD steps) and of the
"spconv" case (forward and backward, c["calls"] times); the default calls
fn n times and times nothing.
"""

import numpy as np
import torch
import torch.distributed as dist

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.dist import gat, gcn
from dgsparse_tpu_torch.dist.shard import (pad_nodes, sddmm_sharded,
                                           shard_csr, spmm_feature_sharded,
                                           spmm_sharded, spmm_sharded_2d)
from dgsparse_tpu_torch.dist.spconv import (shard_pointcloud,
                                            spconv_sharded,
                                            spconv_sharded_plain)
from dgsparse_tpu_torch.utils.testing import collective_volumes


def _untimed(fn, n):
    return [fn() for _ in range(n)], None


def _sparse(c, device="cpu") -> SparseTensor:
    vals = c.get("values")
    return SparseTensor.from_csr(
        c["rowptr"], c["col"], None if vals is None else torch.from_numpy(vals),
        sparse_sizes=tuple(c["shape"]), device=device, build_plans=False)


def _rows(x: torch.Tensor, part: int, rows: int) -> torch.Tensor:
    return x[part * rows:(part + 1) * rows]


def _node_block(adj, x: np.ndarray, rank: int) -> torch.Tensor:
    """This rank's block of node features x [n, ...]: the block layout
    under balance="edges", else pad_nodes."""
    x = torch.from_numpy(x)
    if adj.balance == "edges":
        return _rows(adj.to_block_layout(x), rank, adj.rows_per_shard)
    return _rows(pad_nodes(x, adj.num_shards), rank,
                 adj.n_gather // adj.num_shards)


def _real_rows(adj, rank: int) -> int:
    lo, hi = adj.row_range(rank)
    return hi - lo


def _backward(out, ct, *inputs):
    """The gradients of <out, ct> with respect to inputs."""
    return torch.autograd.grad((out * ct).sum(), inputs)


def _losses(values) -> torch.Tensor:
    return torch.tensor([float(v) for v in values])


def _spmm(device, c, run_steps):
    rank = dist.get_rank()
    adj = shard_csr(_sparse(c), dist.get_world_size(), c["balance"])
    x = _node_block(adj, c["x"], rank).to(device).requires_grad_()
    out = spmm_sharded(adj, x, None, c["reduce"])
    vols = collective_volumes(spmm_sharded, adj, x, None, c["reduce"])
    ct = _rows(adj.to_block_layout(torch.from_numpy(c["ct"])), rank,
               adj.rows_per_shard).to(device)
    dx, = _backward(out, ct, x)
    return {"out": out, "dx": dx, "volumes": vols}


def _sddmm(device, c, run_steps):
    rank = dist.get_rank()
    adj = shard_csr(_sparse(c), dist.get_world_size(), c["balance"])
    x = _rows(adj.to_block_layout(torch.from_numpy(c["x"])), rank,
              adj.rows_per_shard).to(device).requires_grad_()
    y = _node_block(adj, c["y"], rank).to(device).requires_grad_()
    e = sddmm_sharded(adj, x, y, None, c["reduce"])
    vols = collective_volumes(sddmm_sharded, adj, x, y, None, c["reduce"])
    ct = torch.zeros(adj.num_shards * adj.max_nnz)
    ct[torch.from_numpy(adj.edge_map).long()] = torch.from_numpy(c["ct"])
    dx, dy = _backward(e, _rows(ct, rank, adj.max_nnz).to(device), x, y)
    return {"e": e, "dx": dx, "dy": dy, "volumes": vols}


def _feature(device, c, run_steps):
    rank, world = dist.get_rank(), dist.get_world_size()
    fs = c["x"].shape[1] // world
    x = torch.from_numpy(c["x"][:, rank * fs:(rank + 1) * fs]).to(device)
    sp = _sparse(c, device)
    out = spmm_feature_sharded(sp, x, c["reduce"])
    vols = collective_volumes(spmm_feature_sharded, sp, x, c["reduce"])
    return {"out": out, "volumes": vols}


def _spmm2d(device, c, run_steps):
    """spmm_sharded_2d on a (graph x feat) mesh and spmm_sharded on its
    graph axis alone (every feature on each rank): blocks, d_x and the
    volumes of both."""
    from torch.distributed.device_mesh import init_device_mesh

    graph, feat = c["mesh"]
    # on gloo the mesh only names the groups: comm stages CUDA tensors
    mesh = init_device_mesh(
        "cpu" if dist.get_backend() == "gloo" else device.type,
        (graph, feat), mesh_dim_names=("graph", "feat"))
    gr, fr = mesh.get_local_rank("graph"), mesh.get_local_rank("feat")
    adj = shard_csr(_sparse(c), graph)
    out = {"coords": (gr, fr)}
    fs = c["x"].shape[1] // feat
    graph_group = mesh.get_group("graph")
    for name, cols, fn in (
            ("", slice(fr * fs, (fr + 1) * fs),
             lambda xb: spmm_sharded_2d(adj, xb, mesh)),
            ("_1d", slice(None),
             lambda xb: spmm_sharded(adj, xb, graph_group))):
        x = _node_block(adj, np.ascontiguousarray(c["x"][:, cols]), gr)
        x = x.to(device).requires_grad_()
        y = fn(x)
        ct = _rows(adj.to_block_layout(torch.from_numpy(
            np.ascontiguousarray(c["ct"][:, cols]))), gr, adj.rows_per_shard)
        dx, = _backward(y, ct.to(device), x)
        out.update({f"out{name}": y, f"dx{name}": dx,
                    f"volumes{name}": collective_volumes(fn, x)})
    return out


def _train(step, params, x, y, mask, c, run_steps) -> dict:
    """c["steps"] SGD steps of `step` from params: their losses and the
    parameters after each."""
    state = [params]

    def one():
        state[0], loss = step(state[0], x, y, mask)
        return state[0], loss

    outs, timing = run_steps(one, c["steps"])
    return {"losses": _losses(o[1] for o in outs),
            "params": [o[0] for o in outs], "time": timing}


def _gcn(device, c, run_steps):
    """The GCN's logits and loss at c["params"], then its SGD steps
    (`make_train_step`)."""
    adj, x, y, mask = gcn.prepare_inputs(_sparse(c), c["x"], c["y"], None,
                                         device, c.get("balance", "rows"))
    params = gcn.params_from_jax(c["params"], device)
    with torch.no_grad():
        logits = gcn.forward(params, adj, x)
        loss = gcn.loss_fn(params, adj, x, y, mask)
    return dict(_train(gcn.make_train_step(None, adj, c["lr"]), params, x,
                       y, mask, c, run_steps),
                logits=logits[:_real_rows(adj, dist.get_rank())], loss=loss)


def _gat(device, c, run_steps):
    """The GAT's logits and global gradients at c["params"], then its SGD
    steps."""
    adj, x, y, mask = gcn.prepare_inputs(_sparse(c), c["x"], c["y"], None,
                                         device)
    params = gat.params_from_jax(c["params"], device)
    heads = c["heads"]
    with torch.no_grad():
        logits = gat.forward(params, adj, x, None, heads)
    _, grads = gcn.value_and_grad(
        lambda p: gat.loss_fn(p, adj, x, y, mask, None, heads), params)
    return dict(_train(gat.make_train_step(None, adj, heads, c["lr"]),
                       params, x, y, mask, c, run_steps),
                logits=logits[:_real_rows(adj, dist.get_rank())],
                grads=grads)


def _spconv(device, c, run_steps):
    """spconv_sharded on this rank's slab, c.get("calls", 1) times, and
    with a cotangent c["ct"] its gradients (dW global); the last call's
    rows, the forward's volumes and, with c["plain"], the plain version's
    rows."""
    rank = dist.get_rank()
    plan, order = shard_pointcloud(c["coords"], dist.get_world_size(),
                                   c["kernel_size"], c["spatial_shape"])
    count = plan.counts[rank]

    def block(a):
        return _rows(plan.to_block_layout(torch.from_numpy(a[order])), rank,
                     plan.own_max).to(device)

    x = block(c["feats"]).requires_grad_()
    w = torch.from_numpy(c["kernel"]).to(device).requires_grad_()
    ct = block(c["ct"]) if "ct" in c else None

    def one():
        out = spconv_sharded(plan, x, w)
        if ct is None:
            return out.detach(), None, None
        return (out.detach(),) + _backward(out, ct, x, w)

    outs, timing = run_steps(one, c.get("calls", 1))
    out, dx, dw = outs[-1]
    res = {"out": out[:count], "dx": None if dx is None else dx[:count],
           "dw": dw, "volumes": collective_volumes(spconv_sharded, plan, x,
                                                   w),
           "h_max": plan.h_max, "own_max": plan.own_max, "time": timing}
    if c.get("plain"):
        with torch.no_grad():
            res["plain"] = spconv_sharded_plain(plan, x, w)[:count]
    return res


def _gat_aggregate(device, c, run_steps):
    rank = dist.get_rank()
    adj = shard_csr(_sparse(c), dist.get_world_size())
    h, sd, ss = (_node_block(adj, c[k], rank).to(device)
                 for k in ("h", "sd", "ss"))
    out = gat.gat_aggregate_sharded(adj, h, sd, ss)
    vols = collective_volumes(gat.gat_aggregate_sharded, adj, h, sd, ss)
    return {"out": out, "volumes": vols}


def _fail(device, c, run_steps):
    if dist.get_rank() == c["rank"]:
        raise RuntimeError(f"rank {c['rank']} raises on purpose")
    dist.barrier()    # the others wait in a collective for the one that left
    return {}


OPS = {"spmm": _spmm, "sddmm": _sddmm, "feature": _feature,
       "spmm2d": _spmm2d, "gcn": _gcn, "gat": _gat,
       "gat_aggregate": _gat_aggregate, "spconv": _spconv, "fail": _fail}


def run_cases(rank: int, world_size: int, device, cases,
              run_steps=None) -> list:
    """One result dict a case, in order (see the module docstring)."""
    run_steps = run_steps or _untimed
    return [OPS[c["op"]](device, c, run_steps) for c in cases]
