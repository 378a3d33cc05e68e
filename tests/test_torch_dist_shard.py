"""The port's row-sharded SpMM and SDDMM (`dgsparse_tpu_torch/dist/shard.py`)
against `dgsparse_tpu/dist/shard.py` and against the port's unsharded ops.

The port runs as 4 gloo ranks on the CPU (`dist.launch.run_ranks`, once
for the whole file: `dist/cases.py` computes every case's blocks), JAX on
its virtual 8-device mesh in this process, both on the same numpy inputs.
Tolerance: rtol 1e-4 / atol 1e-5 in float32, `tests/test_dist.py`'s own.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import dgsparse_tpu_torch as pt
from dgsparse_tpu import SparseTensor
from dgsparse_tpu.dist import (pad_nodes, sddmm_sharded, shard_csr,
                               spmm_feature_sharded, spmm_sharded)
from dgsparse_tpu.dist.shard import spmm_sharded_2d
from dgsparse_tpu.ops.sddmm import sddmm as jx_sddmm
from dgsparse_tpu.utils.testing import random_csr
from dgsparse_tpu_torch.dist import cases, shard as pt_shard
from dgsparse_tpu_torch.dist.launch import run_ranks
from dgsparse_tpu_torch.utils.testing import sddmm_oracle

WORLD = 4
TOL = dict(rtol=1e-4, atol=1e-5)
REDUCES = ("sum", "mean")
BALANCES = ("rows", "edges")


def _graph(m, n, feat, seed, **kw):
    rowptr, col, values = random_csr(m, n, seed=seed, **kw)
    rng = np.random.default_rng(seed + 1)
    return dict(rowptr=rowptr, col=col, values=values, shape=(m, n),
                x=rng.standard_normal((n, feat)).astype(np.float32),
                ct=rng.standard_normal((m, feat)).astype(np.float32))


# the JAX tests' graphs: make(seed) is 200 x 200 at degree 6, F = 16
GRAPHS = {
    "sum": _graph(200, 200, 16, 0, avg_degree=6.0),
    "mean": _graph(200, 200, 16, 0, avg_degree=6.0),
    "backward": _graph(200, 200, 16, 3, avg_degree=6.0),
    "feature": _graph(200, 200, 16, 31, avg_degree=6.0),
    "2d": _graph(97, 83, 16, 21, avg_degree=6.0),
    "2d_grad": _graph(64, 64, 8, 22, avg_degree=6.0),
    "edges": _graph(240, 240, 12, 60, avg_degree=7.0, skew=1.5),
    "sddmm": _graph(200, 200, 16, 5, avg_degree=6.0),
}
_SD = GRAPHS["sddmm"]
_SD_RNG = np.random.default_rng(11)
SDDMM_Y = _SD_RNG.standard_normal((200, 16)).astype(np.float32)
SDDMM_CT = _SD_RNG.standard_normal(len(_SD["col"])).astype(np.float32)


def _cases():
    out = {}
    for r in REDUCES:
        out[r] = dict(op="spmm", balance="rows", reduce=r, **GRAPHS[r])
    out["backward"] = dict(op="spmm", balance="rows", reduce="sum",
                           **GRAPHS["backward"])
    out["feature"] = dict(op="feature", reduce="sum", **GRAPHS["feature"])
    out["2d"] = dict(op="spmm2d", mesh=(2, 2), **GRAPHS["2d"])
    out["2d_grad"] = dict(op="spmm2d", mesh=(2, 2), **GRAPHS["2d_grad"])
    out["edges"] = dict(op="spmm", balance="edges", reduce="sum",
                        **GRAPHS["edges"])
    for b in BALANCES:
        for r in REDUCES:
            out[f"sddmm-{b}-{r}"] = dict(
                op="sddmm", balance=b, reduce=r, y=SDDMM_Y, ct=SDDMM_CT,
                **{k: v for k, v in _SD.items() if k != "ct"})
    return out


@pytest.fixture(scope="module")
def port():
    """Every case's per-rank results, from one run of 4 gloo ranks."""
    named = _cases()
    res = run_ranks(cases.run_cases, WORLD, device="cpu", timeout_s=120,
                    args=(list(named.values()),))
    assert not any(r.jax_loaded for r in res)
    return {name: [r.result[i] for r in res]
            for i, name in enumerate(named)}


def _sp_pt(g):
    return pt.SparseTensor.from_csr(g["rowptr"], g["col"],
                                    torch.from_numpy(g["values"]),
                                    sparse_sizes=g["shape"])


def _sp_jx(g):
    return SparseTensor.from_csr(jnp.asarray(g["rowptr"]),
                                 jnp.asarray(g["col"]),
                                 jnp.asarray(g["values"]),
                                 sparse_sizes=g["shape"])


def _adj(g, num_shards=WORLD, balance="rows"):
    return pt_shard.shard_csr(_sp_pt(g), num_shards, balance)


def _rows(blocks, key, adj):
    """The ranks' row blocks as [num_rows, ...]."""
    stacked = torch.from_numpy(np.concatenate([b[key] for b in blocks]))
    return adj.from_block_layout(stacked).numpy()


def _nodes(blocks, key, adj, n):
    """The ranks' node blocks (pad_nodes or block layout) as [n, ...]."""
    stacked = torch.from_numpy(np.concatenate([b[key] for b in blocks]))
    if adj.balance == "edges":
        return adj.from_block_layout(stacked).numpy()
    return stacked[:n].numpy()


def _mesh(shape=None, names=("graph",), count=8):
    devs = np.array(jax.devices()[:count])
    return Mesh(devs.reshape(shape) if shape else devs, names)


def _jx_spmm_1d(g, reduce, d=8, balance="rows"):
    sp = _sp_jx(g)
    mesh = _mesh(count=d)
    sharded = shard_csr(sp, d, balance=balance)
    x = jnp.asarray(g["x"])
    xp = sharded.to_block_layout(x) if balance == "edges" else pad_nodes(x, d)
    xp = jax.device_put(xp, NamedSharding(mesh, P("graph")))
    out = spmm_sharded(sharded, xp, mesh, reduce=reduce)
    return np.asarray(sharded.from_block_layout(out)), sharded, xp, mesh


@pytest.mark.parametrize("balance", BALANCES)
def test_shard_csr_arrays_match_jax(balance):
    g = GRAPHS["edges"]
    mine = _adj(g, WORLD, balance)
    ref = shard_csr(_sp_jx(g), WORLD, balance=balance)
    for name in ("rowptr", "col", "values", "local_row", "edge_map"):
        a, b = getattr(mine, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("num_shards", "rows_per_shard", "num_rows", "num_cols",
                 "row_starts"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.max_nnz == ref.col.shape[1]
    x = torch.from_numpy(g["x"])
    np.testing.assert_array_equal(
        mine.to_block_layout(x).numpy(),
        np.asarray(ref.to_block_layout(jnp.asarray(g["x"]))))


@pytest.mark.parametrize("reduce", REDUCES)
def test_sharded_matches_jax_and_single_device(port, reduce):
    g = GRAPHS[reduce]
    out = _rows(port[reduce], "out", _adj(g))
    ref, *_ = _jx_spmm_1d(g, reduce)
    np.testing.assert_allclose(out, ref, **TOL)
    single = pt.spmm(_sp_pt(g), torch.from_numpy(g["x"]), reduce)
    np.testing.assert_allclose(out, single.numpy(), **TOL)
    assert port[reduce][0]["volumes"]["all_gather"] == 50 * 16


def test_sharded_backward_matches(port):
    g = GRAPHS["backward"]
    adj = _adj(g)
    dx = _nodes(port["backward"], "dx", adj, 200)
    _, sharded, xp, mesh = _jx_spmm_1d(g, "sum")
    ct = jnp.asarray(np.asarray(sharded.to_block_layout(jnp.asarray(g["ct"]))))
    g_jx = jax.grad(lambda xs: jnp.vdot(spmm_sharded(sharded, xs, mesh),
                                        ct))(xp)
    np.testing.assert_allclose(dx, np.asarray(g_jx)[:200], **TOL)
    x = torch.from_numpy(g["x"]).requires_grad_()
    (pt.spmm(_sp_pt(g), x) * torch.from_numpy(g["ct"])).sum().backward()
    np.testing.assert_allclose(dx, x.grad.numpy(), **TOL)


def test_feature_sharded_matches(port):
    g = GRAPHS["feature"]
    out = np.concatenate([b["out"] for b in port["feature"]], axis=1)
    assert all(not any(b["volumes"].values()) for b in port["feature"])
    mesh = _mesh()
    ref = jax.jit(lambda x_: spmm_feature_sharded(_sp_jx(g), x_, mesh))(
        jnp.asarray(g["x"]))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    single = pt.spmm(_sp_pt(g), torch.from_numpy(g["x"]))
    np.testing.assert_allclose(out, single.numpy(), **TOL)


def _blocks_2d(blocks, key, rows):
    """[G * rows, F] from the (graph, feat) blocks of a 2-D mesh."""
    graph = 1 + max(b["coords"][0] for b in blocks)
    feat = 1 + max(b["coords"][1] for b in blocks)
    grid = [[None] * feat for _ in range(graph)]
    for b in blocks:
        grid[b["coords"][0]][b["coords"][1]] = b[key][:rows]
    return np.concatenate([np.concatenate(r, axis=1) for r in grid])


def test_spmm_sharded_2d(port):
    g = GRAPHS["2d"]
    out = _blocks_2d(port["2d"], "out", 49)[:97]
    mesh = _mesh((4, 2), ("graph", "feat"))
    adj = shard_csr(_sp_jx(g), 4)
    x = jax.device_put(pad_nodes(jnp.asarray(g["x"]), 4),
                       NamedSharding(mesh, P("graph", "feat")))
    ref = np.asarray(spmm_sharded_2d(adj, x, mesh))[:97]
    np.testing.assert_allclose(out, ref, **TOL)
    single = pt.spmm(_sp_pt(g), torch.from_numpy(g["x"]))
    np.testing.assert_allclose(out, single.numpy(), **TOL)


def test_spmm_sharded_2d_grad(port):
    g = GRAPHS["2d_grad"]
    dx = _blocks_2d(port["2d_grad"], "dx", 32)
    mesh = _mesh((2, 4), ("graph", "feat"))
    adj = shard_csr(_sp_jx(g), 2)
    x = jax.device_put(jnp.asarray(g["x"]),
                       NamedSharding(mesh, P("graph", "feat")))
    ct = jnp.asarray(g["ct"])
    g_jx = jax.grad(lambda x_: jnp.vdot(spmm_sharded_2d(adj, x_, mesh),
                                        ct))(x)
    np.testing.assert_allclose(dx, np.asarray(g_jx), **TOL)
    x = torch.from_numpy(g["x"]).requires_grad_()
    (pt.spmm(_sp_pt(g), x) * torch.from_numpy(g["ct"])).sum().backward()
    np.testing.assert_allclose(dx, x.grad.numpy(), **TOL)


def test_spmm_2d_mesh_halves_gather_volume(port):
    """A (graph 2 x feat 2) mesh all-gathers, per rank, half of what the
    1-D mesh of the same graph axis does, and gives the same result."""
    blocks = port["2d"]
    v1 = {b["volumes_1d"]["all_gather"] for b in blocks}
    v2 = {b["volumes"]["all_gather"] for b in blocks}
    assert v1 == {42 * 16} and v2 == {42 * 8}, (v1, v2)
    out_1d = np.concatenate([b["out_1d"] for b in blocks
                             if b["coords"][1] == 0])
    np.testing.assert_allclose(_blocks_2d(blocks, "out", 49), out_1d, **TOL)


def test_edge_balanced_sharding_matches(port):
    g = GRAPHS["edges"]
    adj_r, adj_e = _adj(g, WORLD, "rows"), _adj(g, WORLD, "edges")
    nnz = len(g["col"])
    assert adj_e.nnz.max() <= adj_r.nnz.max()
    assert adj_e.nnz.max() <= int(1.6 * nnz / 4) + 64
    out = _rows(port["edges"], "out", adj_e)
    ref, *_ = _jx_spmm_1d(g, "sum", d=4, balance="edges")
    np.testing.assert_allclose(out, ref, **TOL)
    x = torch.from_numpy(g["x"]).requires_grad_()
    single = pt.spmm(_sp_pt(g), x)
    np.testing.assert_allclose(out, single.detach().numpy(), **TOL)
    (single * torch.from_numpy(g["ct"])).sum().backward()
    np.testing.assert_allclose(_nodes(port["edges"], "dx", adj_e, 240),
                               x.grad.numpy(), **TOL)


def test_edge_balance_rejects_rectangular():
    rowptr, col, values = random_csr(60, 50, avg_degree=4, seed=62)
    sp = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                  sparse_sizes=(60, 50))
    with pytest.raises(ValueError, match="square graph"):
        pt_shard.shard_csr(sp, 4, balance="edges")


@pytest.mark.parametrize("balance", BALANCES)
@pytest.mark.parametrize("reduce", REDUCES)
def test_sharded_sddmm_matches(port, balance, reduce):
    g = _SD
    adj = _adj(g, WORLD, balance)
    blocks = port[f"sddmm-{balance}-{reduce}"]
    e = adj.edges_to_csr(torch.from_numpy(
        np.stack([b["e"] for b in blocks]))).numpy()
    oracle = sddmm_oracle(g["rowptr"], g["col"], g["x"], SDDMM_Y, reduce)
    np.testing.assert_allclose(e, oracle, **TOL)
    # JAX's sharded SDDMM on its 8-device mesh
    sp = _sp_jx(g)
    mesh = _mesh()
    sharded = shard_csr(sp, 8, balance=balance)
    x, y = jnp.asarray(g["x"]), jnp.asarray(SDDMM_Y)
    row = NamedSharding(mesh, P("graph"))
    xb = jax.device_put(sharded.to_block_layout(x), row)
    yb = jax.device_put(sharded.to_block_layout(y) if balance == "edges"
                        else pad_nodes(y, 8), row)
    ref = np.asarray(sharded.edges_to_csr(
        sddmm_sharded(sharded, xb, yb, mesh, reduce=reduce)))
    np.testing.assert_allclose(e, ref, **TOL)
    single = pt.sddmm(_sp_pt(g), torch.from_numpy(g["x"]),
                      torch.from_numpy(SDDMM_Y), reduce)
    np.testing.assert_allclose(e, single.numpy(), **TOL)
    # padding slots hold zeros
    for b, k in zip(blocks, adj.nnz):
        assert not b["e"][k:].any()


@pytest.mark.parametrize("balance", BALANCES)
def test_sharded_sddmm_grads_match(port, balance):
    g = _SD
    adj = _adj(g, WORLD, balance)
    blocks = port[f"sddmm-{balance}-sum"]
    dx, dy = _rows(blocks, "dx", adj), _nodes(blocks, "dy", adj, 200)
    x = jnp.asarray(g["x"])
    y = jnp.asarray(SDDMM_Y)
    gx, gy = jax.grad(lambda a, b: jnp.vdot(jx_sddmm(_sp_jx(g), a, b),
                                            jnp.asarray(SDDMM_CT)),
                      argnums=(0, 1))(x, y)
    np.testing.assert_allclose(dx, np.asarray(gx), **TOL)
    np.testing.assert_allclose(dy, np.asarray(gy), **TOL)


def test_dist_exports_match_jax():
    import dgsparse_tpu.dist as jx_dist
    import dgsparse_tpu_torch.dist as pt_dist

    assert sorted(pt_dist.__all__) == sorted(jx_dist.__all__)
    assert all(hasattr(pt_dist, name) for name in pt_dist.__all__)


def test_run_ranks_raises_for_a_failing_rank():
    """Rank 1 raises; rank 0 waits for it in a barrier: the call raises
    (whichever rank reports first) within its limit."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank [01] failed"):
        run_ranks(cases.run_cases, 2, device="cpu", timeout_s=60,
                  args=([dict(op="fail", rank=1)],))
    assert time.monotonic() - t0 < 60


def test_run_ranks_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The ranks' default device is the card: on a host without one the
    call raises before it starts a rank, rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(cases.run_cases, 2, timeout_s=60, args=([],))


def test_sharded_ops_refuse_max():
    g = GRAPHS["sum"]
    adj = _adj(g)
    x = torch.zeros(50, 16)
    for fn, a in ((pt_shard.spmm_sharded, (adj, x, None, "max")),
                  (pt_shard.sddmm_sharded, (adj, x, x, None, "max"))):
        with pytest.raises(ValueError, match="supports sum/mean"):
            fn(*a)
