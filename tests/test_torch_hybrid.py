"""The port's hybrid plan, dense-cell kernels (plain versions on the CPU),
hybrid SpMM/SDDMM and GCN against the JAX package.

Graphs are community-clustered CSRs in the manner of
`tests/test_hybrid.py::clustered_csr`: duplicate edges, an empty row every
17, and (`sparse_block`) one row block whose edges ignore the communities,
so that it holds BELL and residue edges but no dense cell. The JAX side
runs `build_hybrid_plan`, `materialize_cells_np`, and the Pallas kernels
`spmm_dense_cells`, `sddmm_cells` and the hybrid routes
(`spmm(..., PALLAS_ROW_TILE)`, `sddmm_hybrid`) in interpret mode.

The JAX `spmm_dense_cells` never writes an output block that no cell
visits (its `out_specs` reach `seg[t]` only), so in interpret mode those
rows are NaN there and in JAX's hybrid SpMM; the port writes them as zero.
Comparisons with the JAX hybrid routes therefore skip the rows (and, for
the transpose, the columns) of blocks without a cell, check that JAX's are
not finite there, and hold the port's to JAX's `XLA_SEGMENT` everywhere.

Tolerances: plans, slots and cells exactly; kernels and SpMMs at 1e-5
(float32 sums in another order: the cells at Precision.HIGHEST), the
SpMM gradients at rtol 1e-4, the GCN at 1e-4 as in `test_torch_train.py`.

`tests/fixtures/torch_port/hybrid_small.npz` freezes a GCN forward and 2
Adam steps on the hybrid route for the card's machine, which has no JAX;
`test_hybrid_fixture_is_current` fails if it drifted. Rewrite it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hybrid.py
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.core import planner as jx_planner
from dgsparse_tpu.kernels.pallas_sddmm import sddmm_cells as jx_sddmm_cells
from dgsparse_tpu.kernels.pallas_sddmm import sddmm_hybrid as jx_sddmm_hybrid
from dgsparse_tpu.kernels.pallas_spmm import \
    spmm_dense_cells as jx_spmm_dense_cells
from dgsparse_tpu.nn import gcn as jx_gcn
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.core import planner
from dgsparse_tpu_torch.kernels import launch_counts, spmm_cells
from dgsparse_tpu_torch.utils.testing import (assert_sum_close,
                                              assert_train_close,
                                              clustered_graph, gcn_norm_csr,
                                              hybrid_csr, run_train_fixture)

FIXTURE = Path(__file__).parent / "fixtures" / "torch_port" / \
    "hybrid_small.npz"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
N = 1500                   # hybrid_csr's default size
STEPS = 2


def _pair(seed=0, has_value=True, sparse_block=5, **kw):
    rowptr, col, vals = hybrid_csr(seed=seed, sparse_block=sparse_block,
                                   **kw)
    v = vals if has_value else None
    p = pt.SparseTensor.from_csr(
        rowptr, col, None if v is None else torch.from_numpy(v),
        sparse_sizes=(N, N))
    j = jx.SparseTensor.from_csr(
        jnp.asarray(rowptr), jnp.asarray(col),
        None if v is None else jnp.asarray(v), sparse_sizes=(N, N))
    assert p.storage.ell_plan() is not None
    assert isinstance(j.storage.ell_plan(), jx_planner.HybridPlan)
    return p, j, (rowptr, col, v)


def _visited(blocks, size):
    """Mask [size] of the rows in the given 128-blocks."""
    mask = np.zeros(size, bool)
    for b in np.unique(np.asarray(blocks)):
        mask[b * 128:(b + 1) * 128] = True
    return mask


def _close_where_visited(out, jax_out, mask, tol=TOL):
    """out equals jax_out on the masked rows; jax_out is not finite on the
    others (JAX leaves blocks without a cell unwritten), where out is."""
    np.testing.assert_allclose(out[mask], jax_out[mask], **tol)
    assert np.isfinite(out).all()
    if not mask.all():
        assert not np.isfinite(jax_out[~mask]).all()


def _dense(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# --- generators --------------------------------------------------------------

@pytest.mark.parametrize("m,deg,seed", [(3000, 60.0, 0), (777, 20.5, 3)])
def test_clustered_graph_equals_bench_scale(m, deg, seed):
    sys.path.insert(0, str(Path(__file__).parents[1] / "benchmark"))
    try:
        from bench_scale import clustered_graph as bench_clustered_graph
    finally:
        sys.path.pop(0)
    for a, b in zip(clustered_graph(m, m, deg, seed=seed),
                    bench_clustered_graph(m, m, deg, seed=seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_gcn_norm_csr_is_gcn_normalization_with_loops_last():
    rowptr, col = clustered_graph(600, 600, 30.0, seed=1)
    coo = np.repeat(np.arange(600), np.diff(rowptr))
    assert (coo == col).any()                      # diagonal entries to drop
    rp, cl, vals = gcn_norm_csr(rowptr, col)
    # the JAX normalization of the same edges, self-loops added
    off = coo != col
    ref_rp, ref_cl, ref_vals = jx_gcn.gcn_norm_from_edge_index(
        np.stack([coo[off], col[off]]).astype(np.int32), 600)
    np.testing.assert_array_equal(rp, ref_rp)
    for r in range(600):
        s, e = rp[r], rp[r + 1]
        assert cl[e - 1] == r                      # the loop ends the row
        got = sorted(zip(cl[s:e], vals[s:e]))
        want = sorted(zip(ref_cl[s:e], ref_vals[s:e]))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=1, deg=60, comm=200),
                                dict(seed=2, sparse_block=None, n=1400)])
def test_plan_matches_jax_build_hybrid_plan(kw):
    n = kw.pop("n", N)
    rowptr, col, _ = hybrid_csr(n=n, m=n, **kw)
    assert len(np.unique(np.stack([np.repeat(np.arange(n), np.diff(rowptr)),
                                   col]), axis=1)[0]) < len(col)  # duplicates
    jp = jx_planner.build_hybrid_plan(rowptr, col, n)
    pp = planner.build_hybrid_plan(rowptr, col, n)
    assert pp.nnz == jp.nnz and pp.dense_fraction == jp.dense_fraction
    jc, pc = jp.cells, pp.cells
    assert pc.num_cells == jc.num_cells > 0
    np.testing.assert_array_equal(pc.slot, jc.slot.np)
    np.testing.assert_array_equal(pc.eperm, jc.eperm.np)
    for name in ("cell_rb", "cell_cw", "t_order"):
        np.testing.assert_array_equal(getattr(pc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    t_order = pc.t_order.long()
    np.testing.assert_array_equal(pc.cell_rb[t_order].numpy(),
                                  np.asarray(jc.t_rb))
    np.testing.assert_array_equal(pc.cell_cw[t_order].numpy(),
                                  np.asarray(jc.t_cw))
    jb, pb = jp.bell, pp.bell
    assert (pb.num_tiles, pb.edge_tile) == (jb.num_tiles, jb.edge_tile)
    np.testing.assert_array_equal(pb.eperm, np.asarray(jb.eperm))
    for name in ("lcol", "lrow", "tile_rb", "tile_cw"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    # the residue: the same edge set as JAX's bucketed ELL, in CSR order
    je = np.asarray(jp.ell.eperm)
    np.testing.assert_array_equal(pp.res.ids, np.sort(je[je >= 0]))
    np.testing.assert_array_equal(pp.res.col.numpy(), col[pp.res.ids])
    # the non-cell transpose: the edges and order of JAX's transpose sub-CSC
    colptr_t, row_t, ids_t = jp.ell_t._sub_csr_host
    np.testing.assert_array_equal(pp.nd_t.rowptr.numpy(), colptr_t)
    np.testing.assert_array_equal(pp.nd_t.col.numpy(), row_t)
    np.testing.assert_array_equal(pp.nd_t.ids, ids_t)
    # edge_src: JAX's cell slots; then the non-cell edges in CSR order
    src, jsrc = pp.edge_src.numpy(), np.asarray(jp.edge_src)
    in_cells = np.zeros(len(col), bool)
    in_cells[pc.eperm] = True
    np.testing.assert_array_equal(src[in_cells], jsrc[in_cells])
    np.testing.assert_array_equal(src[pp.nd.ids],
                                  pc.cell_slots + np.arange(pp.nd.nnz))
    # every edge in exactly one tier
    bell_ids = pb.eperm[pb.eperm >= 0]
    np.testing.assert_array_equal(
        np.sort(np.concatenate([pc.eperm, bell_ids, pp.res.ids])),
        np.arange(len(col)))


@pytest.mark.parametrize("has_value", [True, False])
def test_cached_cells_equal_materialize_cells_np(has_value):
    p, j, (_, _, v) = _pair(seed=4, has_value=has_value)
    tiers = p.storage.tier_values(ones=not has_value)
    ref = jx_planner.materialize_cells_np(j.storage.ell_plan().cells, v)
    np.testing.assert_array_equal(tiers["cells"].numpy(), ref)
    jx_cells = j.storage.vslot()["ell"]["cells"]
    np.testing.assert_array_equal(tiers["cells"].numpy(),
                                  np.asarray(jx_cells))


@pytest.mark.parametrize("case", ["clustered", "no-blocks-sparse",
                                  "low-degree", "uniform", "small"])
def test_gate_matches_jax_storage(case):
    rng = np.random.default_rng(9)
    if case == "clustered":
        rowptr, col, _ = hybrid_csr(seed=5)
    elif case == "no-blocks-sparse":
        rowptr, col, _ = hybrid_csr(seed=6, sparse_block=None)
    elif case == "low-degree":                     # clustered, avg deg < 16
        rowptr, col, _ = hybrid_csr(seed=7, deg=12)
    elif case == "uniform":                        # deg 24, cells never fill
        n = 12000
        col = np.sort(rng.integers(0, n, (n, 24)), axis=1).astype(
            np.int32).reshape(-1)
        rowptr = np.arange(0, 24 * n + 1, 24, dtype=np.int32)
    else:                                          # nnz < 4096
        rowptr, col, _ = hybrid_csr(m=100, n=100, deg=30, comm=40,
                                    sparse_block=None)
    n = len(rowptr) - 1
    p = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(n, n))
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 sparse_sizes=(n, n))
    expect = isinstance(j.storage.ell_plan(), jx_planner.HybridPlan)
    assert (p.storage.ell_plan() is not None) == expect
    assert expect == (case in ("clustered", "no-blocks-sparse"))
    off = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(n, n),
                                   build_plans=False)
    assert off.storage.ell_plan() is None


@pytest.mark.parametrize("config", ["cora", "arxiv"])
def test_existing_graphs_get_no_plan(config):
    from dgsparse_tpu_torch.entry import synthetic_graph

    for gcn_norm in (True, False):
        adj, _, _ = synthetic_graph(config, device="cpu", gcn_norm=gcn_norm)
        assert adj.storage.ell_plan() is None
        assert adj.nnz / adj.sparse_sizes()[0] < 16


def test_p2p_shape_gets_no_plan():
    from dgsparse_tpu_torch.utils.testing import random_csr

    rowptr, col, vals = random_csr(62586, 62586, avg_degree=147892 / 62586,
                                   seed=0, skew=1.0)
    p = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                                 sparse_sizes=(62586, 62586))
    assert p.storage.ell_plan() is None


# --- the kernels' plain versions ---------------------------------------------

@pytest.mark.parametrize("feat", [1, 24, 41, 64])
@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_dense_cells_plain_matches_jax(feat, transpose):
    p, j, _ = _pair(seed=8)
    pc, jc = p.storage.ell_plan().cells, j.storage.ell_plan().cells
    cells = p.storage.tier_values()["cells"]
    (x,) = _dense(feat, (N, feat))
    out = spmm_cells.spmm_dense_cells(pc, cells, torch.from_numpy(x),
                                      transpose).numpy()
    ref = np.asarray(jx_spmm_dense_cells(jc, jnp.asarray(cells.numpy()),
                                         jnp.asarray(x), transpose=transpose))
    blocks = pc.cell_cw if transpose else pc.cell_rb
    _close_where_visited(out, ref, _visited(blocks.numpy(), N))
    assert launch_counts()["spmm_dense_cells"] == 0


@pytest.mark.parametrize("feat", [1, 24, 64])
def test_sddmm_cells_plain_matches_jax(feat):
    p, j, _ = _pair(seed=10)
    d1, d2 = _dense(feat, (N, feat), (N, feat))
    out = spmm_cells.sddmm_cells(p.storage.ell_plan().cells,
                                 torch.from_numpy(d1), torch.from_numpy(d2))
    ref = jx_sddmm_cells(j.storage.ell_plan().cells, jnp.asarray(d1),
                         jnp.asarray(d2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# --- spmm and sddmm on a hybrid storage --------------------------------------

@pytest.mark.parametrize("reduce,has_value", [
    ("sum", True), ("mean", True), ("sum", False), ("mean", False)])
def test_spmm_matches_jax_hybrid_and_xla(reduce, has_value):
    p, j, (_, _, v) = _pair(seed=11, has_value=has_value)
    x, ct = _dense(12, (N, 24), (N, 24))
    xt = torch.from_numpy(x).requires_grad_()
    if has_value:
        vt = torch.from_numpy(v).requires_grad_()
        p = p.set_values(vt)
    out = pt.spmm(p, xt, reduce)
    torch.sum(out * torch.from_numpy(ct)).backward()
    rows = _visited(p.storage.ell_plan().cells.cell_rb.numpy(), N)
    cols = _visited(p.storage.ell_plan().cells.cell_cw.numpy(), N)
    for alg in (jx.Algorithm.PALLAS_ROW_TILE, jx.Algorithm.XLA_SEGMENT):
        def loss(vals, dense):
            a = j.set_values(vals) if has_value else j
            return jnp.vdot(jx.spmm(a, dense, reduce, alg), jnp.asarray(ct))

        vals = jnp.asarray(v) if has_value else None
        ref = np.asarray(jx.spmm(j, jnp.asarray(x), reduce, alg))
        gv, gx = jax.grad(loss, argnums=(0, 1))(vals, jnp.asarray(x))
        if alg == jx.Algorithm.XLA_SEGMENT:
            rows = cols = np.ones(N, bool)
        _close_where_visited(out.detach().numpy(), ref, rows)
        _close_where_visited(xt.grad.numpy(), np.asarray(gx), cols,
                             GRAD_TOL)
        if has_value:
            np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv),
                                       **GRAD_TOL, err_msg=alg.name)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_spmm_bf16_matches_the_csr_route(reduce):
    # bf16 features run the hybrid tiers in the bf16 compute mode (the
    # cells rounded to bf16, `tests/test_torch_bf16_hybrid.py`) and every
    # tier sums in float32; held to the CSR route at 1e-2 of the terms'
    # absolute sum
    p, _, (_, _, v) = _pair(seed=32)
    (x,) = _dense(33, (N, 24))
    xb = torch.from_numpy(x).bfloat16()
    out = pt.spmm(p, xb, reduce)
    ref = pt.spmm(p, xb, reduce, pt.Algorithm.XLA_SEGMENT)
    abs_sum = pt.spmm(p.set_values(torch.from_numpy(np.abs(v))),
                      xb.float().abs(), reduce, pt.Algorithm.XLA_SEGMENT)
    assert out.dtype == torch.bfloat16
    assert_sum_close(out, ref, abs_sum, 1e-2)


def test_spmm_algorithms_route_and_agree():
    p, _, _ = _pair(seed=13)
    (x,) = _dense(14, (N, 16))
    calls = []
    real = spmm_cells.spmm_dense_cells_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    spmm_cells.spmm_dense_cells_plain = counted
    try:
        outs = {alg: pt.spmm(p, torch.from_numpy(x), "sum", alg).numpy()
                for alg in pt.Algorithm}
    finally:
        spmm_cells.spmm_dense_cells_plain = real
    assert len(calls) == 2          # AUTO and PALLAS_ROW_TILE
    for alg, out in outs.items():
        np.testing.assert_allclose(out, outs[pt.Algorithm.XLA_SEGMENT],
                                   **TOL, err_msg=alg.name)
    # MAX on a hybrid storage stays on the CSR max/min path
    mx = pt.spmm_max(p, torch.from_numpy(x)).numpy()
    ref = np.asarray(jx.spmm(_pair(seed=13)[1], jnp.asarray(x), "max",
                             jx.Algorithm.PALLAS_ROW_TILE))
    np.testing.assert_allclose(mx, ref, **TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_sddmm_matches_jax_sddmm_hybrid(reduce):
    p, j, (rowptr, _, _) = _pair(seed=15, has_value=False)
    d1, d2 = _dense(16, (N, 20), (N, 20))
    out = pt.sddmm(p, torch.from_numpy(d1), torch.from_numpy(d2), reduce)
    st = j.storage
    degrees = jnp.asarray(np.diff(rowptr))
    coo_row = jnp.asarray(np.repeat(np.arange(N), np.diff(rowptr)))
    ref = jx_sddmm_hybrid(st.ell_plan(), jnp.asarray(d1), jnp.asarray(d2),
                          jx.ReduceOp(reduce), degrees, coo_row)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    csr = pt.sddmm(p, torch.from_numpy(d1), torch.from_numpy(d2), reduce,
                   algorithm="pallas")
    np.testing.assert_allclose(out.numpy(), csr.numpy(), **TOL)


def test_set_values_rematerializes_the_cells():
    p, j, (_, _, v) = _pair(seed=17)
    (x,) = _dense(18, (N, 8))
    xt = torch.from_numpy(x)
    before = pt.spmm(p, xt).numpy()
    w = np.random.default_rng(19).uniform(0.5, 2.0, len(v)).astype(
        np.float32)
    q = p.set_values(torch.from_numpy(w))
    assert q.storage.ell_plan() is p.storage.ell_plan()
    assert q.storage.tier_values() is not p.storage.tier_values()
    cells = q.storage.tier_values()["cells"].numpy()
    np.testing.assert_allclose(
        cells, jx_planner.materialize_cells_np(j.storage.ell_plan().cells, w),
        rtol=1e-6, atol=1e-6)
    after = pt.spmm(q, xt).numpy()
    ref = np.asarray(jx.spmm(j.set_values(jnp.asarray(w)), jnp.asarray(x),
                             "sum", jx.Algorithm.XLA_SEGMENT))
    np.testing.assert_allclose(after, ref, **TOL)
    np.testing.assert_allclose(pt.spmm(p, xt).numpy(), before)
    # implicit ones, and the transpose, which has no plan
    ones = p.set_values(None)
    np.testing.assert_allclose(
        pt.spmm(ones, xt).numpy(),
        np.asarray(jx.spmm(j.set_values(None), jnp.asarray(x), "sum",
                           jx.Algorithm.XLA_SEGMENT)), **TOL)
    assert p.t().storage.ell_plan() is None
    np.testing.assert_allclose(pt.spmm(p.t(), xt).numpy(),
                               p.to_dense().T.numpy() @ x, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("change", ["mul_", "mul_ on the detached source",
                                    "sgd step"])
def test_hybrid_route_follows_in_place_value_changes(change):
    # the tier values cached for the values must follow an in-place change
    # of the values tensor: forward and d_dense equal the CSR route's
    # (XLA_SEGMENT) within assert_sum_close's 1e-5
    rowptr, col, vals = hybrid_csr(seed=23)
    src = torch.from_numpy(vals.copy())
    if change == "sgd step":
        src = torch.nn.Parameter(src)
    held = src.detach() if change == "mul_ on the detached source" else src
    p = pt.SparseTensor.from_csr(rowptr, col, held, sparse_sizes=(N, N))
    assert p.storage.ell_plan() is not None
    x0, ct = _dense(24, (N, 8), (N, 8))
    x = torch.from_numpy(x0).requires_grad_()
    cot = torch.from_numpy(ct)
    before = pt.spmm(p, x).detach()               # the tiers are cached
    if change == "sgd step":
        opt = torch.optim.SGD([src], lr=0.5)
        (pt.spmm(p, x) * cot).sum().backward()
        assert src.grad is not None and src.grad.abs().max() > 0
        opt.step()
    else:
        src.mul_(2)

    def route(algorithm):
        out = pt.spmm(p, x, algorithm=algorithm)
        (d_x,) = torch.autograd.grad((out * cot).sum(), x)
        return out.detach(), d_x

    abs_p = p.set_values(p.storage.values().detach().abs())
    abs_x = torch.from_numpy(np.abs(x0))
    abs_out = pt.spmm(abs_p, abs_x, algorithm=pt.Algorithm.XLA_SEGMENT)
    abs_dx = pt.spmm(abs_p.t(), cot.abs(), algorithm=pt.Algorithm.XLA_SEGMENT)
    hybrid, csr = route(pt.Algorithm.AUTO), route(pt.Algorithm.XLA_SEGMENT)
    assert_sum_close(hybrid[0], csr[0], abs_out, 1e-5)
    assert_sum_close(hybrid[1], csr[1], abs_dx, 1e-5)
    assert (before - hybrid[0]).abs().max() > 1e-2    # the values moved


# --- the GCN -----------------------------------------------------------------

def _gcn_graph():
    rowptr, col, _ = hybrid_csr(seed=20, sparse_block=None)
    return gcn_norm_csr(rowptr, col)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def make_hybrid_fixture() -> dict:
    """A 2-layer GCN (32 -> 16 -> 4) on a GCN-normalized clustered graph
    of 1500 nodes through the JAX hybrid route (PALLAS_ROW_TILE): graph,
    inputs, initial flax params, the eval forward, the losses of 2 Adam
    steps and the step-1 gradients."""
    rowptr, col, vals = _gcn_graph()
    adj = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                   jnp.asarray(vals), sparse_sizes=(N, N))
    hp = adj.storage.ell_plan()
    assert isinstance(hp, jx_planner.HybridPlan)
    assert hp.cells is not None and hp.bell is not None
    rng = np.random.default_rng(21)
    x = rng.standard_normal((N, 32)).astype(np.float32)
    y = rng.integers(0, 4, N).astype(np.int32)
    model = jx_gcn.GCN(16, 4, algorithm=jx.Algorithm.PALLAS_ROW_TILE)
    params = model.init(jax.random.key(3), jnp.asarray(x), adj)
    fx = {"rowptr": rowptr, "col": col, "vals": vals, "x": x, "y": y,
          "gcn/dims": np.asarray((32, 16, 4), np.int32),
          "gcn/out": np.asarray(model.apply(params, jnp.asarray(x), adj))}
    for k, v in _flatten(params["params"]).items():
        fx[f"gcn/params/{k}"] = v
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(x), adj)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for step in range(STEPS):
        loss, grads = grad_fn(params)
        if step == 0:
            for k, v in _flatten(grads["params"]).items():
                fx[f"gcn/grads/{k}"] = v
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    fx["gcn/losses"] = np.asarray(losses, np.float64)
    return fx


@pytest.fixture(scope="module")
def fresh():
    assert jax.default_backend() == "cpu", jax.default_backend()
    return make_hybrid_fixture()


def _port_run(fx):
    """The port's eval forward and its run of the fixture's 2 steps."""
    from dgsparse_tpu_torch.utils.testing import fixture_model

    model, adj, x, _ = fixture_model(fx, "gcn", "cpu")
    assert adj.storage.ell_plan() is not None
    with torch.inference_mode():
        out = model(x, adj).numpy()
    return (out, *run_train_fixture(fx, "gcn", "cpu", STEPS))


def test_gcn_on_the_hybrid_route_matches_jax(fresh):
    out, losses, grads = _port_run(fresh)
    np.testing.assert_allclose(out, fresh["gcn/out"], rtol=1e-4, atol=1e-4)
    prefix = "gcn/grads/"
    assert_train_close(losses, grads, fresh["gcn/losses"],
                       {k[len(prefix):]: v for k, v in fresh.items()
                        if k.startswith(prefix)})


def test_hybrid_fixture_is_current(fresh):
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for k, v in fresh.items():
            if "/losses" in k or "/grads/" in k or k == "gcn/out":
                np.testing.assert_allclose(
                    stored[k], v, rtol=1e-5,
                    atol=1e-6 * float(np.abs(v).max()), err_msg=k)
            else:
                np.testing.assert_array_equal(stored[k], v, err_msg=k)
                assert stored[k].dtype == v.dtype, k


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    from dgsparse_tpu.kernels import pallas_spmm

    pallas_spmm.set_interpret(True)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **make_hybrid_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
