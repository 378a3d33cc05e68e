"""The port's semiring SpMM on a hybrid-planned storage against the JAX
package's `gspmm` and against the port's own CSR route.

On a storage with a `HybridPlan`, SUM/MEAN `gspmm` runs its weighted SpMM
on the hybrid tiers (`ops/gspmm.py`, as `dgsparse_tpu/ops/gspmm.py:324-328`
routes to `_hybrid_sum_mean`): MUL and copy_u on the storage's cached
tiers, ADD/SUB on the ones' cached tiers plus or minus the values' row
sum, DIV on tiers gathered for 1/values on every call. Here the tiers'
kernels run their plain versions. The JAX side runs the same function
through XLA (AUTO off the TPU); the CSR route is the port's `gspmm` on
the same graph built with `build_plans=False`.

Graph: `utils/testing.py::hybrid_csr()` (1,500 rows, dense cells, BELL
and residue edges, a row block without a cell) with values of |v| in
[0.5, 2], away from 0, since DIV and its gradient divide by them.
Gradients are those of `sum(out * ct)` for a random cotangent.

A bf16 dense runs the bf16 compute mode of the tiers. JAX takes that
mode only on its hybrid kernels, which AUTO picks on the TPU alone (off
it, XLA sums in bf16); so the bf16 case resolves JAX's AUTO as on the TPU
(`_resolve_algorithm`, monkeypatched for the test), and its Pallas
kernels run in interpret mode, as `tests/conftest.py` sets them. JAX's
`spmm_dense_cells` leaves output blocks without a cell unwritten (NaN in
interpret mode), so that comparison keeps to the rows (the columns for
d_dense) of blocks with a cell, as `tests/test_torch_bf16_hybrid.py`
does.

Tolerances, scaled by the terms' absolute sum (`assert_sum_close`): 1e-5
for float32 (the tiers sum each row's terms in another order), 1e-2 for
a bf16 dense (as `tests/test_torch_bf16_hybrid.py` holds `spmm`). The
route is asserted through `utils.metrics`: the `"spmm"` record of the
hybrid tiers, with `cached_values` False for DIV alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.core.planner import HybridPlan
from dgsparse_tpu.ops import gspmm as jx_gspmm
from dgsparse_tpu.ops import spmm as jx_spmm
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.core import planner
from dgsparse_tpu_torch.ops import gspmm as pt_gspmm
from dgsparse_tpu_torch.utils import metrics
from dgsparse_tpu_torch.utils.testing import assert_sum_close, hybrid_csr
from tests.test_torch_hybrid import _visited

N = 1500                    # hybrid_csr's default size
TOL = 1e-5
BF16_TOL = 1e-2
COMPUTES = ("mul", "div", "add", "sub", "copy_u")
REDUCES = ("sum", "mean")
FEATS = (8, 5)


@pytest.fixture(scope="module")
def graph():
    """(rowptr, col, vals, port hybrid storage, port CSR-only storage, JAX
    hybrid storage), all with the same values."""
    rowptr, col, _ = hybrid_csr(seed=16)
    rng = np.random.default_rng(16)
    vals = (rng.uniform(0.5, 2.0, len(col))
            * rng.choice([-1.0, 1.0], len(col))).astype(np.float32)
    p = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                                 sparse_sizes=(N, N))
    q = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                                 sparse_sizes=(N, N), build_plans=False)
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 jnp.asarray(vals), sparse_sizes=(N, N))
    assert p.storage.ell_plan() is not None
    assert q.storage.ell_plan() is None
    assert isinstance(j.storage.ell_plan(), HybridPlan)
    hp = p.storage.ell_plan()
    assert hp.cells is not None and hp.bell is not None and hp.res.nnz
    return rowptr, col, vals, p, q, j


def _inputs(seed, feat):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, feat)).astype(np.float32)
    ct = rng.standard_normal((N, feat)).astype(np.float32)
    return x, ct


def _op_name(reduce, compute):
    if compute == "copy_u":
        return f"copy_u_{reduce}"
    return f"u_{compute}_e_{reduce}"


def _run(sp, vals, x, ct, name, dtype=torch.float32):
    """out, d_dense, d_values (None for copy_u) of the port's op `name`
    on sp with values vals, and the metrics it recorded."""
    vt = torch.from_numpy(vals).requires_grad_()
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    metrics.reset()
    metrics.enable()
    try:
        out = getattr(pt_gspmm, name)(sp.set_values(vt), xt)
    finally:
        metrics.disable()
    records = metrics.counters()
    metrics.reset()
    (out.float() * torch.from_numpy(ct)).sum().backward()
    return out.detach(), xt.grad, vt.grad, records


def _spmm_records(records):
    return [dict(k[1:]) for k in records if k[0] == "spmm"]


def _abs_sums(q, vals, x, ct, reduce, compute):
    """Each result's terms' absolute sum: the forward, d_dense and d_values
    of the CSR route on |values|, |x| and |ct|, SUB taken as ADD."""
    c = "add" if compute == "sub" else compute
    name = _op_name(reduce, c)
    out, dx, dv, _ = _run(q, np.abs(vals), np.abs(x), np.abs(ct), name)
    return out, dx.abs(), None if dv is None else dv.abs()


def _jax(j, x, ct, name, dtype=jnp.float32):
    """JAX's out, d_dense and d_values of op `name` on its hybrid
    storage."""
    def loss(v, d):
        out = getattr(jx_gspmm, name)(j.set_values(v), d)
        return jnp.vdot(out.astype(jnp.float32), jnp.asarray(ct)), out

    grad = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    if dtype == jnp.bfloat16:
        grad = jax.jit(grad)        # eager interpret mode is far slower
    (_, out), (dv, dx) = grad(j.storage.values(),
                              jnp.asarray(x).astype(dtype))
    return (np.array(out.astype(jnp.float32)),
            np.array(dx.astype(jnp.float32)), np.array(dv))


@pytest.fixture
def jax_tpu_routes(monkeypatch):
    """JAX's AUTO resolved as on the TPU for a hybrid plan: its hybrid
    kernels (PALLAS_ROW_TILE), which hold its bf16 compute mode."""
    from dgsparse_tpu.ops.types import Algorithm, ReduceOp

    resolve = jx_spmm._resolve_algorithm

    def on_tpu(algorithm, plan, bell, nnz, reduce, ell=None):
        if algorithm == Algorithm.AUTO and isinstance(ell, HybridPlan) \
                and reduce in (ReduceOp.SUM, ReduceOp.MEAN):
            return Algorithm.PALLAS_ROW_TILE
        return resolve(algorithm, plan, bell, nnz, reduce, ell)

    monkeypatch.setattr(jx_spmm, "_resolve_algorithm", on_tpu)


@pytest.mark.parametrize("feat", FEATS)
@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("compute", COMPUTES)
def test_hybrid_route_matches_jax_and_csr(graph, compute, reduce, feat):
    _, _, vals, p, q, j = graph
    name = _op_name(reduce, compute)
    x, ct = _inputs(COMPUTES.index(compute) * 10 + feat, feat)
    out, dx, dv, records = _run(p, vals, x, ct, name)
    # the route: the hybrid tiers, on cached tiers except for DIV
    assert _spmm_records(records) == [{
        "alg": "PALLAS_ROW_TILE", "reduce": reduce, "nnz": p.nnz,
        "feat": feat, "cached_values": compute != "div"}]
    c_out, c_dx, c_dv, c_records = _run(q, vals, x, ct, name)
    assert not _spmm_records(c_records)
    a_out, a_dx, a_dv = _abs_sums(q, vals, x, ct, reduce, compute)
    j_out, j_dx, j_dv = _jax(j, x, ct, name)
    for got, csr, ref, abs_sum, what in (
            (out, c_out, j_out, a_out, "out"),
            (dx, c_dx, j_dx, a_dx, "d_dense"),
            (dv, c_dv, j_dv, a_dv, "d_values")):
        if what == "d_values" and compute == "copy_u":
            assert got is None and csr is None
            continue
        assert torch.isfinite(got).all(), what
        assert_sum_close(got, torch.from_numpy(ref), abs_sum, TOL)
        assert_sum_close(got, csr, abs_sum, TOL)


@pytest.mark.parametrize("reduce", REDUCES)
def test_mul_is_spmm_bitwise(graph, reduce):
    _, _, vals, p, _, _ = graph
    x, ct = _inputs(60, 8)
    ct_t = torch.from_numpy(ct)
    got, want = [], []
    for fn, into in ((lambda s, d: pt.gspmm(s, d, reduce, "mul"), got),
                     (lambda s, d: pt.spmm(s, d, reduce), want)):
        vt = torch.from_numpy(vals).requires_grad_()
        xt = torch.from_numpy(x).requires_grad_()
        out = fn(p.set_values(vt), xt)
        (out * ct_t).sum().backward()
        into.extend([out.detach(), xt.grad, vt.grad])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_max_min_keep_the_csr_route(graph, reduce):
    _, _, vals, p, q, _ = graph
    x, _ = _inputs(61, 5)
    xt = torch.from_numpy(x)
    metrics.reset()
    metrics.enable()
    try:
        out = pt.gspmm(p, xt, reduce, "div")
    finally:
        metrics.disable()
    assert not _spmm_records(metrics.counters())
    metrics.reset()
    assert torch.equal(out, pt.gspmm(q, xt, reduce, "div"))


def test_values_changed_in_place_and_set_values_reach_the_route(graph):
    _, _, vals, p, q, _ = graph
    x, _ = _inputs(62, 8)
    xt = torch.from_numpy(x)
    v = torch.from_numpy(vals.copy())
    sp = p.set_values(v)
    abs_sum = pt.gspmm(q.set_values(2 * v.abs()), xt.abs())
    for compute in ("mul", "div", "add"):
        pt.gspmm(sp, xt, "sum", compute)        # tiers cached for v
    v.mul_(2)
    for compute in ("mul", "div", "add"):
        assert_sum_close(pt.gspmm(sp, xt, "sum", compute),
                         pt.gspmm(q.set_values(v), xt, "sum", compute),
                         abs_sum, TOL)
    w = torch.from_numpy(-vals)
    assert_sum_close(pt.gspmm(sp.set_values(w), xt),
                     pt.gspmm(q.set_values(w), xt), abs_sum, TOL)


@pytest.mark.parametrize("compute", ["mul", "add", "div"])
def test_bf16_dense_matches_jax(graph, jax_tpu_routes, compute):
    _, _, vals, p, q, j = graph
    name = _op_name("sum", compute)
    x, ct = _inputs(63, 8)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    out, dx, dv, records = _run(p, vals, xb, ct, name, torch.bfloat16)
    assert out.dtype == dx.dtype == torch.bfloat16
    assert _spmm_records(records)[0]["alg"] == "PALLAS_ROW_TILE"
    if compute == "mul":            # spmm's bf16 compute mode, bitwise
        assert torch.equal(out, pt.spmm(p, torch.from_numpy(xb).to(
            torch.bfloat16)))
    j_out, j_dx, j_dv = _jax(j, xb, ct, name, jnp.bfloat16)
    a_out, a_dx, a_dv = _abs_sums(q, vals, xb, ct, "sum", compute)
    cells = p.storage.ell_plan().cells
    rows = torch.from_numpy(_visited(cells.cell_rb.numpy(), N))
    cols = torch.from_numpy(_visited(cells.cell_cw.numpy(), N))
    assert not rows.all() and not np.isfinite(j_out[~rows.numpy()]).all()
    assert torch.isfinite(out).all() and torch.isfinite(dx).all()
    assert_sum_close(out[rows], torch.from_numpy(j_out)[rows], a_out[rows],
                     BF16_TOL)
    assert_sum_close(dx[cols], torch.from_numpy(j_dx)[cols], a_dx[cols],
                     BF16_TOL)
    assert_sum_close(dv, torch.from_numpy(j_dv), a_dv, BF16_TOL)


def test_reciprocal_tiers_of_bf16_values_that_require_grad(graph):
    _, _, vals, p, q, _ = graph
    hp = p.storage.ell_plan()
    v = torch.from_numpy(vals).to(torch.bfloat16).requires_grad_()
    tiers = planner.tier_values(hp, 1.0 / v, p.device)
    want = planner.tier_values(hp, (1.0 / v.detach()).float(), p.device)
    # the gathers' edge ids are uploaded once per plan and device
    assert planner._tier_ids(hp, p.device) is planner._tier_ids(hp, p.device)
    host = planner.tier_values(hp, (1.0 / v.detach()).float().numpy(),
                               p.device)
    for k in ("cells", "bell", "res", "nd_t"):
        assert not tiers[k].requires_grad
        assert torch.equal(tiers[k], want[k]), k
        if k == "cells":        # fp32 segment sums vs the host's fp64
            torch.testing.assert_close(tiers[k], host[k])
        else:
            assert torch.equal(tiers[k], host[k]), k
    x, _ = _inputs(64, 5)
    xt = torch.from_numpy(x)
    out = pt.gspmm(p.set_values(v), xt, "mean", "div")
    ref = pt.gspmm(q.set_values(v), xt, "mean", "div")
    abs_sum = pt.gspmm(q.set_values(v.detach().abs()), xt.abs(), "mean",
                       "div")
    assert_sum_close(out, ref, abs_sum, TOL)


@pytest.mark.parametrize("build_plans", [True, False])
def test_copy_u_ignores_compute(graph, build_plans):
    rowptr, col, _, _, _, _ = graph
    sp = pt.SparseTensor.from_csr(rowptr, col, None, sparse_sizes=(N, N),
                                  build_plans=build_plans)
    x, _ = _inputs(65, 5)
    xt = torch.from_numpy(x)
    want = pt_gspmm.copy_u_mean(sp, xt)
    for compute in ("add", "sub", "div"):
        assert torch.equal(pt.gspmm(sp, xt, "mean", compute), want)


def test_copy_u_keeps_the_ones_tiers_on_the_callers_storage(graph):
    rowptr, col, vals, _, _, _ = graph
    sp = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                                  sparse_sizes=(N, N))
    assert sp.storage._tier_ones is None       # built with values
    x, _ = _inputs(66, 5)
    xt = torch.from_numpy(x)
    out = pt_gspmm.copy_u_sum(sp, xt)
    tiers = sp.storage.tier_values(ones=True)
    assert torch.equal(pt_gspmm.copy_u_sum(sp, xt), out)
    assert sp.storage.tier_values(ones=True) is tiers
    pt_gspmm.copy_u_max(sp, xt)
