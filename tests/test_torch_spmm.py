"""The port's SpMM (plain path on the CPU) against the JAX package.

The JAX side runs `Algorithm.PALLAS_EDGE_TILE`, which is the Pallas
`segment_matmul` inside `spmm_esc` (interpret mode on the CPU), and
`Algorithm.XLA_SEGMENT`. Tolerance 1e-5: both sides sum in float32 in
another order. Gradients (`d_dense` over the transpose, `d_values` by
SDDMM) at rtol 1e-4, against `jax.grad` of `jnp.vdot(out, ct)` with a
random cotangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.core.planner import build_edge_tile_plan
from dgsparse_tpu.kernels.pallas_spmm import segment_matmul
from dgsparse_tpu.utils.testing import random_csr, spmm_oracle
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.kernels import spmm_csr
from dgsparse_tpu_torch.utils.testing import assert_sum_close

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(m, n, seed, has_value):
    rowptr, col, values = random_csr(m, n, avg_degree=5.0, seed=seed)
    assert (np.diff(rowptr) == 0).any()           # empty rows present
    v = values if has_value else None
    p = pt.SparseTensor.from_csr(
        rowptr, col, None if v is None else torch.from_numpy(v),
        sparse_sizes=(m, n))
    j = jx.SparseTensor.from_csr(
        jnp.asarray(rowptr), jnp.asarray(col),
        None if v is None else jnp.asarray(v), sparse_sizes=(m, n))
    return p, j, (rowptr, col, v)


@pytest.mark.parametrize("feat,reduce,has_value", [
    (1, "sum", True), (7, "sum", True), (32, "sum", True),
    (129, "sum", True), (32, "mean", True), (7, "mean", False),
    (32, "sum", False), (129, "mean", False),
])
def test_spmm_matches_jax_edge_tile_and_xla(feat, reduce, has_value):
    p, j, (rowptr, col, v) = _pair(150, 110, seed=feat, has_value=has_value)
    x = np.random.default_rng(feat + 1).standard_normal(
        (110, feat)).astype(np.float32)
    out = pt.spmm(p, torch.from_numpy(x), reduce).numpy()
    for alg in (jx.Algorithm.PALLAS_EDGE_TILE, jx.Algorithm.XLA_SEGMENT):
        ref = np.asarray(jx.spmm(j, jnp.asarray(x), reduce, alg))
        np.testing.assert_allclose(out, ref, **TOL, err_msg=alg.name)
    np.testing.assert_allclose(out, spmm_oracle(rowptr, col, v, x, reduce),
                               **TOL)


def test_spmm_sum_mean_entry_points():
    p, j, _ = _pair(60, 60, seed=3, has_value=True)
    x = np.random.default_rng(4).standard_normal((60, 16)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(pt.spmm_sum(p, xt).numpy(),
                               np.asarray(jx.spmm_sum(j, xj)), **TOL)
    np.testing.assert_allclose(pt.spmm_mean(p, xt).numpy(),
                               np.asarray(jx.spmm_mean(j, xj)), **TOL)


def test_segment_sum_csr_plain_matches_segment_matmul():
    # contributions laid out by the TPU edge-tile plan, as in
    # tests/test_pallas_spmm.py, then mapped back to CSR edge order
    rng = np.random.default_rng(0)
    rowptr, col, _ = random_csr(200, 100, avg_degree=4.0, seed=1)
    plan = build_edge_tile_plan(rowptr, col, 100, edge_tile=128,
                                row_block=128)
    te = plan.num_tiles * plan.edge_tile
    contrib = rng.standard_normal((te, 128)).astype(np.float32)
    eperm = np.asarray(plan.eperm)
    contrib[eperm < 0] = 0
    ref = segment_matmul(jnp.asarray(contrib), plan.lrow, plan.tile_rb,
                         plan.num_tiles, plan.edge_tile, plan.row_block,
                         plan.num_rows)
    contrib_csr = np.zeros((len(col), 128), np.float32)
    contrib_csr[eperm[eperm >= 0]] = contrib[eperm >= 0]
    out = spmm_csr.segment_sum_csr(torch.from_numpy(rowptr),
                                   torch.from_numpy(contrib_csr))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_plain_versions_run_on_cpu_without_launching():
    spmm_csr.reset_launch_counts()
    p, _, (rowptr, col, v) = _pair(40, 30, seed=5, has_value=True)
    x = torch.randn(30, 8, generator=torch.Generator().manual_seed(0))
    pt.spmm_sum(p, x)
    spmm_csr.segment_sum_csr(torch.from_numpy(rowptr),
                             torch.ones(len(col), 8))
    assert spmm_csr.LAUNCHES == {"csr_spmm": 0, "csr_spmm_split": 0,
                                 "segment_sum_csr": 0}


def test_kernel_entries_refuse_cpu_tensors():
    rowptr, col, values = random_csr(20, 20, avg_degree=3.0, seed=6)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        spmm_csr.csr_spmm_cuda(t(rowptr), t(col), t(values),
                               torch.ones(20, 4))
    with pytest.raises(ValueError, match="CUDA"):
        spmm_csr.segment_sum_csr_cuda(t(rowptr), torch.ones(len(col), 4))
    assert spmm_csr.LAUNCHES == {"csr_spmm": 0, "csr_spmm_split": 0,
                                 "segment_sum_csr": 0}


@pytest.mark.parametrize("feat,reduce,has_value", [
    (1, "sum", True), (7, "mean", True), (16, "sum", False),
    (32, "mean", False), (33, "sum", True),
])
def test_spmm_grads_match_jax_edge_tile_and_xla(feat, reduce, has_value):
    p, j, (_, col, v) = _pair(120, 100, seed=feat + 50,
                              has_value=has_value)
    rng = np.random.default_rng(feat + 51)
    x = rng.standard_normal((100, feat)).astype(np.float32)
    ct = rng.standard_normal((120, feat)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    if has_value:
        vt = torch.from_numpy(v).requires_grad_()
        p = p.set_values(vt)
    torch.sum(pt.spmm(p, xt, reduce) * torch.from_numpy(ct)).backward()
    for alg in (jx.Algorithm.PALLAS_EDGE_TILE, jx.Algorithm.XLA_SEGMENT):
        def loss(vals, dense):
            a = j.set_values(vals) if has_value else j
            return jnp.vdot(jx.spmm(a, dense, reduce, alg), jnp.asarray(ct))

        vals = jnp.asarray(v) if has_value else None
        gv, gx = jax.grad(loss, argnums=(0, 1))(vals, jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   rtol=1e-4, atol=1e-5, err_msg=alg.name)
        if has_value:
            np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=alg.name)


def test_constant_values_get_no_gradient_and_no_sddmm():
    # a GCN's adjacency: values that do not require grad skip d_values
    from dgsparse_tpu_torch.kernels import sddmm_csr

    p, _, _ = _pair(40, 30, seed=12, has_value=True)
    x = torch.randn(30, 8, requires_grad=True,
                    generator=torch.Generator().manual_seed(1))
    calls = []
    real = sddmm_csr.sddmm_csr_plain
    sddmm_csr.sddmm_csr_plain = lambda *a, **k: calls.append(1) or real(
        *a, **k)
    try:
        pt.spmm_sum(p, x).sum().backward()
    finally:
        sddmm_csr.sddmm_csr_plain = real
    assert x.grad is not None and calls == []
    assert p.storage.values().grad is None


def test_set_values_keeps_structure_and_history():
    p, _, _ = _pair(30, 20, seed=13, has_value=False)
    w = torch.rand(p.nnz, requires_grad=True)
    q = p.set_values(w * 2)
    assert q.has_value and q.storage.rowptr() is p.storage.rowptr()
    assert q.storage.values().grad_fn is not None
    with pytest.raises(ValueError):
        p.set_values(torch.ones(p.nnz + 1))


def test_backward_raises():
    # the MAX/MIN backward's kernel entries refuse CPU tensors rather than
    # run anything else, and a SUM/MEAN SpMM takes no other compute than MUL
    from dgsparse_tpu_torch.kernels import spmm_maxmin
    from dgsparse_tpu_torch.ops.spmm import aggregate
    from dgsparse_tpu_torch.ops.types import ComputeOp, ReduceOp

    p, _, (rowptr, col, _) = _pair(20, 10, seed=14, has_value=False)
    st = p.storage
    g = torch.ones(20, 4)
    arg = torch.zeros(20, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        spmm_maxmin.spmm_maxmin_d_dense_cuda(st.colptr(), st.row(),
                                             st.csr2csc(), None, arg, g,
                                             st.rowptr(), st.csc_slot())
    with pytest.raises(ValueError, match="CUDA"):
        spmm_maxmin.spmm_maxmin_d_values_cuda(st.rowptr(), st.col(), arg, g,
                                              None)
    for reduce in (ReduceOp.SUM, ReduceOp.MEAN):
        with pytest.raises(ValueError, match="multiplies"):
            aggregate(None, torch.ones(10, 1, 4), st, reduce, ComputeOp.ADD)


def test_spmm_shape_and_reduce_checks():
    p, _, _ = _pair(30, 20, seed=8, has_value=True)
    with pytest.raises(ValueError):
        pt.spmm_sum(p, torch.ones(21, 4))
    with pytest.raises(ValueError):
        pt.spmm_sum(p, torch.ones(20))
    with pytest.raises(ValueError):
        pt.spmm(p, torch.ones(20, 4), "prod")
    with pytest.raises(ValueError):
        pt.spmm_max(p, torch.ones(21, 4))


def test_empty_graph_gives_zeros():
    p = pt.SparseTensor.from_csr(np.zeros(6, np.int32),
                                 np.zeros(0, np.int32), sparse_sizes=(5, 3))
    out = pt.spmm_mean(p, torch.ones(3, 4))
    assert out.shape == (5, 4) and not out.any()


def test_assert_sum_close_scales_with_the_terms():
    ref = torch.tensor([[0.01, 5.0]])
    abs_sum = torch.tensor([[300.0, 5.0]])
    # cancelling sum: an order change of 1e-3 is within 1e-5 * abs_sum
    assert assert_sum_close(ref + torch.tensor([[1e-3, 0.0]]), ref, abs_sum,
                            1e-5) == pytest.approx(1e-3, rel=1e-3)
    with pytest.raises(AssertionError, match="1 of 2"):
        assert_sum_close(ref + torch.tensor([[0.0, 1e-3]]), ref, abs_sum,
                         1e-5)


@pytest.mark.parametrize("compute", ["add", "sub", "mul", "div"])
def test_combine_matches_jax(compute):
    from dgsparse_tpu.kernels import xla as jx_kernels
    from dgsparse_tpu.ops.types import ComputeOp as JxComputeOp
    from dgsparse_tpu_torch.kernels import reference
    from dgsparse_tpu_torch.ops.types import ComputeOp

    rng = np.random.default_rng(11)
    e = rng.uniform(0.5, 2.0, 20).astype(np.float32)
    f = rng.standard_normal((20, 5)).astype(np.float32)
    out = reference.combine(ComputeOp(compute), torch.from_numpy(e),
                            torch.from_numpy(f))
    ref = jx_kernels.combine(JxComputeOp(compute), jnp.asarray(e),
                             jnp.asarray(f))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_cuda_time_refuses_cpu_tensors():
    from dgsparse_tpu_torch.utils.bench import cuda_time, spmm_gflops

    with pytest.raises(ValueError, match="CUDA"):
        cuda_time(torch.add, torch.ones(2), torch.ones(2))
    assert spmm_gflops(1000, 32, 1e-6) == pytest.approx(64.0)
