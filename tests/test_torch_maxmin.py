"""The port's MAX/MIN SpMM (plain path on the CPU) against the JAX package.

The JAX side runs `Algorithm.PALLAS_EDGE_TILE`, which is the Pallas
`spmm_maxmin_esc` (interpret mode on the CPU), and `Algorithm.XLA_SEGMENT`.
The winning edges (`arg`) are compared exactly: with `XLA_SEGMENT`'s edge
ids (`kernels/xla.py::spmm_forward`), and with the Pallas kernel's plan
slots mapped to edge ids through `plan.eperm` (the sentinel slot
`padded_edges` to nnz). Values at 1e-5: the extremum is one product,
rounded alike on both sides. Gradients at 1e-5 scaled by the sum of the
terms' absolute values (`assert_sum_close`): a column's gradient sums the
winners' terms in another order on each side. Inputs drawn from a
continuous distribution have no ties; ties are tested on integer-valued
features, against the edge-id path only (ROADMAP.md queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.kernels import xla as jx_xla
from dgsparse_tpu.kernels.pallas_spmm_maxmin import spmm_maxmin_esc
from dgsparse_tpu.ops.types import ReduceOp as JxReduceOp
from dgsparse_tpu.utils.testing import random_csr
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.kernels import reference
from dgsparse_tpu_torch.kernels import spmm_maxmin as K
from dgsparse_tpu_torch.ops.types import ComputeOp, ReduceOp
from dgsparse_tpu_torch.utils.testing import assert_sum_close

TOL = dict(rtol=1e-5, atol=1e-5)
ALGS = (jx.Algorithm.PALLAS_EDGE_TILE, jx.Algorithm.XLA_SEGMENT)


def _pair(m, n, seed, has_value, avg_degree=5.0):
    rowptr, col, values = random_csr(m, n, avg_degree=avg_degree, seed=seed)
    assert (np.diff(rowptr) == 0).any()           # empty rows present
    v = values if has_value else None
    p = pt.SparseTensor.from_csr(
        rowptr, col, None if v is None else torch.from_numpy(v),
        sparse_sizes=(m, n))
    j = jx.SparseTensor.from_csr(
        jnp.asarray(rowptr), jnp.asarray(col),
        None if v is None else jnp.asarray(v), sparse_sizes=(m, n))
    return p, j, (rowptr, col, v)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _earliest_winner(rowptr, col, v, x, reduce):
    """numpy oracle: per element the first edge of strictly better value,
    nnz for an empty row."""
    m, f = len(rowptr) - 1, x.shape[1]
    arg = np.full((m, f), len(col), np.int32)
    for r in range(m):
        for k in range(f):
            best = None
            for e in range(rowptr[r], rowptr[r + 1]):
                val = x[col[e], k] * (1.0 if v is None else v[e])
                if best is None or (val > best if reduce == "max"
                                    else val < best):
                    best, arg[r, k] = val, e
    return arg


def _jax_args(j, rowptr, col, v, x, reduce):
    """The JAX package's winning edges: XLA's edge ids and the Pallas
    kernel's plan slots mapped to edge ids."""
    nnz, m = len(col), len(rowptr) - 1
    coo_row = np.repeat(np.arange(m, dtype=np.int32), np.diff(rowptr))
    vj = None if v is None else jnp.asarray(v)
    _, xla_arg = jx_xla.spmm_forward(jnp.asarray(coo_row), jnp.asarray(col),
                                     vj, jnp.asarray(x), m,
                                     JxReduceOp(reduce))
    plan = j.storage.plan()
    _, slot = spmm_maxmin_esc(plan, vj, jnp.asarray(x), JxReduceOp(reduce))
    slot, eperm = np.asarray(slot), np.asarray(plan.eperm)
    pallas_arg = np.where(slot == plan.padded_edges, nnz,
                          eperm[np.minimum(slot, len(eperm) - 1)])
    return np.asarray(xla_arg), pallas_arg


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("feat,has_value", [
    (7, False), (32, True), (129, False)])
def test_forward_and_arg_match_jax(reduce, feat, has_value):
    p, j, (rowptr, col, v) = _pair(150, 110, seed=feat, has_value=has_value)
    x = np.random.default_rng(feat + 1).standard_normal(
        (110, feat)).astype(np.float32)
    out = pt.spmm(p, torch.from_numpy(x), reduce).numpy()
    for alg in ALGS:
        ref = np.asarray(jx.spmm(j, jnp.asarray(x), reduce, alg))
        np.testing.assert_allclose(out, ref, **TOL, err_msg=alg.name)
    rp, cl, vt, xt = _t(rowptr, col, v, x)
    out2, arg = K.spmm_maxmin(rp, cl, vt, xt, reduce)
    np.testing.assert_array_equal(out2.numpy(), out)
    xla_arg, pallas_arg = _jax_args(j, rowptr, col, v, x, reduce)
    np.testing.assert_array_equal(arg.numpy(), pallas_arg)
    empty = np.diff(rowptr) == 0
    assert (arg.numpy()[empty] == len(col)).all() and not out[empty].any()
    # XLA's unchunked segment_min leaves int32 max, not nnz, in the empty
    # rows (ROADMAP.md queue C); the winners of the other rows agree
    np.testing.assert_array_equal(arg.numpy()[~empty], xla_arg[~empty])
    assert (xla_arg[empty] == np.iinfo(np.int32).max).all()


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("has_value", [True, False])
def test_ties_keep_the_earliest_edge(reduce, has_value):
    # integer features in {-2..2} and values in {1, 2}: most elements tie
    rowptr, col, _ = random_csr(80, 60, avg_degree=6.0, seed=3)
    rng = np.random.default_rng(4)
    x = rng.integers(-2, 3, (60, 9)).astype(np.float32)
    v = (rng.integers(1, 3, len(col)).astype(np.float32) if has_value
         else None)
    rp, cl, vt, xt = _t(rowptr, col, v, x)
    _, arg = K.spmm_maxmin(rp, cl, vt, xt, reduce)
    oracle = _earliest_winner(rowptr, col, v, x, reduce)
    np.testing.assert_array_equal(arg.numpy(), oracle)
    coo_row = np.repeat(np.arange(80, dtype=np.int32), np.diff(rowptr))
    _, xla_arg = jx_xla.spmm_forward(
        jnp.asarray(coo_row), jnp.asarray(col),
        None if v is None else jnp.asarray(v), jnp.asarray(x), 80,
        JxReduceOp(reduce))
    full = np.diff(rowptr) > 0
    np.testing.assert_array_equal(arg.numpy()[full],
                                  np.asarray(xla_arg)[full])


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_chunked_merge_keeps_the_smaller_edge_on_ties(reduce, monkeypatch):
    # chunks of 13 edges split rows, so ties are merged across chunks
    rowptr, col, _ = random_csr(70, 50, avg_degree=8.0, seed=5)
    x = np.random.default_rng(6).integers(0, 2, (50, 4)).astype(np.float32)
    rp, cl, xt = _t(rowptr, col, x)
    whole = K.spmm_maxmin(rp, cl, None, xt, reduce)
    monkeypatch.setattr(reference, "_SPMM_CHUNK_BUDGET", 13 * 4 * 4)
    assert reference.spmm_chunk_edges(4) == 13
    chunked = K.spmm_maxmin(rp, cl, None, xt, reduce)
    monkeypatch.setattr(jx_xla, "_SPMM_CHUNK_BUDGET", 13 * 4 * 4)
    coo_row = np.repeat(np.arange(70, dtype=np.int32), np.diff(rowptr))
    jout, jarg = jx_xla.spmm_forward(jnp.asarray(coo_row), jnp.asarray(col),
                                     None, jnp.asarray(x), 70,
                                     JxReduceOp(reduce))
    for out, arg in (whole, chunked):
        np.testing.assert_array_equal(arg.numpy(), np.asarray(jarg))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(
        whole[1].numpy(), _earliest_winner(rowptr, col, None, x, reduce))


def _jax_grads(j, has_value, v, x, ct, reduce, alg):
    def loss(vals, dense):
        a = j.set_values(vals) if has_value else j
        return jnp.vdot(jx.spmm(a, dense, reduce, alg), jnp.asarray(ct))

    vals = jnp.asarray(v) if has_value else None
    gv, gx = jax.grad(loss, argnums=(0, 1))(vals, jnp.asarray(x))
    return (None if gv is None else np.asarray(gv)), np.asarray(gx)


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("feat,has_value", [(16, False), (33, True)])
def test_grads_match_jax(reduce, feat, has_value):
    p, j, (rowptr, col, v) = _pair(120, 100, seed=feat + 50,
                                   has_value=has_value)
    rng = np.random.default_rng(feat + 51)
    x = rng.standard_normal((100, feat)).astype(np.float32)
    ct = rng.standard_normal((120, feat)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    if has_value:
        vt = torch.from_numpy(v).requires_grad_()
        p = p.set_values(vt)
    torch.sum(pt.spmm(p, xt, reduce) * torch.from_numpy(ct)).backward()
    # the terms' absolute sums: the same backward of |ct|, |v|
    st = p.storage
    _, arg = K.spmm_maxmin(st.rowptr(), st.col(),
                           None if v is None else torch.from_numpy(v),
                           torch.from_numpy(x), reduce)
    w = None if v is None else torch.from_numpy(np.abs(v))[
        st.csr2csc().long()]
    abs_dx = K.spmm_maxmin_d_dense(st.colptr(), st.row(), st.csr2csc(), w,
                                   arg, torch.from_numpy(np.abs(ct)),
                                   st.rowptr(), st.csc_slot())
    for alg in ALGS:
        gv, gx = _jax_grads(j, has_value, v, x, ct, reduce, alg)
        assert_sum_close(xt.grad, torch.from_numpy(gx), abs_dx, 1e-5)
        if has_value:
            abs_dv = K.spmm_maxmin_d_values(
                st.rowptr(), st.col(), arg, torch.from_numpy(np.abs(ct)),
                torch.from_numpy(np.abs(x)))[:, 0]
            assert_sum_close(vt.grad, torch.from_numpy(gv), abs_dv, 1e-5)


def test_grads_follow_the_earliest_winner_on_ties():
    # row 1's two edges (columns 0 and 2) tie on every feature: all the
    # gradient goes to the first, column 0, as in the JAX package's
    # edge-id path; row 0's two edges both point at column 1
    rowptr = np.array([0, 2, 4, 4], np.int32)
    col = np.array([1, 1, 0, 2], np.int32)
    x = np.array([[0.0, 1.0], [3.0, 3.0], [0.0, 1.0]], np.float32)
    p = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(3, 3))
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 sparse_sizes=(3, 3))
    ct = np.arange(1.0, 7.0, dtype=np.float32).reshape(3, 2)
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(pt.spmm_max(p, xt) * torch.from_numpy(ct)).backward()
    _, gx = _jax_grads(j, False, None, x, ct, "max",
                       jx.Algorithm.XLA_SEGMENT)
    np.testing.assert_array_equal(xt.grad.numpy(), gx)
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  [[3, 4], [1, 2], [0, 0]])


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("has_value", [True, False])
def test_multihead_matches_jax(reduce, has_value):
    m, n, h, f = 90, 70, 4, 5
    rowptr, col, _ = random_csr(m, n, avg_degree=5.0, seed=11)
    rng = np.random.default_rng(12)
    v = (rng.standard_normal((len(col), h)).astype(np.float32)
         if has_value else None)
    x = rng.standard_normal((n, h, f)).astype(np.float32)
    ct = rng.standard_normal((m, h, f)).astype(np.float32)
    p = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(m, n))
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 sparse_sizes=(m, n))
    xt = torch.from_numpy(x).requires_grad_()
    vt = None if v is None else torch.from_numpy(v).requires_grad_()
    out = pt.spmm_multihead(p, vt, xt, reduce)
    torch.sum(out * torch.from_numpy(ct)).backward()

    def loss(vals, dense):
        return jnp.vdot(jx.spmm_multihead(j, vals, dense, reduce),
                        jnp.asarray(ct))

    vj = None if v is None else jnp.asarray(v)
    ref = np.asarray(jx.spmm_multihead(j, vj, jnp.asarray(x), reduce))
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    gv, gx = jax.grad(loss, argnums=(0, 1))(vj, jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    if has_value:
        np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv), **TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("has_value", [True, False])
def test_spmm_coo_matches_jax(reduce, has_value):
    # shuffled edges with duplicates: on exact ties (duplicates, values
    # None) the earliest edge of the caller's list wins
    rowptr, col, vals = random_csr(60, 40, avg_degree=4.0, seed=13)
    rng = np.random.default_rng(14)
    row = np.repeat(np.arange(60, dtype=np.int32), np.diff(rowptr))
    dup = rng.choice(len(col), 30, replace=False)
    row, col = np.concatenate([row, row[dup]]), np.concatenate([col,
                                                                col[dup]])
    order = rng.permutation(len(col))
    row, col = row[order], col[order]
    v = (rng.standard_normal(len(col)).astype(np.float32) if has_value
         else None)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    ct = rng.standard_normal((60, 6)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    vt = None if v is None else torch.from_numpy(v).requires_grad_()
    out = pt.spmm_coo(torch.from_numpy(row), torch.from_numpy(col), vt, xt,
                      60, reduce)
    torch.sum(out * torch.from_numpy(ct)).backward()

    def loss(vals, dense):
        return jnp.vdot(jx.spmm_coo(jnp.asarray(row), jnp.asarray(col), vals,
                                    dense, 60, reduce), jnp.asarray(ct))

    vj = None if v is None else jnp.asarray(v)
    ref = jx.spmm_coo(jnp.asarray(row), jnp.asarray(col), vj,
                      jnp.asarray(x), 60, reduce)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    gv, gx = jax.grad(loss, argnums=(0, 1))(vj, jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    if has_value:
        np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv), **TOL)


def test_sorted_segment_sum_matches_jax():
    from dgsparse_tpu.ops.segment import sorted_segment_sum as jx_sss

    rng = np.random.default_rng(15)
    ids = np.sort(rng.integers(0, 30, 200)).astype(np.int32)
    data = rng.standard_normal((200, 5)).astype(np.float32)
    dt = torch.from_numpy(data).requires_grad_()
    out = pt.sorted_segment_sum(dt, torch.from_numpy(ids), 33)
    ref = jx_sss(jnp.asarray(data), jnp.asarray(ids), 33)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    ct = rng.standard_normal((33, 5)).astype(np.float32)
    torch.sum(out * torch.from_numpy(ct)).backward()
    np.testing.assert_array_equal(dt.grad.numpy(), ct[ids])
    with pytest.raises(ValueError, match="sorted"):
        pt.sorted_segment_sum(dt, torch.from_numpy(ids[::-1].copy()), 33)


def test_plain_versions_run_on_cpu_without_launching():
    K.reset_launch_counts()
    p, _, (rowptr, col, _) = _pair(40, 30, seed=5, has_value=True)
    x = torch.randn(30, 8, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    pt.spmm_max(p, x).sum().backward()
    assert K.LAUNCHES == {"spmm_maxmin": 0, "spmm_maxmin_d_dense": 0,
                          "spmm_maxmin_d_values": 0}


def test_kernel_entries_refuse_cpu_tensors():
    rowptr, col, values = random_csr(20, 20, avg_degree=3.0, seed=6)
    rp, cl, v = _t(rowptr, col, values)
    x = torch.ones(20, 4)
    arg = torch.zeros(20, 4, dtype=torch.int32)
    st = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(20, 20)).storage
    with pytest.raises(ValueError, match="CUDA"):
        K.spmm_maxmin_cuda(rp, cl, v, x)
    with pytest.raises(ValueError, match="CUDA"):
        K.spmm_maxmin_d_dense_cuda(st.colptr(), st.row(), st.csr2csc(),
                                   None, arg, x, st.rowptr(), st.csc_slot())
    with pytest.raises(ValueError, match="CUDA"):
        K.spmm_maxmin_d_values_cuda(rp, cl, arg, x, x)
    with pytest.raises(ValueError, match="MAX or MIN"):
        K.spmm_maxmin(rp, cl, v, x, "sum")


@pytest.mark.parametrize("compute", list(ComputeOp))
def test_plain_backward_pieces_match_a_dense_oracle(compute):
    # d_dense and d_values of one MAX/MIN SpMM, each against numpy loops
    rowptr, col, vals = random_csr(30, 25, avg_degree=4.0, seed=16)
    rng = np.random.default_rng(17)
    v = rng.uniform(0.5, 2.0, len(col)).astype(np.float32)
    x = rng.standard_normal((25, 3)).astype(np.float32)
    g = rng.standard_normal((30, 3)).astype(np.float32)
    rp, cl, vt, xt, gt = _t(rowptr, col, v, x, g)
    _, arg = K.spmm_maxmin(rp, cl, vt, xt, ReduceOp.MAX, compute)
    st = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(30, 25)).storage
    w = {ComputeOp.MUL: v, ComputeOp.DIV: 1 / v}.get(compute)
    d_dense = K.spmm_maxmin_d_dense(
        st.colptr(), st.row(), st.csr2csc(),
        None if w is None else torch.from_numpy(w)[st.csr2csc().long()],
        arg, gt, st.rowptr(), st.csc_slot())
    dot = K.spmm_maxmin_d_values(rp, cl, arg, gt, xt)[:, 0]
    total = K.spmm_maxmin_d_values(rp, cl, arg, gt, None)[:, 0]
    ref_dd, ref_dot, ref_total = np.zeros((25, 3)), np.zeros(len(col)), \
        np.zeros(len(col))
    a = arg.numpy()
    for r in range(30):
        for e in range(rowptr[r], rowptr[r + 1]):
            won = a[r] == e
            ref_dd[col[e]] += won * g[r] * (1.0 if w is None else w[e])
            ref_dot[e] = (won * g[r] * x[col[e]]).sum()
            ref_total[e] = (won * g[r]).sum()
    np.testing.assert_allclose(d_dense.numpy(), ref_dd, **TOL)
    np.testing.assert_allclose(dot.numpy(), ref_dot, **TOL)
    np.testing.assert_allclose(total.numpy(), ref_total, **TOL)


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_plain_segment_reduce_matches_jax(reduce):
    # the plain segment reduction with arg residuals, against
    # kernels/xla.py::segment_reduce on integer data (ties) with empty
    # segments
    rng = np.random.default_rng(18)
    ids = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    contrib = rng.integers(-3, 4, (300, 6)).astype(np.float32)
    out, arg = reference.segment_reduce(torch.from_numpy(contrib),
                                        torch.from_numpy(ids), 45,
                                        ReduceOp(reduce))
    jout, jarg = jx_xla.segment_reduce(jnp.asarray(contrib),
                                       jnp.asarray(ids), 45,
                                       JxReduceOp(reduce))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    full = np.bincount(ids, minlength=45) > 0
    np.testing.assert_array_equal(arg.numpy()[full], np.asarray(jarg)[full])
    assert (arg.numpy()[~full] == 300).all()
