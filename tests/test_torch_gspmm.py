"""The port's semiring SpMM grid (plain path on the CPU) against the JAX
package's `gspmm`.

Every `u_<compute>_e_<reduce>` op and every `copy_u_<reduce>`, forward and
both gradients (`jax.grad` of `jnp.vdot(out, ct)` with a random cotangent),
on a graph with empty rows. The JAX side runs its XLA path (AUTO off the
TPU), with the winner-mask backward for MAX/MIN. Values are drawn with
|v| in [0.5, 2], away from 0, since DIV and its gradient divide by them;
features from a continuous distribution, so MAX/MIN have no ties.
Tolerance 1e-5 (rtol and atol): SUM/MEAN of ADD/SUB add the row sum of the
values to the unweighted SpMM (Σu ± Σe) where JAX sums u ± e, and the
gradients sum in another order; that moves results by a few ulp of sums
of about ten terms of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.ops import gspmm as jx_gspmm
from dgsparse_tpu.utils.testing import random_csr
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.ops import gspmm as pt_gspmm
from dgsparse_tpu_torch.utils.testing import gspmm_oracle

TOL = dict(rtol=1e-5, atol=1e-5)
M, N, F = 70, 50, 6
OPS = sorted(name for name in pt_gspmm.__all__
             if name.startswith(("u_", "copy_u_")))


def test_the_grid_is_complete():
    assert len(OPS) == 20
    assert OPS == sorted(n for n in jx_gspmm.__all__
                         if n.startswith(("u_", "copy_u_")))


def _inputs(seed):
    rowptr, col, _ = random_csr(M, N, avg_degree=5.0, seed=seed)
    assert (np.diff(rowptr) == 0).any()
    rng = np.random.default_rng(seed + 1)
    v = (rng.uniform(0.5, 2.0, len(col))
         * rng.choice([-1.0, 1.0], len(col))).astype(np.float32)
    x = rng.standard_normal((N, F)).astype(np.float32)
    ct = rng.standard_normal((M, F)).astype(np.float32)
    return rowptr, col, v, x, ct


@pytest.mark.parametrize("name", OPS)
def test_op_and_grads_match_jax(name):
    rowptr, col, v, x, ct = _inputs(seed=OPS.index(name))
    has_value = not name.startswith("copy_u")
    vt = torch.from_numpy(v).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    p = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(v),
                                 sparse_sizes=(M, N)).set_values(vt)
    out = getattr(pt_gspmm, name)(p, xt)
    torch.sum(out * torch.from_numpy(ct)).backward()

    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 jnp.asarray(v), sparse_sizes=(M, N))

    def loss(vals, dense):
        return jnp.vdot(getattr(jx_gspmm, name)(j.set_values(vals), dense),
                        jnp.asarray(ct))

    ref = getattr(jx_gspmm, name)(j, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    *_, compute, _, reduce = name.split("_")
    np.testing.assert_allclose(
        out.detach().numpy(),
        gspmm_oracle(rowptr, col, v if has_value else None, x, reduce,
                     compute), **TOL)
    gv, gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL,
                               err_msg="d_dense")
    if has_value:
        np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv), **TOL,
                                   err_msg="d_values")
    else:
        assert vt.grad is None


@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_raw_csr_entries_match_jax(reduce):
    rowptr, col, v, x, _ = _inputs(seed=40)
    t = torch.from_numpy
    out = pt.GSpMM_u_e(t(rowptr), t(col), t(v), t(x), reduce, "sub")
    ref = jx.GSpMM_u_e(jnp.asarray(rowptr), jnp.asarray(col), jnp.asarray(v),
                       jnp.asarray(x), reduce, "sub")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    out = pt.GSpMM_u(t(rowptr), t(col), t(x), reduce)
    ref = jx.GSpMM_u(jnp.asarray(rowptr), jnp.asarray(col), jnp.asarray(x),
                     reduce)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_gspmm_refuses_slot_values_and_bad_shapes():
    rowptr, col, v, x, _ = _inputs(seed=41)
    p = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(v),
                                 sparse_sizes=(M, N))
    # slot-space values are ported: anything else as `values` is refused
    with pytest.raises(TypeError, match="SlotValues"):
        pt.gspmm(p, torch.from_numpy(x), values=object())
    with pytest.raises(ValueError):
        pt.gspmm(p, torch.ones(N + 1, F))


@pytest.mark.parametrize("compute", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_plain_gspmm_forward_matches_jax(reduce, compute):
    # the plain semiring forward (the CPU oracle of the max/min kernel's
    # compute template) against kernels/xla.py::gspmm_forward, arg included
    from dgsparse_tpu.kernels import xla as jx_xla
    from dgsparse_tpu.ops.types import ComputeOp as JxComputeOp
    from dgsparse_tpu.ops.types import ReduceOp as JxReduceOp
    from dgsparse_tpu_torch.kernels import reference
    from dgsparse_tpu_torch.ops.types import ComputeOp, ReduceOp

    rowptr, col, v, x, _ = _inputs(seed=42)
    coo_row = np.repeat(np.arange(M, dtype=np.int32), np.diff(rowptr))
    deg = np.diff(rowptr)
    out, arg = reference.gspmm_forward(
        torch.from_numpy(coo_row), torch.from_numpy(col), torch.from_numpy(v),
        torch.from_numpy(x), M, ReduceOp(reduce), ComputeOp(compute),
        torch.from_numpy(deg))
    jout, jarg = jx_xla.gspmm_forward(
        jnp.asarray(coo_row), jnp.asarray(col), jnp.asarray(v),
        jnp.asarray(x), M, JxReduceOp(reduce), JxComputeOp(compute),
        jnp.asarray(deg))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    if reduce in ("max", "min"):
        np.testing.assert_array_equal(arg.numpy()[deg > 0],
                                      np.asarray(jarg)[deg > 0])
    else:
        assert arg is None and jarg is None
