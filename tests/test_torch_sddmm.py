"""The port's SDDMM (plain path on the CPU) against the JAX package.

The JAX side runs `sddmm(algorithm="xla")` (`kernels/xla.py::sddmm_chunked`)
and `sddmm(algorithm="pallas")`, the Pallas `sddmm_esc` kernel in
interpret mode, which `csrc/sddmm_csr.cu` replaces. Forward at 1e-5 (both
sides sum F <= 32 float32 products in another order); gradients at
rtol 1e-4 against `jax.grad` of `jnp.vdot(out, ct)` with a random
cotangent (a `.sum()` would let XLA fold the cotangent away).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.utils.testing import random_csr
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.kernels import reference, sddmm_csr
from dgsparse_tpu_torch.ops.types import ReduceOp

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(m, n, seed):
    rowptr, col, _ = random_csr(m, n, avg_degree=5.0, seed=seed)
    assert (np.diff(rowptr) == 0).any()           # empty rows present
    p = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(m, n))
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 sparse_sizes=(m, n))
    return p, j, rowptr, col


def _dense(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("feat", [1, 7, 16, 32])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_sddmm_matches_jax_xla_and_pallas(feat, reduce):
    p, j, _, _ = _pair(130, 90, seed=feat)
    d1, d2 = _dense(feat + 1, (130, feat), (90, feat))
    out = pt.sddmm(p, torch.from_numpy(d1), torch.from_numpy(d2), reduce)
    assert out.dtype == torch.float32 and out.shape == (p.nnz,)
    for alg in ("xla", "pallas"):
        ref = jx.sddmm(j, jnp.asarray(d1), jnp.asarray(d2), reduce, alg)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL,
                                   err_msg=alg)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_sddmm_bf16_matches_jax_dtype_and_values(reduce):
    # the JAX function returns bfloat16 for bfloat16 inputs; the port casts
    # its kernels' float32 sums to it, so it is the float32 result rounded
    # once, and JAX's at 2e-2 (its bf16 einsum also rounds as it sums)
    p, j, _, _ = _pair(130, 90, seed=21)
    d1, d2 = _dense(22, (130, 16), (90, 16))
    a = torch.from_numpy(d1).bfloat16()
    b = torch.from_numpy(d2).bfloat16()
    out = pt.sddmm(p, a, b, reduce)
    ref = jx.sddmm(j, jnp.asarray(d1, jnp.bfloat16),
                   jnp.asarray(d2, jnp.bfloat16), reduce, "xla")
    assert ref.dtype == jnp.bfloat16
    assert out.dtype == torch.bfloat16 and out.shape == (p.nnz,)
    exact = pt.sddmm(p, a.float(), b.float(), reduce)
    torch.testing.assert_close(out, exact.bfloat16(), rtol=0, atol=0)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_sddmm_grads_match_jax(reduce):
    p, j, _, col = _pair(110, 80, seed=5)
    d1, d2 = _dense(6, (110, 12), (80, 12))
    (ct,) = _dense(7, (len(col),))
    a = torch.from_numpy(d1).requires_grad_()
    b = torch.from_numpy(d2).requires_grad_()
    torch.dot(pt.sddmm(p, a, b, reduce), torch.from_numpy(ct)).backward()

    def loss(x1, x2):
        return jnp.vdot(jx.sddmm(j, x1, x2, reduce, "xla"), jnp.asarray(ct))

    g1, g2 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(d1), jnp.asarray(d2))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g1), **GRAD_TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(g2), **GRAD_TOL)


def test_sddmm_coo_matches_jax_with_grads():
    _, _, rowptr, col = _pair(70, 60, seed=8)
    row = np.repeat(np.arange(70, dtype=np.int32), np.diff(rowptr))
    order = np.random.default_rng(9).permutation(len(col))   # any order
    row, col = row[order], col[order]
    d1, d2, ct = _dense(10, (70, 8), (60, 8), (len(col),))
    a = torch.from_numpy(d1).requires_grad_()
    out = pt.sddmm_coo(torch.from_numpy(row), torch.from_numpy(col), a,
                       torch.from_numpy(d2))
    ref = jx.sddmm_coo(jnp.asarray(row), jnp.asarray(col), jnp.asarray(d1),
                       jnp.asarray(d2))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    torch.dot(out, torch.from_numpy(ct)).backward()
    g = jax.grad(lambda x: jnp.vdot(jx.sddmm_coo(
        jnp.asarray(row), jnp.asarray(col), x, jnp.asarray(d2)),
        jnp.asarray(ct)))(jnp.asarray(d1))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **GRAD_TOL)


@pytest.mark.parametrize("heads,feat", [(1, 5), (4, 3), (2, 16)])
def test_multihead_plain_sddmm_is_per_head_sddmm(heads, feat):
    _, j, rowptr, col = _pair(60, 50, seed=11)
    d1, d2 = _dense(12, (60, heads * feat), (50, heads * feat))
    rp, c = torch.from_numpy(rowptr), torch.from_numpy(col)
    out = sddmm_csr.sddmm_csr(rp, c, torch.from_numpy(d1),
                              torch.from_numpy(d2), heads, "mean")
    assert out.shape == (len(col), heads)
    for h in range(heads):
        sl = slice(h * feat, (h + 1) * feat)
        ref = jx.sddmm(j, jnp.asarray(d1[:, sl]), jnp.asarray(d2[:, sl]),
                       "mean", "xla")
        np.testing.assert_allclose(out[:, h].numpy(), np.asarray(ref), **TOL)


def test_chunked_plain_versions_match_unchunked(monkeypatch):
    _, _, rowptr, col = _pair(50, 40, seed=13)
    coo_row = torch.from_numpy(
        np.repeat(np.arange(50, dtype=np.int32), np.diff(rowptr)))
    c = torch.from_numpy(col)
    d1, d2, g = (torch.from_numpy(a) for a in
                 _dense(14, (50, 6), (40, 6), (len(col),)))
    deg = torch.from_numpy(np.diff(rowptr))
    whole = reference.sddmm_chunked(coo_row, c, d1, d2, ReduceOp.MEAN, deg)
    whole_bwd = reference.sddmm_bwd_chunked(coo_row, c, g, d2, 50)
    monkeypatch.setattr(reference, "_SDDMM_CHUNK_BUDGET", 4 * 6 * 7)
    torch.testing.assert_close(
        reference.sddmm_chunked(coo_row, c, d1, d2, ReduceOp.MEAN, deg),
        whole)
    torch.testing.assert_close(
        reference.sddmm_bwd_chunked(coo_row, c, g, d2, 50), whole_bwd)


def test_sddmm_checks():
    p, _, _, _ = _pair(30, 20, seed=15)
    with pytest.raises(ValueError, match="algorithm"):
        pt.sddmm(p, torch.ones(30, 4), torch.ones(20, 4), algorithm="bell")
    with pytest.raises(ValueError):
        pt.sddmm(p, torch.ones(30, 4), torch.ones(20, 5))
    with pytest.raises(ValueError):
        pt.sddmm(p, torch.ones(20, 4), torch.ones(30, 4))
    with pytest.raises(NotImplementedError):
        pt.sddmm(p, torch.ones(30, 4), torch.ones(20, 4), "max")


def test_sddmm_kernel_entry_refuses_cpu_tensors():
    sddmm_csr.reset_launch_counts()
    _, _, rowptr, col = _pair(20, 20, seed=16)
    with pytest.raises(ValueError, match="CUDA"):
        sddmm_csr.sddmm_csr_cuda(torch.from_numpy(rowptr),
                                 torch.from_numpy(col), torch.ones(20, 4),
                                 torch.ones(20, 4))
    assert sddmm_csr.LAUNCHES == {"sddmm_csr": 0, "sddmm_csr_split": 0}
