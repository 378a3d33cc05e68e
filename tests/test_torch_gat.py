"""The port's multi-head SpMM, edge softmax and GAT against the JAX package.

`spmm_multihead` is compared with the JAX op under `XLA_SEGMENT` and under
`PALLAS_EDGE_TILE`, which runs the Pallas `spmm_esc_mh` (interpret mode on
the CPU): forward at 1e-5, gradients of values and dense at rtol 1e-4
against `jax.grad` of `jnp.vdot(out, ct)`. The GAT forward, with the flax
model's weights carried over by `load_flax_params`, at 1e-4 (two layers of
dense products, softmaxes and SpMMs summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.nn import gat as jx_gat
from dgsparse_tpu.nn import gcn as jx_gcn
from dgsparse_tpu.utils.testing import random_csr
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.nn import GAT, load_flax_params
from tests.test_torch_split_plan import _softmax_oracle

M, N, H, F = 150, 120, 4, 8
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(seed, m=M, n=N):
    rowptr, col, _ = random_csr(m, n, avg_degree=5.0, seed=seed)
    assert (np.diff(rowptr) == 0).any()           # empty rows present
    p = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(m, n))
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 sparse_sizes=(m, n))
    return p, j, len(col)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("has_value", [True, False])
def test_spmm_multihead_matches_jax_with_grads(reduce, has_value):
    p, j, nnz = _pair(seed=1 + has_value)
    rng = np.random.default_rng(2)
    v = rng.standard_normal((nnz, H)).astype(np.float32)
    x = rng.standard_normal((N, H, F)).astype(np.float32)
    ct = rng.standard_normal((M, H, F)).astype(np.float32)
    vt = torch.from_numpy(v).requires_grad_() if has_value else None
    xt = torch.from_numpy(x).requires_grad_()
    out = pt.spmm_multihead(p, vt, xt, reduce)
    torch.sum(out * torch.from_numpy(ct)).backward()
    for alg in (jx.Algorithm.XLA_SEGMENT, jx.Algorithm.PALLAS_EDGE_TILE):
        def f(vals, dense):
            return jx.spmm_multihead(j, vals, dense, reduce, alg)

        vals = jnp.asarray(v) if has_value else None
        ref = f(vals, jnp.asarray(x))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   **TOL, err_msg=alg.name)
        gv, gx = jax.grad(lambda a, b: jnp.vdot(f(a, b), jnp.asarray(ct)),
                          argnums=(0, 1))(vals, jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   **GRAD_TOL, err_msg=alg.name)
        if has_value:
            np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv),
                                       **GRAD_TOL, err_msg=alg.name)


@pytest.mark.parametrize("shape", [(), (H,)])
def test_edge_softmax_matches_jax_with_grad(shape):
    p, j, nnz = _pair(seed=3)
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((nnz,) + shape)).astype(np.float32)
    ct = rng.standard_normal((nnz,) + shape).astype(np.float32)
    lt = torch.from_numpy(logits).requires_grad_()
    out = pt.edge_softmax(p, lt)
    torch.sum(out * torch.from_numpy(ct)).backward()
    ref = jx.edge_softmax(j, jnp.asarray(logits))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    g = jax.grad(lambda a: jnp.vdot(jx.edge_softmax(j, a), jnp.asarray(ct)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g), **GRAD_TOL)


def _long_rows_pair(seed):
    """A graph with empty rows and rows longer than SPLIT_CHUNK (128, 129
    and 300 entries), as both packages' SparseTensors."""
    rng = np.random.default_rng(seed)
    lengths = rng.poisson(6, M)
    lengths[rng.random(M) < 0.1] = 0
    lengths[[5, 9, 17]] = (128, 129, 300)
    rowptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = rng.integers(0, N, rowptr[-1]).astype(np.int32)
    p = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(M, N))
    assert p.storage.row_split().num_split_rows == 2
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 sparse_sizes=(M, N))
    return p, j, rowptr


@pytest.mark.parametrize("layout", ["row_major", "column_major"])
@pytest.mark.parametrize("shape", [(), (1,), (8,)])
def test_edge_softmax_function_matches_jax_and_oracle(shape, layout):
    # the plain path of edge_softmax's Function, forward and its explicit
    # backward, on hub rows, empty rows and a row of -inf; logits read
    # through their strides (a column-major [nnz, H], a strided [nnz])
    p, j, rowptr = _long_rows_pair(seed=8)
    nnz = int(rowptr[-1])
    rng = np.random.default_rng(9)
    logits = (3 * rng.standard_normal((nnz,) + shape)).astype(np.float32)
    ct = rng.standard_normal((nnz,) + shape).astype(np.float32)
    inf_row = 2
    s, e = rowptr[inf_row], rowptr[inf_row + 1]
    assert e - s > 1
    finite = np.ones(nnz, bool)
    finite[s:e] = False
    with_inf = logits.copy()
    with_inf[s:e] = -np.inf
    if layout == "row_major":
        lt = torch.zeros((nnz,) + shape)
    elif shape:
        lt = torch.zeros(shape[::-1] + (nnz,)).t()
    else:
        lt = torch.zeros(nnz, 2)[:, 0]           # a strided [nnz]
    lt.copy_(torch.from_numpy(with_inf))
    lt.requires_grad_()
    out = pt.edge_softmax(p, lt)
    assert out.grad_fn.name() == "_EdgeSoftmaxBackward"
    torch.sum(out * torch.from_numpy(ct)).backward()
    alpha = _softmax_oracle(rowptr, with_inf)
    grad = _softmax_oracle(rowptr, alpha, ct)
    np.testing.assert_allclose(out.detach().numpy(), alpha, **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), grad, **GRAD_TOL)
    assert not out.detach().numpy()[s:e].any()
    assert not lt.grad.numpy()[s:e].any()
    # JAX gives NaN on a row of -inf (its floor flushes to 0): compared
    # on the other rows, with that row's logits finite
    ref = jx.edge_softmax(j, jnp.asarray(logits))
    np.testing.assert_allclose(out.detach().numpy()[finite],
                               np.asarray(ref)[finite], **TOL)
    g = jax.grad(lambda a: jnp.vdot(jx.edge_softmax(j, a), jnp.asarray(ct)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy()[finite],
                               np.asarray(g)[finite], **GRAD_TOL)


def test_gat_forward_matches_flax():
    n = 180
    rowptr, col, _ = random_csr(n, n, avg_degree=4.0, seed=5,
                                with_empty_rows=False)
    coo_row = np.repeat(np.arange(n, dtype=np.int32), np.diff(rowptr))
    edge_index = np.stack([coo_row, col])
    adj_j = jx_gcn.get_gcn_dcsr_from_edge_index(edge_index, n)
    adj_p = pt.nn.get_gcn_dcsr_from_edge_index(edge_index, n, device="cpu")
    x = np.random.default_rng(6).standard_normal((n, 24)).astype(np.float32)
    model_j = jx_gat.GAT(hidden_features=8, out_features=5, num_heads=H)
    params = model_j.init(jax.random.key(7), jnp.asarray(x), adj_j)
    ref = model_j.apply(params, jnp.asarray(x), adj_j)
    model_p = load_flax_params(GAT(24, 8, 5, H),
                               jax.tree.map(np.asarray, params))
    with torch.no_grad():
        out = model_p(torch.from_numpy(x), adj_p)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_gat_load_flax_params_checks_shapes():
    params = {"gat1": {"proj": {"kernel": np.zeros((24, 32), np.float32)},
                       "a_dst": np.zeros((4, 8), np.float32),
                       "a_src": np.zeros((4, 8), np.float32)}}
    with pytest.raises(ValueError, match="gat1"):
        load_flax_params(GAT(24, 16, 5, 4), params)


def test_gat_init_follows_flax_defaults():
    model = GAT(64, 16, 7, 4, generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    limit = np.sqrt(6.0 / (4 + 16))
    for a in (model.gat1.a_dst, model.gat1.a_src):
        assert a.shape == (4, 16) and float(a.abs().max()) <= limit
    w = model.gat1.proj.weight
    assert w.shape == (64, 64) and model.gat1.proj.bias is None
    assert float(w.abs().max()) <= 2 * np.sqrt(1 / 64) / .87962566103423978


def test_spmm_multihead_refuses_what_is_not_ported():
    p, _, nnz = _pair(seed=8)
    x = torch.ones(N, H, F)
    with pytest.raises(ValueError):
        pt.spmm_multihead(p, torch.ones(nnz, H), x, "prod")
    # a list of per-head values must hold SlotValues (ported since the
    # slot-space ops were)
    with pytest.raises(TypeError, match="SlotValues"):
        pt.spmm_multihead(p, [object()] * H, x)
    with pytest.raises(ValueError):
        pt.spmm_multihead(p, torch.ones(nnz, H + 1), x)
    with pytest.raises(ValueError):
        pt.spmm_multihead(p, torch.ones(nnz, H), torch.ones(N, H * F))
