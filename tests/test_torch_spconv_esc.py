"""The port's ESC spconv route and its bf16 sparse-conv layers against the
JAX package's.

- ESC (`ops/spconv.py`, forced on with `_FORCE_ESC` as JAX's tests force
  theirs): the forward and both gradients against JAX's ESC route on
  JAX's two cases (`tests/test_spconv_esc.py:19, 51`: submanifold and
  strided), and against the port's default fused route, at 1e-4 (sums of
  up to 27 * c_in terms in another order on each side); the reduction
  runs `csr_spmm` (its plain version here) and the metrics say "esc".
- bf16 layers: `SubMConv3d`, `SparseConv3d` and `SparseInverseConv3d`
  with `compute_dtype` and `param_dtype` bfloat16 on flax params carried
  across (`nn/_flax.py::load_flax_params`) against JAX's layers, at 1e-2
  of the terms' absolute sum; their gradients against the fp32 layer's.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgsparse_tpu.nn import sparse_conv as jx_layers
from dgsparse_tpu.ops import spconv as S
from dgsparse_tpu_torch.nn import sparse_conv as layers
from dgsparse_tpu_torch.nn._flax import load_flax_params
from dgsparse_tpu_torch.ops import spconv as P
from dgsparse_tpu_torch.utils import metrics
from dgsparse_tpu_torch.utils.testing import assert_sum_close, random_cloud
from tests.test_torch_spconv import (_jax_out_and_grads, _plans,
                                     _port_out_and_grads)

TOL = dict(rtol=1e-4, atol=1e-4)
# JAX's two cases: (stride, shape, points, c_in, c_out, seed)
CASES = {"subm": (1, (12, 10, 8), 140, 8, 16, 42),
         "strided": (2, (12, 12, 8), 120, 8, 8, 44)}


@pytest.fixture
def force_esc():
    S._FORCE_ESC[0] = True
    P._FORCE_ESC[0] = True
    yield
    S._FORCE_ESC[0] = False
    P._FORCE_ESC[0] = False


def _case(kind):
    stride, shape, n, c_in, c_out, seed = CASES[kind]
    coords = random_cloud(n, shape, 1, seed=seed)
    jp, _, pp, _ = _plans(coords, shape, stride)
    rng = np.random.default_rng(seed + 1)
    feats = rng.standard_normal((pp.num_in, c_in)).astype(np.float32)
    kernel = (rng.standard_normal((27, c_in, c_out)) * 0.1).astype(
        np.float32)
    ct = rng.standard_normal((pp.num_out, c_out)).astype(np.float32)
    return jp, pp, feats, kernel, ct


@pytest.mark.parametrize("kind", sorted(CASES))
def test_esc_matches_jax_esc_and_the_fused_route(force_esc, kind):
    jp, pp, feats, kernel, ct = _case(kind)
    assert jp.use_esc() and pp.use_esc()
    want = _jax_out_and_grads(jp, feats, kernel, ct)
    metrics.reset()
    metrics.enable()
    try:
        got = _port_out_and_grads(pp, feats, kernel, ct)
    finally:
        metrics.disable()
    (key,), = [list(metrics.counters())]
    metrics.reset()
    assert dict(key[1:]) == {"path": "esc", "pairs": pp.total_pairs,
                             "c_in": feats.shape[1],
                             "c_out": kernel.shape[2]}
    P._FORCE_ESC[0] = False
    fused = _port_out_and_grads(pp, feats, kernel, ct)
    for name, g, w, f in zip(("out", "dX", "dW"), got, want, fused):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
        np.testing.assert_allclose(g, f, err_msg=name, **TOL)


def test_esc_needs_a_sparse_plan(force_esc):
    """A plan whose pairs fill more than half the probes, or none, takes
    the fused route even when ESC is forced (JAX's `use_esc_structure`)."""
    dense = np.array([[0, x, y, z] for x in range(4) for y in range(4)
                      for z in range(4)], np.int32)
    plan, _ = P.build_rulebook(dense, 3, 1, 1, spatial_shape=(4, 4, 4))
    jplan, _ = S.build_rulebook(dense, 3, 1, 1, spatial_shape=(4, 4, 4))
    assert plan.use_esc() == jplan.use_esc() is False
    lone, _ = P.build_rulebook(dense[:1], 3, 1, 1, spatial_shape=(4, 4, 4))
    assert lone.total_pairs == 0 and not lone.use_esc()


def test_stream_csr_leaves_out_padding():
    _, pp, *_ = _case("strided")
    imap, omap = pp.imap.numpy(), pp.omap.numpy()
    for by, ids, rows in (("out", omap, pp.num_out),
                          ("in", imap, pp.num_in)):
        rowptr, col, coo_row = (t.numpy() for t in pp.stream_csr(by))
        assert len(col) == pp.total_pairs and (imap[col] >= 0).all()
        np.testing.assert_array_equal(ids[col], coo_row)
        np.testing.assert_array_equal(
            rowptr, np.searchsorted(coo_row, np.arange(rows + 1)))
        assert (np.diff(col)[np.diff(coo_row) == 0] > 0).all()


def _cloud_tensor(coords, shape, feats):
    from dgsparse_tpu.ops.spconv import SparseConvTensor as JST

    from dgsparse_tpu_torch.ops.spconv import SparseConvTensor as PST

    return (JST(jnp.asarray(feats), coords, shape),
            PST(torch.from_numpy(feats), coords, shape))


LAYERS = {
    "subm": (lambda: jx_layers.SubMConv3d(24, compute_dtype=jnp.bfloat16,
                                          param_dtype=jnp.bfloat16),
             lambda c_in, **kw: layers.SubMConv3d(c_in, 24, **kw)),
    "strided": (lambda: jx_layers.SparseConv3d(24,
                                               compute_dtype=jnp.bfloat16,
                                               param_dtype=jnp.bfloat16),
                lambda c_in, **kw: layers.SparseConv3d(c_in, 24, **kw)),
}


class _JaxInverse(fnn.Module):
    """JAX's inverse conv applied to the fine cloud's own features (the
    strided plan's inverse maps coarse sites back onto the fine ones)."""

    @fnn.compact
    def __call__(self, coarse, fine_st):
        return jx_layers.SparseInverseConv3d(
            24, compute_dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)(
                coarse, fine_st)


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
def test_bf16_layers_match_jax(kind):
    shape, c_in = (12, 10, 8), 16
    coords = random_cloud(220, shape, 2, seed=61)
    rng = np.random.default_rng(62)
    feats = rng.standard_normal((len(coords), c_in)).astype(np.float32)
    jst, pst = _cloud_tensor(coords, shape, feats)
    if kind == "inverse":
        coarse_plan, _ = pst.plan_for(3, 2, 1)
        coarse = rng.standard_normal((coarse_plan.num_out, c_in)).astype(
            np.float32)
        jmod = _JaxInverse()
        params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(coarse), jst)
        want = jmod.apply(params, jnp.asarray(coarse), jst).features
        params = {"params": params["params"]["SparseInverseConv3d_0"]}
        make = lambda **kw: layers.SparseInverseConv3d(  # noqa: E731
            c_in, 24, **kw)
        run = lambda m, c: m(c, pst).features  # noqa: E731
        x = torch.from_numpy(coarse)
    else:
        jmake, make0 = LAYERS[kind]
        jmod = jmake()
        params = jmod.init(jax.random.PRNGKey(0), jst)
        want = jmod.apply(params, jst).features
        make = lambda **kw: make0(c_in, **kw)  # noqa: E731
        run = lambda m, f: m(pst.replace(features=f)).features  # noqa: E731
        x = torch.from_numpy(feats)
    assert want.dtype == jnp.bfloat16
    assert params["params"]["kernel"].dtype == jnp.bfloat16
    bf16 = load_flax_params(make(compute_dtype=torch.bfloat16,
                                 param_dtype=torch.bfloat16), params)
    assert bf16.kernel.dtype == torch.bfloat16
    f32 = make()
    with torch.no_grad():
        f32.kernel.copy_(bf16.kernel.float())
        f32.bias.copy_(bf16.bias.float())
    out = run(bf16, x)
    assert out.dtype == torch.bfloat16
    with torch.no_grad():
        abs_f32 = make()
        abs_f32.kernel.copy_(f32.kernel.abs())
        abs_sum = run(abs_f32, x.abs())
    ref = torch.from_numpy(np.asarray(want, np.float32))
    assert_sum_close(out.float(), ref, abs_sum, 1e-2)

    # backward: the bf16 layer (fp32 params) against the fp32 layer
    mixed = make(compute_dtype=torch.bfloat16)
    with torch.no_grad():
        mixed.kernel.copy_(f32.kernel)
    ct = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))
    grads = []
    for m in (mixed, f32):
        xi = x.clone().requires_grad_()
        (run(m, xi).float() * ct).sum().backward()
        grads.append((xi.grad, m.kernel.grad))
    assert mixed.kernel.grad.dtype == torch.float32
    for g, r in zip(*grads):
        err = (g - r).abs().max().item()
        assert err <= 1e-2 * r.abs().max().item(), err
