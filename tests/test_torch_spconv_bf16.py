"""The port's bf16 sparse-conv layers against the JAX package's.

`SubMConv3d`, `SparseConv3d` and `SparseInverseConv3d` with `compute_dtype`
and `param_dtype` bfloat16 on flax params carried across
(`nn/_flax.py::load_flax_params`) against JAX's layers, at 1e-2 of the
terms' absolute sum; their gradients against the fp32 layer's.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgsparse_tpu.nn import sparse_conv as jx_layers
from dgsparse_tpu_torch.nn import sparse_conv as layers
from dgsparse_tpu_torch.nn._flax import load_flax_params
from dgsparse_tpu_torch.utils.testing import assert_sum_close, random_cloud


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
