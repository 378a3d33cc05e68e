"""The port's spatially sharded submanifold conv (`dgsparse_tpu_torch/dist/
spconv.py`) against `dgsparse_tpu/dist/spconv.py` and against the port's
single-device `spconv`.

The port runs as 4 gloo ranks on the CPU (`dist.launch.run_ranks`, once
for the file), JAX on 4 devices of its virtual mesh in this process, on
the JAX tests' clouds. Tolerances: the forward at rtol 1e-4 / atol 1e-5,
the gradients (sums over up to 27 taps and every pair) at 1e-4 of their
largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import dgsparse_tpu_torch as pt
from dgsparse_tpu.dist.spconv import shard_pointcloud, spconv_sharded
from dgsparse_tpu_torch.dist import cases, spconv as pt_dist
from dgsparse_tpu_torch.dist.launch import run_ranks

WORLD = 4
TOL = dict(rtol=1e-4, atol=1e-5)


def _cloud(seed, n, shape, batches=1):
    rng = np.random.default_rng(seed)
    return np.unique(np.stack([
        rng.integers(0, batches, n) if batches > 1 else np.zeros(n, np.int64),
        rng.integers(0, shape[0], n), rng.integers(0, shape[1], n),
        rng.integers(0, shape[2], n)], 1), axis=0).astype(np.int32), rng


def _conv_case(seed, n, shape, c_in, c_out, batches=1):
    coords, rng = _cloud(seed, n, shape, batches)
    return dict(op="spconv", coords=coords, kernel_size=3,
                spatial_shape=shape,
                feats=rng.standard_normal((len(coords), c_in))
                .astype(np.float32),
                kernel=(rng.standard_normal((27, c_in, c_out)) * 0.2)
                .astype(np.float32),
                ct=rng.standard_normal((len(coords), c_out))
                .astype(np.float32))


# test_sharded_spconv_matches_single_device's, _grads' and the halo
# volume test's clouds
CASES = {"two_batches": dict(_conv_case(70, 3000, (40, 24, 16), 6, 10, 2),
                            plain=True),
         "grads": _conv_case(71, 1200, (24, 16, 12), 4, 6),
         "volume": _conv_case(71, 4000, (48, 24, 16), 6, 6)}


@pytest.fixture(scope="module")
def port():
    res = run_ranks(cases.run_cases, WORLD, device="cpu", timeout_s=120,
                    args=(list(CASES.values()),))
    assert not any(r.jax_loaded for r in res)
    return {name: [r.result[i] for r in res]
            for i, name in enumerate(CASES)}


def _plan(c):
    return shard_pointcloud(c["coords"], WORLD, 3,
                            spatial_shape=c["spatial_shape"])


def _cloud_order(c, blocks, key):
    """The ranks' slab rows of `key` back in the cloud's order."""
    _, order = pt_dist.shard_pointcloud(c["coords"], WORLD, 3,
                                        c["spatial_shape"])
    got = np.concatenate([b[key] for b in blocks])
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    return got[inv]


def _single(c):
    """The port's single-device conv: out, dX and dW of <out, ct>."""
    plan, _ = pt.build_rulebook(c["coords"], 3, 1, 1,
                                spatial_shape=c["spatial_shape"])
    x = torch.from_numpy(c["feats"]).requires_grad_()
    w = torch.from_numpy(c["kernel"]).requires_grad_()
    out = pt.spconv(x, w, plan)
    (out * torch.from_numpy(c["ct"])).sum().backward()
    return out.detach().numpy(), x.grad.numpy(), w.grad.numpy()


def _jx(c):
    plan, order = _plan(c)
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("graph",))

    def run(f, w):
        xb = plan.to_block_layout(f[order])
        xd = jax.device_put(xb, NamedSharding(mesh, P("graph")))
        return plan.from_block_layout(spconv_sharded(plan, xd, w, mesh))[inv]

    return run


def _close_scaled(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def test_shard_pointcloud_arrays_match_jax():
    c = CASES["two_batches"]
    mine, order = pt_dist.shard_pointcloud(c["coords"], WORLD, 3,
                                           c["spatial_shape"])
    ref, ref_order = _plan(c)
    np.testing.assert_array_equal(order, ref_order)
    for name in ("o2i", "out_mask", "send_left", "send_right"):
        a, b = getattr(mine, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("num_shards", "own_max", "h_max", "k_vol", "mid",
                 "num_voxels", "counts"):
        assert getattr(mine, name) == getattr(ref, name), name


def test_sharded_spconv_matches_jax_and_single_device(port):
    c = CASES["two_batches"]
    out = _cloud_order(c, port["two_batches"], "out")
    ref = np.asarray(_jx(c)(jnp.asarray(c["feats"]),
                            jnp.asarray(c["kernel"])))
    np.testing.assert_allclose(out, ref, **TOL)
    single, _, _ = _single(c)
    np.testing.assert_allclose(out, single, **TOL)
    # and the per-tap plain version of the same ranks
    np.testing.assert_allclose(
        _cloud_order(c, port["two_batches"], "plain"), out, **TOL)


def test_sharded_spconv_grads(port):
    c = CASES["grads"]
    blocks = port["grads"]
    dx = _cloud_order(c, blocks, "dx")
    dw = blocks[0]["dw"]                     # the global dW on every rank
    for b in blocks[1:]:
        np.testing.assert_array_equal(b["dw"], dw)
    run = _jx(c)
    gf, gw = jax.grad(
        lambda f, w: jnp.vdot(run(f, w), jnp.asarray(c["ct"])),
        argnums=(0, 1))(jnp.asarray(c["feats"]), jnp.asarray(c["kernel"]))
    _close_scaled(dx, np.asarray(gf))
    _close_scaled(dw, np.asarray(gw))
    _, dx1, dw1 = _single(c)
    _close_scaled(dx, dx1)
    _close_scaled(dw, dw1)


def test_sharded_spconv_rejects_thin_slabs():
    """Kernel 7 (r = 3), 4 shards over 8 x-planes: an interior slab spans
    fewer planes than the radius, so the planner refuses."""
    coords, _ = _cloud(71, 2000, (8, 12, 12))
    with pytest.raises(ValueError, match="x-plane"):
        pt_dist.shard_pointcloud(coords, 4, 7, spatial_shape=(8, 12, 12))
    pt_dist.shard_pointcloud(coords, 4, 3, spatial_shape=(8, 12, 12))
    with pytest.raises(ValueError, match="odd kernels"):
        pt_dist.shard_pointcloud(coords, 4, 2, spatial_shape=(8, 12, 12))


def test_spconv_halo_volume_is_boundary_sized(port):
    """The exchange moves two [h_max, C] buffers a rank and nothing
    all-gathers the cloud; h_max is one plane's worth, far below a slab."""
    for b in port["volume"]:
        assert b["volumes"] == {"ppermute": 2 * b["h_max"] * 6}
        assert b["h_max"] < 0.35 * b["own_max"]
