"""The port's point-cloud UNet against the JAX package's.

The UNet of `examples/pointcloud_unet.py:49-60` (submanifold blocks, a
strided downsample, an inverse-conv upsample with a skip connection, a
dense head) is built on both sides from the same flax params and run on
the same seeded voxel cloud, drawn as the example draws it. Forward and
losses at 1e-4 and gradients at rtol 1e-4, atol 1e-5 * max|g|: sums of up
to 27 * 64 terms taken in another order on each side, through four convs
and two LayerNorms.

`tests/fixtures/torch_port/unet_small.npz` freezes the JAX run (flax
params, logits, the losses of 3 Adam steps at the example's lr 1e-3, the
step-1 gradients), so the card's machine, which has no JAX, can hold the
port to it (`chip_smoke.py`). `test_unet_fixture_is_current` regenerates
it and fails if it drifted; rewrite it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_unet.py
"""

import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgsparse_tpu.nn import (SparseConv3d, SparseConvBlock,
                             SparseInverseConv3d)
from dgsparse_tpu.ops.spconv import SparseConvTensor as JxSparseConvTensor
from dgsparse_tpu_torch import entry
from dgsparse_tpu_torch.nn import PointCloudUNet, load_flax_params
from dgsparse_tpu_torch.utils.testing import (assert_train_close,
                                              fixture_model, run_gin_fixture)

FIXTURE = Path(__file__).parent / "fixtures" / "torch_port" / "unet_small.npz"
STEPS = 3
IN_FEATURES, CLASSES, LR = 8, 8, 1e-3
POINTS, SHAPE = 600, (16, 16, 12)


class JxUNet(fnn.Module):
    """The example's UNet (`examples/pointcloud_unet.py:49-60`)."""

    classes: int

    @fnn.compact
    def __call__(self, st):
        e1 = SparseConvBlock(32, name="enc1")(st)
        d1 = SparseConv3d(64, stride=2, name="down1")(e1)
        d1 = SparseConvBlock(64, name="enc2")(d1)
        u1 = SparseInverseConv3d(32, name="up1")(d1.features, e1)
        f = jnp.concatenate([u1.features, e1.features], -1)
        return fnn.Dense(self.classes, name="head")(f)


def example_cloud(points, shape, seed=0, classes=CLASSES):
    """The example's draws (`examples/pointcloud_unet.py:37-46`): coords
    [n, 4] int32 of batch 0, features [n, 8] float32, labels [n]."""
    rng = np.random.default_rng(seed)
    total = shape[0] * shape[1] * shape[2]
    flat = rng.choice(total, size=min(points, total), replace=False)
    x_, r = np.divmod(flat, shape[1] * shape[2])
    y_, z_ = np.divmod(r, shape[2])
    coords = np.stack([np.zeros_like(x_), x_, y_, z_], 1).astype(np.int32)
    feats = rng.standard_normal((len(coords), 8)).astype(np.float32)
    labels = rng.integers(0, classes, len(coords))
    return coords, feats, labels


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def make_unet_fixture() -> dict:
    """Cloud, initial params, logits, losses and step-1 gradients of the
    example's UNet (8 -> 32 -> 64 -> 32 -> 8 classes) on 600 voxels, with
    the example's init key, loss and optimizer."""
    coords, feats, labels = example_cloud(POINTS, SHAPE, seed=0)
    st = JxSparseConvTensor(jnp.asarray(feats), coords, SHAPE)
    model = JxUNet(CLASSES)
    params = model.init(jax.random.key(0), st)
    fx = {"coords": coords, "shape": np.asarray(SHAPE, np.int32),
          "x": feats, "y": labels.astype(np.int32),
          "unet/dims": np.asarray([IN_FEATURES, CLASSES], np.int32),
          "unet/lr": np.asarray(LR),
          "unet/out": np.asarray(model.apply(params, st))}
    for k, v in _flatten(params["params"]).items():
        fx[f"unet/params/{k}"] = v

    def loss_fn(p, f):
        logits = model.apply(p, st.replace(features=f))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    tx = optax.adam(LR)
    opt_state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for step in range(STEPS):
        loss, grads = grad_fn(params, jnp.asarray(feats))
        if step == 0:
            for k, v in _flatten(grads["params"]).items():
                fx[f"unet/grads/{k}"] = v
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    fx["unet/losses"] = np.asarray(losses, np.float64)
    return fx


@pytest.fixture(scope="module")
def fresh():
    assert jax.default_backend() == "cpu", jax.default_backend()
    return make_unet_fixture()


def _grads_of(fx):
    prefix = "unet/grads/"
    return {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}


def test_unet_matches_jax(fresh):
    out, losses, grads = run_gin_fixture(fresh, "cpu", STEPS, name="unet")
    np.testing.assert_allclose(out, fresh["unet/out"], rtol=1e-4, atol=1e-4)
    assert out.shape == (POINTS, CLASSES)
    assert_train_close(losses, grads, fresh["unet/losses"], _grads_of(fresh))
    # every layer took part: the first conv's kernel has gradients
    assert np.abs(grads["enc1/SubMConv3d_0/kernel"]).max() > 0


def test_unet_fixture_is_current(fresh):
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for k, v in fresh.items():
            if k in ("unet/out", "unet/losses") or "/grads/" in k:
                # XLA on another CPU may vectorize the sums differently
                np.testing.assert_allclose(
                    stored[k], v, rtol=1e-5,
                    atol=1e-6 * float(np.abs(v).max()), err_msg=k)
            else:
                np.testing.assert_array_equal(stored[k], v, err_msg=k)
                assert stored[k].dtype == v.dtype, k


def test_load_flax_params_keeps_the_spconv_layout(fresh):
    model, _, _, _ = fixture_model(fresh, "unet", "cpu")
    p = "unet/params/"
    # a sparse conv's kernel [k_vol, c_in, c_out] as it is, not reversed
    for path, param in (("enc1/SubMConv3d_0/kernel",
                         model.enc1.SubMConv3d_0.kernel),
                        ("down1/kernel", model.down1.kernel),
                        ("enc2/SubMConv3d_0/kernel",
                         model.enc2.SubMConv3d_0.kernel),
                        ("up1/kernel", model.up1.kernel)):
        np.testing.assert_array_equal(param.detach().numpy(),
                                      fresh[p + path], err_msg=path)
    # a LayerNorm's scale is its weight; a Dense kernel is the transposed
    # Linear weight
    np.testing.assert_array_equal(model.enc2.LayerNorm_0.weight.detach(),
                                  fresh[p + "enc2/LayerNorm_0/scale"])
    np.testing.assert_array_equal(model.head.weight.detach().T,
                                  fresh[p + "head/kernel"])
    params = {k[len(p):]: v for k, v in fresh.items() if k.startswith(p)}
    params["down1/kernel"] = np.ascontiguousarray(params["down1/kernel"].T)
    tree = {}
    for path, v in params.items():
        node = tree
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    with pytest.raises(ValueError):
        load_flax_params(PointCloudUNet(IN_FEATURES, CLASSES), tree)


def test_unet_plans_are_the_forwards(fresh, monkeypatch):
    from dgsparse_tpu_torch.nn import sparse_conv

    model, st, x, _ = fixture_model(fresh, "unet", "cpu")
    plans = model.plans(st)
    used = []

    def recording(features, kernel, plan):
        used.append(plan)
        return spconv(features, kernel, plan)

    spconv = sparse_conv.spconv
    monkeypatch.setattr(sparse_conv, "spconv", recording)
    with torch.no_grad():
        model(x, st)
    assert used == [plans[k] for k in ("enc1", "down1", "enc2", "up1")]
    assert all(a is b for a, b in zip(used, plans.values()))
    assert plans["enc1"].num_out == plans["up1"].num_out == POINTS
    assert plans["enc2"].num_in == plans["down1"].num_out
    assert plans["up1"].total_pairs == plans["down1"].total_pairs


def test_unet_init_follows_flax():
    model = PointCloudUNet(generator=torch.Generator().manual_seed(0))
    kernel = model.enc2.SubMConv3d_0.kernel.detach()
    std = float(np.sqrt(2.0 / (27 * 64)))
    assert kernel.shape == (27, 64, 64)
    assert abs(float(kernel.std()) / std - 1) < 0.05
    assert float(kernel.abs().max()) <= 2 * std / .87962566103423978
    assert not model.enc2.SubMConv3d_0.bias.any()
    assert model.enc1.LayerNorm_0.eps == 1e-6


def test_synthetic_cloud_is_the_examples_cloud():
    st, x, y = entry.synthetic_cloud("unet", device="cpu")
    coords, feats, labels = example_cloud(20000, (128, 128, 32), seed=0)
    np.testing.assert_array_equal(st.coords, coords)
    np.testing.assert_array_equal(x.numpy(), feats)
    np.testing.assert_array_equal(y.numpy(), labels)
    assert st.spatial_shape == (128, 128, 32) and st.features is x
    assert entry.CLOUDS["unet-60k"].num_points == 60000
    assert entry.CLOUDS["unet-60k"].spatial_shape == (128, 128, 64)


def test_unet_entry_points_on_the_cpu(monkeypatch):
    monkeypatch.setitem(entry.CLOUDS, "unet", entry.CloudConfig(
        2000, (32, 32, 16)))
    model, (x, st) = entry.entry("unet", device="cpu")
    assert isinstance(model, PointCloudUNet)
    # a served forward under inference_mode, then training on the same
    # cloud and its cached rulebooks
    with torch.inference_mode():
        assert model(x, st).shape == (2000, CLASSES)
    model, opt, (st2, x2, y) = entry.build_trainer("unet", device="cpu",
                                                   data=(st, x, torch.zeros(
                                                       2000,
                                                       dtype=torch.long)))
    assert opt.param_groups[0]["lr"] == 1e-3
    assert np.isfinite(float(entry.train_step(model, opt, x2, st2, y)))
    losses = entry.train("unet", 2, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "unet" in entry.SERVE_CONFIGS and "unet-60k" in entry.TRAIN_CONFIGS


def test_unet_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry.synthetic_cloud("unet")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **make_unet_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
