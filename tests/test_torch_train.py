"""The port's GCN and GAT training steps against the JAX package's.

Both sides start from the same graph, inputs and flax params and run 3
Adam steps of the protocol of `benchmark/bench_train.py:144-156` (Adam at
lr 1e-2, mean cross-entropy, model applied without dropout). Losses must
agree at 1e-4 and the step-1 gradients of every parameter at rtol 1e-4,
atol 1e-5 * max|g|: sums of up to a few hundred terms taken in another
order on each side.

Parameters after the Adam updates are not compared: Adam's first update
is about lr * sign(g), so a gradient element near zero whose sign flips
between two summation orders moves its parameter by 2 * lr. Losses after
the updates still show that the steps went the same way.

`tests/fixtures/torch_port/train_small.npz` freezes the JAX side, so the
card's machine, which has no JAX, can hold the port to the JAX package
(`chip_smoke.py`, `tests/test_torch_kernels_gpu.py`).
`test_train_fixture_is_current` regenerates it and fails if it drifted;
rewrite it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train.py
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgsparse_tpu.nn import gat as jx_gat
from dgsparse_tpu.nn import gcn as jx_gcn
from dgsparse_tpu.utils.testing import random_csr
from dgsparse_tpu_torch import entry
from dgsparse_tpu_torch.utils.testing import (assert_train_close,
                                              run_train_fixture)

FIXTURE = Path(__file__).parent / "fixtures" / "torch_port" / "train_small.npz"
STEPS = 3
# (constructor sizes of the port's model, the flax model)
MODELS = {
    "gcn": ((32, 16, 4), lambda: jx_gcn.GCN(16, 4)),
    "gat": ((32, 8, 4, 4), lambda: jx_gat.GAT(8, 4, num_heads=4)),
}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_train(model, params, x, adj, y):
    """Losses of STEPS Adam steps and the step-1 gradients, as
    bench_train.py's step does them."""
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)

    def loss_fn(p):
        logits = model.apply(p, x, adj)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses, first = [], None
    for _ in range(STEPS):
        loss, grads = grad_fn(params)
        first = grads if first is None else first
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return np.asarray(losses, np.float64), first


def make_train_fixture() -> dict:
    """Graph, inputs, initial params, losses and step-1 gradients of a
    small GCN (32 -> 16 -> 4) and GAT (32 -> 4 x 8 -> 4) on 200 nodes."""
    n = 200
    rowptr, col, _ = random_csr(n, n, avg_degree=4.0, seed=21,
                                with_empty_rows=False)
    coo_row = np.repeat(np.arange(n, dtype=np.int32), np.diff(rowptr))
    edge_index = np.stack([coo_row, col])
    rowptr, col, vals = jx_gcn.gcn_norm_from_edge_index(edge_index, n)
    adj = jx_gcn.get_gcn_dcsr_from_edge_index(edge_index, n)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((n, 32)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    fx = {"rowptr": rowptr, "col": col, "vals": vals, "x": x, "y": y}
    for i, (name, (dims, make)) in enumerate(MODELS.items()):
        model = make()
        params = model.init(jax.random.key(i), jnp.asarray(x), adj)
        losses, grads = _jax_train(model, params, jnp.asarray(x), adj,
                                   jnp.asarray(y))
        fx[f"{name}/dims"] = np.asarray(dims, np.int32)
        for k, v in _flatten(params["params"]).items():
            fx[f"{name}/params/{k}"] = v
        fx[f"{name}/losses"] = losses
        for k, v in _flatten(grads["params"]).items():
            fx[f"{name}/grads/{k}"] = v
    return fx


def _grads(fx, name):
    prefix = f"{name}/grads/"
    return {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def fresh():
    assert jax.default_backend() == "cpu", jax.default_backend()
    return make_train_fixture()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_training_matches_jax(fresh, name):
    losses, grads = run_train_fixture(fresh, name, "cpu", STEPS)
    assert np.all(np.diff(losses) < 0), losses
    assert_train_close(losses, grads, fresh[f"{name}/losses"],
                       _grads(fresh, name))


def test_train_fixture_is_current(fresh):
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for k, v in fresh.items():
            if "/losses" in k or "/grads/" in k:
                # XLA on another CPU may vectorize the sums differently
                np.testing.assert_allclose(
                    stored[k], v, rtol=1e-5,
                    atol=1e-6 * float(np.abs(v).max()), err_msg=k)
            else:
                np.testing.assert_array_equal(stored[k], v, err_msg=k)
                assert stored[k].dtype == v.dtype, k


@pytest.mark.parametrize("config", sorted(entry.TRAIN_CONFIGS))
def test_entry_points_need_the_cpu_named_without_a_card(config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.train(config, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.build_trainer(config)


def test_serving_entry_points_need_the_cpu_named_without_a_card(monkeypatch):
    import dgsparse_tpu_torch as pt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: entry.entry("cora"),
                 lambda: entry.synthetic_graph("cora"),
                 lambda: entry.build_model("cora"),
                 pt.self_check):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    pt.self_check("cpu")


def test_train_runs_on_the_cpu_when_asked():
    losses = entry.train("gat-cora", 2, device="cpu")
    assert len(losses) == 2 and losses[1] < losses[0]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **make_train_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
