"""The port's GIN, SAGE and EdgeConv models against the JAX package's.

Each model is built on both sides from the same flax params (`nn.
load_flax_params` carries them over) and run on the same seeded graph and
features. Forwards at 1e-4 and gradients at rtol 1e-4, atol 1e-5 * max|g|:
sums of a few hundred terms taken in another order on each side, through
two or three dense layers. The JAX GIN does not pass an algorithm to its
GINConvs, so off the TPU it runs the XLA path, the same function as the
port's.

`tests/fixtures/torch_port/gin_small.npz` freezes a 3-layer GIN-max (the
smallest GIN whose training step runs the MAX backward): its forward and
3 Adam steps, so the card's machine, which has no JAX, can hold the port
to the JAX package (`chip_smoke.py`, `tests/test_torch_kernels_gpu.py`).
`test_gin_fixture_is_current` regenerates it and fails if it drifted;
rewrite it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_gin.py
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.nn import edgeconv as jx_edgeconv
from dgsparse_tpu.nn import gin as jx_gin
from dgsparse_tpu.nn import sage as jx_sage
from dgsparse_tpu.utils.testing import random_csr
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch import entry
from dgsparse_tpu_torch.nn import (DGCNN, GIN, SAGE, GINConv,
                                   load_flax_params)
from dgsparse_tpu_torch.nn.edgeconv import segment_max
from dgsparse_tpu_torch.utils.testing import (assert_train_close,
                                              run_gin_fixture)

FIXTURE = Path(__file__).parent / "fixtures" / "torch_port" / "gin_small.npz"
STEPS = 3
N, F_IN, HIDDEN, OUT = 200, 32, 16, 4


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _graph(seed, duplicates=0):
    """(rowptr, col, pt adj, jx adj, x, y) of an unweighted random graph
    with empty rows, `duplicates` of its edges repeated in their rows."""
    rowptr, col, _ = random_csr(N, N, avg_degree=4.0, seed=seed,
                                with_empty_rows=False)
    rng = np.random.default_rng(seed + 1)
    if duplicates:
        row = np.repeat(np.arange(N), np.diff(rowptr))
        dup = rng.choice(len(col), duplicates, replace=False)
        row, col = np.concatenate([row, row[dup]]), np.concatenate(
            [col, col[dup]])
        order = np.argsort(row, kind="stable")
        row, col = row[order], col[order].astype(np.int32)
        rowptr = np.concatenate(
            [[0], np.cumsum(np.bincount(row, minlength=N))]).astype(np.int32)
    p = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(N, N))
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col), None,
                                 sparse_sizes=(N, N))
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    y = rng.integers(0, OUT, N).astype(np.int32)
    return rowptr, col, p, j, x, y


def _loss_grads_jax(model, params, x, adj, y):
    def loss_fn(p):
        logits = model.apply(p, x, adj)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    return jax.value_and_grad(loss_fn)(params)


def _loss_grads_port(model, x, adj, y):
    model.zero_grad(set_to_none=True)
    loss = torch.nn.functional.cross_entropy(model(x, adj), y.long())
    loss.backward()
    return float(loss.detach()), model


def _port_grads_flax(model, flat):
    """The port's gradients in flax layout, keyed by flax path."""
    out = {}
    for path in flat:
        *mods, leaf = path.split("/")
        m = model
        for name in mods:
            m = getattr(m, name)
        g = m.weight.grad.T if leaf == "kernel" else getattr(m, leaf).grad
        out[path] = g.detach().numpy()
    return out


def _compare(jx_model, pt_model, rowptr, col, x, y, p, j):
    params = jx_model.init(jax.random.key(0), jnp.asarray(x), j)
    load_flax_params(pt_model, jax.tree.map(np.asarray, params)).eval()
    ref = jx_model.apply(params, jnp.asarray(x), j)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = pt_model(xt, p)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    loss, grads = _loss_grads_jax(jx_model, params, jnp.asarray(x), j,
                                  jnp.asarray(y))
    pt_loss, _ = _loss_grads_port(pt_model, xt, p, torch.from_numpy(y))
    ref_grads = _flatten(jax.tree.map(np.asarray, grads["params"]))
    assert_train_close([pt_loss], _port_grads_flax(pt_model, ref_grads),
                       [float(loss)], ref_grads)


@pytest.mark.parametrize("aggregator", ["sum", "max", "mean"])
def test_gin_forward_and_grads_match_jax(aggregator):
    rowptr, col, p, j, x, y = _graph(seed=31)
    _compare(jx_gin.GIN(HIDDEN, OUT, num_layers=3,
                        aggregator_type=aggregator),
             GIN(F_IN, HIDDEN, OUT, num_layers=3,
                 aggregator_type=aggregator),
             rowptr, col, x, y, p, j)


def test_ginconv_learned_eps_matches_jax():
    rowptr, col, p, j, x, y = _graph(seed=32)
    jx_model = jx_gin.GINConv((HIDDEN, OUT), "max", init_eps=0.25,
                              learn_eps=True)
    pt_model = GINConv(F_IN, (HIDDEN, OUT), "max", init_eps=0.25,
                       learn_eps=True)
    assert float(pt_model.eps) == 0.25
    _compare(jx_model, pt_model, rowptr, col, x, y, p, j)
    assert pt_model.eps.grad is not None


def test_sage_matches_jax():
    rowptr, col, p, j, x, y = _graph(seed=33)
    _compare(jx_sage.SAGE(HIDDEN, OUT), SAGE(F_IN, HIDDEN, OUT),
             rowptr, col, x, y, p, j)


def test_dgcnn_with_tied_edges_matches_jax():
    # repeated edges give identical per-edge rows: positive maxima tie, and
    # JAX splits their gradient evenly, which theta's gradient shows
    rowptr, col, p, j, x, y = _graph(seed=34, duplicates=150)
    _compare(jx_edgeconv.DGCNN(HIDDEN, OUT), DGCNN(F_IN, HIDDEN, OUT),
             rowptr, col, x, y, p, j)


def test_segment_max_splits_ties_as_jax_does():
    # ReLU zeros and equal maxima: every tie shares its element's gradient
    rowptr, col, p, j, _, _ = _graph(seed=35)
    rng = np.random.default_rng(36)
    e = np.maximum(rng.integers(-2, 3, (len(col), 5)), 0).astype(np.float32)
    ct = rng.standard_normal((N, 5)).astype(np.float32)
    et = torch.from_numpy(e).requires_grad_()
    out = segment_max(et, p)
    torch.sum(out * torch.from_numpy(ct)).backward()
    st = j.storage

    def f(a):
        m = jax.ops.segment_max(a, st.coo_row(), num_segments=N,
                                indices_are_sorted=True)
        deg = st.rowptr()[1:] - st.rowptr()[:-1]
        return jnp.vdot(jnp.where((deg > 0)[:, None], m, 0),
                        jnp.asarray(ct))

    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.asarray(jnp.where((np.diff(rowptr) > 0)[:, None],
                             jax.ops.segment_max(jnp.asarray(e),
                                                 st.coo_row(),
                                                 num_segments=N), 0)))
    ref = np.asarray(jax.grad(f)(jnp.asarray(e)))
    np.testing.assert_allclose(et.grad.numpy(), ref, rtol=1e-6, atol=1e-7)
    shared = (ref != 0) & (np.abs(ref) < np.abs(ct[np.repeat(
        np.arange(N), np.diff(rowptr))]) - 1e-6)
    assert shared.any()                      # some gradients were split


def make_gin_fixture() -> dict:
    """Graph, inputs, initial params, forward, losses and step-1
    gradients of a 3-layer GIN-max (32 -> 16 -> 16 -> 4) on 200 nodes."""
    rowptr, col, _, j, x, y = _graph(seed=37)
    model = jx_gin.GIN(HIDDEN, OUT, num_layers=3, aggregator_type="max")
    params = model.init(jax.random.key(3), jnp.asarray(x), j)
    fx = {"rowptr": rowptr, "col": col, "x": x, "y": y,
          "gin/dims": np.asarray([F_IN, HIDDEN, OUT, 3], np.int32),
          "gin/out": np.asarray(model.apply(params, jnp.asarray(x), j))}
    for k, v in _flatten(params["params"]).items():
        fx[f"gin/params/{k}"] = v
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)
    grad_fn = jax.jit(lambda p: _loss_grads_jax(model, p, jnp.asarray(x), j,
                                                jnp.asarray(y)))
    losses = []
    for step in range(STEPS):
        loss, grads = grad_fn(params)
        if step == 0:
            for k, v in _flatten(grads["params"]).items():
                fx[f"gin/grads/{k}"] = v
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    fx["gin/losses"] = np.asarray(losses, np.float64)
    return fx


@pytest.fixture(scope="module")
def fresh():
    assert jax.default_backend() == "cpu", jax.default_backend()
    return make_gin_fixture()


def test_gin_max_training_matches_jax(fresh):
    out, losses, grads = run_gin_fixture(fresh, "cpu", STEPS)
    np.testing.assert_allclose(out, fresh["gin/out"], rtol=1e-4, atol=1e-4)
    assert np.all(np.diff(losses) < 0), losses
    prefix = "gin/grads/"
    assert_train_close(losses, grads, fresh["gin/losses"],
                       {k[len(prefix):]: v for k, v in fresh.items()
                        if k.startswith(prefix)})
    # the second GINConv's MAX backward ran: its input layer has gradients
    assert np.abs(grads["gin0/apply_func/Dense_0/kernel"]).max() > 0


def test_gin_fixture_is_current(fresh):
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for k, v in fresh.items():
            if k in ("gin/out", "gin/losses") or "/grads/" in k:
                # XLA on another CPU may vectorize the sums differently
                np.testing.assert_allclose(
                    stored[k], v, rtol=1e-5,
                    atol=1e-6 * float(np.abs(v).max()), err_msg=k)
            else:
                np.testing.assert_array_equal(stored[k], v, err_msg=k)
                assert stored[k].dtype == v.dtype, k


def test_gin_entry_points_on_the_cpu():
    adj, x, y = entry.synthetic_graph("cora", device="cpu", gcn_norm=False)
    assert not adj.has_value and adj.storage.values() is None
    model, (x2, adj2) = entry.entry("gin-max-cora", device="cpu")
    assert isinstance(model, GIN) and model.num_convs == 2
    assert adj2.nnz == adj.nnz and torch.equal(x2, x)
    with torch.inference_mode():
        assert model(x2, adj2).shape == (2708, 7)
    # with the port's seeded init the first Adam update overshoots (the
    # loss rises at step 2 and falls after); with JAX's init the same
    # model's losses match JAX's and fall from step 1
    losses = entry.train("gin-max-cora", 2, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **make_gin_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
