"""The port's sharded GCN and GAT (`dgsparse_tpu_torch/dist/gcn.py`,
`dist/gat.py`) against `dgsparse_tpu/dist/gcn.py` and `dist/gat.py`.

The port runs as 4 gloo ranks on the CPU (`dist.launch.run_ranks`, once
for the file), JAX on 4 devices of its virtual mesh in this process, from
the same numpy inputs and JAX's initial parameters (`params_from_jax`).
Tolerances: rtol 1e-4 / atol 1e-5 for logits and losses
(`tests/test_dist.py`'s), parameters after a step at 1e-5 of their
largest magnitude.

`tests/fixtures/torch_port/dist_small.npz` freezes JAX's sharded GCN loss
and step, GAT forward and sharded submanifold conv at D = 4, so the card's
machine, which has no JAX, can hold the port to them
(`chip_smoke.py`'s dist phase); `test_dist_fixture_is_current` fails if
it drifted. Rewrite it with

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=. python tests/test_torch_dist_models.py
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import dgsparse_tpu_torch as pt
from dgsparse_tpu import SparseTensor
from dgsparse_tpu.dist import gat as jx_gat
from dgsparse_tpu.dist import gcn as jx_gcn
from dgsparse_tpu.dist import shard_csr
from dgsparse_tpu.dist.spconv import shard_pointcloud, spconv_sharded
from dgsparse_tpu.utils.testing import random_csr
from dgsparse_tpu_torch.dist import cases
from dgsparse_tpu_torch.dist.launch import run_ranks

FIXTURE = Path(__file__).parent / "fixtures" / "torch_port" / "dist_small.npz"
WORLD = 4
TOL = dict(rtol=1e-4, atol=1e-5)
GAT_STEPS = 150


def _mesh(d=WORLD):
    return Mesh(np.array(jax.devices()[:d]), ("graph",))


def _sp_jx(rowptr, col, values, m):
    return SparseTensor.from_csr(
        jnp.asarray(rowptr), jnp.asarray(col),
        None if values is None else jnp.asarray(values), sparse_sizes=(m, m))


def gcn_inputs(m=96, unlabelled=0):
    """`tests/test_dist.py::test_sharded_gcn_loss_matches_single_device`'s
    graph, features, labels and initial parameters; the first
    `unlabelled` rows get no label (y = -1)."""
    feat, classes = 12, 4
    rowptr, col, values = random_csr(m, m, avg_degree=4.0, seed=21,
                                     with_empty_rows=False)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((m, feat)).astype(np.float32)
    y = rng.integers(0, classes, m).astype(np.int32)
    y[:unlabelled] = -1
    params = jx_gcn.init_params(jax.random.key(3), feat, 16, classes)
    return dict(rowptr=rowptr, col=col, values=np.abs(values), shape=(m, m),
                x=x, y=y, params={k: np.asarray(v) for k, v in params.items()})


def gat_inputs():
    """`test_sharded_gat_trains`'s graph (no values), data and parameters."""
    m, heads, f_in, f_hid, classes = 96, 2, 12, 8, 3
    rowptr, col, _ = random_csr(m, m, avg_degree=5, seed=30,
                                with_empty_rows=False)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((m, f_in)).astype(np.float32)
    y = rng.integers(0, classes, m).astype(np.int32)
    params = jx_gat.init_params(jax.random.key(0), f_in, f_hid, classes,
                                heads)
    return dict(rowptr=rowptr, col=col, values=None, shape=(m, m), x=x, y=y,
                heads=heads,
                params={k: np.asarray(v) for k, v in params.items()})


def spconv_inputs():
    """`test_sharded_spconv_grads`'s cloud, features and kernel."""
    rng = np.random.default_rng(71)
    n, shape = 1200, (24, 16, 12)
    coords = np.unique(np.stack([
        np.zeros(n, np.int32),
        rng.integers(0, shape[0], n), rng.integers(0, shape[1], n),
        rng.integers(0, shape[2], n)], 1), axis=0).astype(np.int32)
    feats = rng.standard_normal((len(coords), 4)).astype(np.float32)
    kernel = rng.standard_normal((27, 4, 6)).astype(np.float32) * 0.2
    return dict(coords=coords, feats=feats, kernel=kernel,
                spatial_shape=shape)


def _jx_node_data(mesh, adj, x, y):
    row = NamedSharding(mesh, P("graph"))
    m_pad = adj.num_shards * adj.rows_per_shard
    xp = np.zeros((m_pad, x.shape[1]), np.float32)
    xp[:len(x)] = x
    yp = np.full((m_pad,), -1, np.int32)
    yp[:len(y)] = y
    mask = (yp >= 0).astype(np.float32)
    return tuple(jax.device_put(jnp.asarray(a), row) for a in (xp, yp, mask))


def jx_gcn_run(g, lr=1e-2):
    """(loss, step loss, params after one step) of JAX's sharded GCN."""
    mesh = _mesh()
    sp = _sp_jx(g["rowptr"], g["col"], g["values"], g["shape"][0])
    adj, x, y, mask = jx_gcn.prepare_inputs(mesh, sp, g["x"], g["y"], WORLD)
    params = {k: jnp.asarray(v) for k, v in g["params"].items()}
    loss = float(jx_gcn.loss_fn(params, adj, x, y, mask, mesh))
    new, step_loss = jx_gcn.make_train_step(mesh, adj, lr)(params, x, y,
                                                           mask)
    return loss, float(step_loss), {k: np.asarray(v) for k, v in new.items()}


def _jx_gat(g):
    mesh = _mesh()
    sp = _sp_jx(g["rowptr"], g["col"], None, g["shape"][0])
    adj = shard_csr(sp, WORLD)
    params = {k: jnp.asarray(v) for k, v in g["params"].items()}
    return mesh, adj, params, _jx_node_data(mesh, adj, g["x"], g["y"])


def jx_gat_forward(g):
    mesh, adj, params, (x, _, _) = _jx_gat(g)
    logits = jx_gat.forward(params, adj, x, mesh, g["heads"])
    return np.asarray(logits)[:g["shape"][0]]


def jx_spconv(s):
    """JAX's sharded conv on 4 slabs, back in the cloud's order."""
    mesh = _mesh()
    plan, order = shard_pointcloud(s["coords"], WORLD, 3,
                                   spatial_shape=s["spatial_shape"])
    xb = plan.to_block_layout(jnp.asarray(s["feats"][order]))
    xd = jax.device_put(xb, NamedSharding(mesh, P("graph")))
    out = np.asarray(plan.from_block_layout(
        spconv_sharded(plan, xd, jnp.asarray(s["kernel"]), mesh)))
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    return out[inv]


def make_dist_fixture() -> dict:
    g, a, s = gcn_inputs(), gat_inputs(), spconv_inputs()
    loss, step_loss, new = jx_gcn_run(g)
    fx = {"gcn_rowptr": g["rowptr"], "gcn_col": g["col"],
          "gcn_values": g["values"], "gcn_x": g["x"], "gcn_y": g["y"],
          "gcn_loss": np.float32(loss), "gcn_step_loss": np.float32(step_loss)}
    fx.update({f"gcn_param_{k}": v for k, v in g["params"].items()})
    fx.update({f"gcn_step_{k}": v for k, v in new.items()})
    fx.update({"gat_rowptr": a["rowptr"], "gat_col": a["col"],
               "gat_x": a["x"], "gat_y": a["y"],
               "gat_heads": np.int32(a["heads"]),
               "gat_logits": jx_gat_forward(a)})
    fx.update({f"gat_param_{k}": v for k, v in a["params"].items()})
    fx.update({f"spconv_{k}": np.asarray(v) for k, v in s.items()})
    fx["spconv_out"] = jx_spconv(s)
    return fx


@pytest.fixture(scope="module")
def fresh():
    """JAX's sharded results on the CPU mesh, computed once for the file."""
    return make_dist_fixture()


@pytest.fixture(scope="module")
def port():
    """The port's results on 4 gloo ranks, one run for the file."""
    rng = np.random.default_rng(34)
    m, heads, f = 80, 3, 8
    rowptr, col, _ = random_csr(m, m, avg_degree=4, seed=33,
                                with_empty_rows=False)
    local = dict(rowptr=rowptr, col=col, values=None, shape=(m, m),
                 h=rng.standard_normal((m, heads, f)).astype(np.float32),
                 sd=rng.standard_normal((m, heads)).astype(np.float32),
                 ss=rng.standard_normal((m, heads)).astype(np.float32))
    rng = np.random.default_rng(30)
    rowptr, col, _ = random_csr(96, 96, avg_degree=5.0, seed=31)
    vol = dict(rowptr=rowptr, col=col, values=None, shape=(96, 96),
               h=rng.standard_normal((96, 2, 8)).astype(np.float32),
               sd=rng.standard_normal((96, 2)).astype(np.float32),
               ss=rng.standard_normal((96, 2)).astype(np.float32))
    named = {"gcn": dict(op="gcn", lr=1e-2, steps=1, **gcn_inputs()),
             "gcn_edges": dict(op="gcn", lr=1e-2, steps=1, balance="edges",
                               **gcn_inputs()),
             "partial": dict(op="gcn", lr=1e-2, steps=1,
                             **gcn_inputs(90, 30)),
             "gat": dict(op="gat", lr=3e-2, steps=GAT_STEPS + 1,
                         **gat_inputs()),
             "local": dict(op="gat_aggregate", **local),
             "volume": dict(op="gat_aggregate", **vol)}
    res = run_ranks(cases.run_cases, WORLD, device="cpu", timeout_s=120,
                    args=(list(named.values()),))
    assert not any(r.jax_loaded for r in res)
    out = {name: [r.result[i] for r in res] for i, name in enumerate(named)}
    out["inputs"] = named
    return out


def _cat(blocks, key, m):
    return np.concatenate([b[key] for b in blocks])[:m]


def _close_params(got, want, rel=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=rel,
            atol=rel * float(np.abs(want[k]).max()), err_msg=k)


def test_sharded_gcn_loss_matches_jax_and_single_device(port, fresh):
    g = port["inputs"]["gcn"]
    got = [float(b["loss"]) for b in port["gcn"]]
    assert len(set(got)) == 1           # the global loss on every rank
    np.testing.assert_allclose(got[0], fresh["gcn_loss"], rtol=1e-5)
    # the same model on one process, the port's unsharded spmm
    sp = pt.SparseTensor.from_csr(g["rowptr"], g["col"],
                                  torch.from_numpy(g["values"]),
                                  sparse_sizes=g["shape"])
    p = {k: torch.tensor(v) for k, v in g["params"].items()}
    h = torch.relu(pt.spmm(sp, torch.from_numpy(g["x"]) @ p["w1"] + p["b1"]))
    logits = pt.spmm(sp, h @ p["w2"] + p["b2"])
    np.testing.assert_allclose(_cat(port["gcn"], "logits", 96),
                               logits.numpy(), **TOL)
    single = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(g["y"]).long())
    np.testing.assert_allclose(got[0], float(single), rtol=1e-5)


def test_sharded_gcn_step_matches_jax(port, fresh):
    new = {k: fresh[f"gcn_step_{k}"] for k in ("w1", "b1", "w2", "b2")}
    for b in port["gcn"]:
        np.testing.assert_allclose(float(b["losses"][0]),
                                   fresh["gcn_step_loss"], rtol=1e-5)
        _close_params(b["params"][0], new)


def test_edge_balanced_gcn_step_matches_jax(port, fresh):
    """balance="edges" lays the node blocks out as the block layout: the
    logits, the loss and the step are the row-balanced run's, JAX's."""
    new = {k: fresh[f"gcn_step_{k}"] for k in ("w1", "b1", "w2", "b2")}
    np.testing.assert_allclose(_cat(port["gcn_edges"], "logits", 96),
                               _cat(port["gcn"], "logits", 96), **TOL)
    for b in port["gcn_edges"]:
        np.testing.assert_allclose(float(b["loss"]), fresh["gcn_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(b["losses"][0]),
                                   fresh["gcn_step_loss"], rtol=1e-5)
        _close_params(b["params"][0], new)


def test_sharded_gcn_loss_is_the_global_masked_mean(port):
    """Shards with unequal labelled rows (30 unlabelled rows in the first
    shards, 90 rows padded to 4 x 23): the loss and the step are JAX's,
    where an average of per-rank means would not be."""
    loss, step_loss, new = jx_gcn_run(port["inputs"]["partial"])
    for b in port["partial"]:
        np.testing.assert_allclose(float(b["loss"]), loss, rtol=1e-5)
        np.testing.assert_allclose(float(b["losses"][0]), step_loss,
                                   rtol=1e-5)
        _close_params(b["params"][0], new)


def test_sharded_gat_forward_and_step_match_jax(port, fresh):
    g = port["inputs"]["gat"]
    np.testing.assert_allclose(_cat(port["gat"], "logits", 96),
                               fresh["gat_logits"], **TOL)
    mesh, adj, params, (x, y, mask) = _jx_gat(g)
    new, loss = jx_gat.make_train_step(mesh, adj, g["heads"], lr=3e-2)(
        params, x, y, mask)
    for b in port["gat"]:
        np.testing.assert_allclose(float(b["losses"][0]), float(loss),
                                   rtol=1e-5)
        _close_params(b["params"][0],
                      {k: np.asarray(v) for k, v in new.items()})


def test_sharded_gat_trains(port):
    losses = port["gat"][0]["losses"]
    # random labels: the bar is beating the uniform predictor (ln 3)
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert losses[-1] < np.log(3) - 0.02, losses[-1]


def test_sharded_gat_matches_local_softmax(port):
    """The sharded aggregation == the port's unsharded edge_softmax and
    multi-head SpMM, and == JAX's sharded aggregation."""
    c = port["inputs"]["local"]
    out = _cat(port["local"], "out", 80)
    sp = pt.SparseTensor.from_csr(c["rowptr"], c["col"], sparse_sizes=(80, 80))
    coo_row = np.repeat(np.arange(80), np.diff(c["rowptr"]))
    logits = torch.nn.functional.leaky_relu(
        torch.from_numpy(c["sd"][coo_row] + c["ss"][c["col"]]), 0.2)
    ref = pt.spmm_multihead(sp, pt.edge_softmax(sp, logits),
                            torch.from_numpy(c["h"]))
    np.testing.assert_allclose(out, ref.numpy(), **TOL)
    mesh = _mesh()
    adj = shard_csr(_sp_jx(c["rowptr"], c["col"], None, 80), WORLD)
    row = NamedSharding(mesh, P("graph"))
    jx = jx_gat.gat_aggregate_sharded(
        adj, *(jax.device_put(jnp.asarray(c[k]), row)
               for k in ("h", "sd", "ss")), mesh)
    np.testing.assert_allclose(out, np.asarray(jx)[:80], **TOL)


def test_sharded_gat_gathers_only_projected_features(port):
    """Per rank, one [n/D, H, F] feature gather and one [n/D, H] score
    gather: gathering raw inputs or edge tensors would blow the volume."""
    shard_n, h, f = 96 // WORLD, 2, 8
    for b in port["volume"]:
        assert b["volumes"] == {"all_gather": shard_n * h * f + shard_n * h
                                }, b["volumes"]
    c = port["inputs"]["volume"]
    sp = pt.SparseTensor.from_csr(c["rowptr"], c["col"], sparse_sizes=(96, 96))
    coo_row = np.repeat(np.arange(96), np.diff(c["rowptr"]))
    logits = torch.nn.functional.leaky_relu(
        torch.from_numpy(c["sd"][coo_row] + c["ss"][c["col"]]), 0.2)
    ref = pt.spmm_multihead(sp, pt.edge_softmax(sp, logits),
                            torch.from_numpy(c["h"]))
    # rows without edges (random_csr drops 5 %) give 0 on both sides
    np.testing.assert_allclose(_cat(port["volume"], "out", 96), ref.numpy(),
                               **TOL)


def test_dist_fixture_is_current(fresh):
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for k, v in fresh.items():
            if k in ("gcn_loss", "gcn_step_loss", "gat_logits",
                     "spconv_out") or k.startswith("gcn_step_"):
                # XLA on another CPU may vectorise the sums differently
                np.testing.assert_allclose(stored[k], v, rtol=1e-6,
                                           atol=1e-7, err_msg=k)
            else:
                np.testing.assert_array_equal(stored[k], v, err_msg=k)
                assert stored[k].dtype == v.dtype, k


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **make_dist_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
