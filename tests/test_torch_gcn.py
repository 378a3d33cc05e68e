"""The port's GCN forward against flax `GCN(algorithm=PALLAS_EDGE_TILE)`.

The JAX model runs the Pallas `segment_matmul` (interpret mode on the
CPU). Tolerance 1e-4: two dense products of depth <= 32 and two SpMMs,
each summed in another order on the two sides.

`tests/fixtures/torch_port/gcn_small.npz` freezes this comparison's inputs,
flax params and JAX output, so the card's machine, which has no JAX, can
hold the port to the JAX package. `test_fixture_is_current` regenerates it
and fails if it drifted; rewrite it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_gcn.py
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgsparse_tpu import Algorithm
from dgsparse_tpu.nn import gcn as jx_gcn
from dgsparse_tpu.utils.testing import random_csr
from dgsparse_tpu_torch.entry import CONFIGS, synthetic_graph
from dgsparse_tpu_torch.nn import gcn as pt_gcn

FIXTURE = Path(__file__).parent / "fixtures" / "torch_port" / "gcn_small.npz"
TOL = dict(rtol=1e-4, atol=1e-4)


def _edge_index(n, avg_degree, seed):
    rowptr, col, _ = random_csr(n, n, avg_degree=avg_degree, seed=seed,
                                with_empty_rows=False)
    coo_row = np.repeat(np.arange(n, dtype=np.int32), np.diff(rowptr))
    return np.stack([coo_row, col])


def make_gcn_fixture() -> dict:
    """Inputs, flax params and JAX output of a small GCN: 256 nodes,
    32 -> 16 -> 4, under Algorithm.PALLAS_EDGE_TILE."""
    n, fin, hidden, classes = 256, 32, 16, 4
    edge_index = _edge_index(n, 4.0, seed=3)
    rowptr, col, vals = jx_gcn.gcn_norm_from_edge_index(edge_index, n)
    adj = jx_gcn.get_gcn_dcsr_from_edge_index(edge_index, n)
    x = np.random.default_rng(4).standard_normal((n, fin)).astype(np.float32)
    model = jx_gcn.GCN(hidden, classes,
                       algorithm=Algorithm.PALLAS_EDGE_TILE)
    params = model.init(jax.random.key(0), jnp.asarray(x), adj)
    out = model.apply(params, jnp.asarray(x), adj)
    p = jax.tree.map(np.asarray, params)["params"]
    return {
        "edge_index": edge_index, "rowptr": rowptr, "col": col,
        "vals": vals, "x": x,
        "conv1_kernel": p["conv1"]["linear"]["kernel"],
        "conv1_bias": p["conv1"]["linear"]["bias"],
        "conv2_kernel": p["conv2"]["linear"]["kernel"],
        "conv2_bias": p["conv2"]["linear"]["bias"],
        "out": np.asarray(out),
    }


def _flax_params(fx) -> dict:
    return {"params": {
        f"conv{i}": {"linear": {"kernel": fx[f"conv{i}_kernel"],
                                "bias": fx[f"conv{i}_bias"]}}
        for i in (1, 2)}}


@pytest.fixture(scope="module")
def fresh():
    jax_backend = jax.default_backend()
    assert jax_backend == "cpu", jax_backend
    return make_gcn_fixture()


def test_port_gcn_matches_flax_edge_tile(fresh):
    n = fresh["x"].shape[0]
    adj = pt_gcn.get_gcn_dcsr_from_edge_index(fresh["edge_index"], n)
    model = pt_gcn.GCN(32, 16, 4)
    pt_gcn.load_flax_params(model, _flax_params(fresh)).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(fresh["x"]), adj)
    np.testing.assert_allclose(out.numpy(), fresh["out"], **TOL)


def test_fixture_is_current(fresh):
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for k, v in fresh.items():
            if k == "out":
                # XLA on another CPU may vectorize the sums differently
                np.testing.assert_allclose(stored[k], v, rtol=1e-6,
                                           atol=1e-7)
            else:
                np.testing.assert_array_equal(stored[k], v, err_msg=k)
                assert stored[k].dtype == v.dtype, k


@pytest.mark.parametrize("self_loops", [True, False])
def test_gcn_norm_is_bitwise_jax(self_loops):
    ei = _edge_index(300, 5.0, seed=9)
    ei[:, 5:9] = ei[:, :4]                        # duplicates are kept
    rng = np.random.default_rng(10)
    ei = ei[:, rng.permutation(ei.shape[1])]      # unsorted input
    for a, b in zip(pt_gcn.gcn_norm_from_edge_index(ei, 300, self_loops),
                    jx_gcn.gcn_norm_from_edge_index(ei, 300, self_loops)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_entry_graph_matches_jax_recipe():
    # the Cora-shaped graph of __graft_entry__._synthetic_graph
    cfg = CONFIGS["cora"]
    adj, x, _ = synthetic_graph("cora", device="cpu")
    n = cfg.num_nodes
    j = jx_gcn.get_gcn_dcsr_from_edge_index(
        _edge_index(n, cfg.avg_degree, seed=0), n)
    for name in ("rowptr", "col", "values"):
        np.testing.assert_array_equal(
            getattr(adj.storage, name)().numpy(),
            np.asarray(getattr(j.storage, name)()), err_msg=name)
    x_ref = np.random.default_rng(1).standard_normal((n, cfg.in_features))
    np.testing.assert_array_equal(x.numpy(), x_ref.astype(np.float32))


def test_load_flax_params_checks_shapes(fresh):
    with pytest.raises(ValueError):
        pt_gcn.load_flax_params(pt_gcn.GCN(32, 8, 4), _flax_params(fresh))


def test_dropout_only_in_training():
    adj, x, _ = synthetic_graph("cora", device="cpu")
    model = pt_gcn.GCN(128, 64, 7, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = model.eval()(x, adj), model.eval()(x, adj)
        torch.manual_seed(0)
        c = model.train()(x, adj)
    assert torch.equal(a, b) and not torch.equal(a, c)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    from dgsparse_tpu.kernels import pallas_spmm

    pallas_spmm.set_interpret(True)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **make_gcn_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
