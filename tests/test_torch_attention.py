"""The port's fused slot-space GAT attention (`ops/attention.py`) and
GATConv's slot branch against the JAX package and a numpy oracle.

The graph is `utils/testing.py::hybrid_csr` with every row block holding a
dense cell (the JAX dense-cell kernel leaves a block without one
unwritten, NaN in interpret mode): 1500 nodes, duplicate edges, every
17th row empty; both packages build a hybrid plan. The JAX forward is its
`gat_attention` (the Pallas tier kernels in interpret mode). Its hybrid
gradient cannot be taken (the custom VJP returns a scalar cotangent for
the cells' multiplicity array, `dgsparse_tpu/ops/attention.py:62-63,
255`, and `jax.grad` raises), so the port's gradients are held to JAX's
`_edge_space_attention`, to the port's own edge route and, through the
forward, to the numpy oracle of `tests/test_attention.py`.

Tolerances as in `tests/test_attention.py`: forwards at 2e-4, gradients
at 2e-3; GATConv's forward at 1e-4 as in `tests/test_torch_gat.py`.

JAX's GATConv raises on any hybrid-planned storage (`st.nnz()` on an int
property, `dgsparse_tpu/nn/gat.py:48`), so its output comes from the same
graph built without plans, where it takes its edge branch.

`tests/fixtures/torch_port/attention_small.npz` freezes the JAX forward
and edge-space gradients, and one GATConv's flax params and output, for
the card's machine, which has no JAX; `test_attention_fixture_is_current`
fails if it drifted. Rewrite it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_attention.py
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import dgsparse_tpu as jx
from dgsparse_tpu.core.planner import HybridPlan
from dgsparse_tpu.nn import gat as jx_gat
from dgsparse_tpu.ops.attention import \
    _edge_space_attention as jx_edge_attention
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.nn import gat as pt_gat
from dgsparse_tpu_torch.ops.attention import _edge_space_attention
from dgsparse_tpu_torch.utils.testing import (fixture_gatconv, hybrid_csr,
                                              random_csr)
from tests.test_attention import clustered_csr, oracle

FIXTURE = Path(__file__).parent / "fixtures" / "torch_port" / \
    "attention_small.npz"
N, F = 1500, 16
CONV = (24, 8, 4)           # GATConv in features, out features, heads
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)


def _graph():
    return hybrid_csr(seed=40, sparse_block=None)[:2]


def make_attention_fixture() -> dict:
    """The graph, the scores, features and a cotangent; JAX's
    `gat_attention` forward (the hybrid route) and the gradients of
    `jnp.vdot(_edge_space_attention(...), ct)`; a GATConv's flax params,
    input and output."""
    rowptr, col = _graph()
    sp = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                  None, sparse_sizes=(N, N))
    assert isinstance(sp.storage.ell_plan(), HybridPlan)
    rng = np.random.default_rng(41)
    fx = {"rowptr": rowptr, "col": col,
          "s_row": rng.standard_normal(N).astype(np.float32),
          "s_col": rng.standard_normal(N).astype(np.float32),
          "x": rng.standard_normal((N, F)).astype(np.float32),
          "ct": rng.standard_normal((N, F)).astype(np.float32)}
    args = tuple(jnp.asarray(fx[k]) for k in ("s_row", "s_col", "x"))
    out = jax.jit(lambda a, b, c: jx.gat_attention(sp, a, b, c))(*args)
    fx["attn/out"] = np.asarray(out)
    assert np.isfinite(fx["attn/out"]).all()

    def loss(a, b, c):
        return jnp.vdot(jx_edge_attention(sp, a, b, c, 0.2),
                        jnp.asarray(fx["ct"]))

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    for name, g in zip(("s_row", "s_col", "x"), grads):
        fx[f"attn/grads/{name}"] = np.asarray(g)
    # JAX's GATConv raises on a hybrid-planned storage (it calls the int
    # `Storage.nnz`, `dgsparse_tpu/nn/gat.py:48`): its edge branch runs on
    # the same graph without plans
    plain = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                     None, sparse_sizes=(N, N),
                                     build_plans=False)
    fin, out_f, heads = CONV
    fx["gat/dims"] = np.asarray(CONV, np.int32)
    fx["gat/x"] = rng.standard_normal((N, fin)).astype(np.float32)
    conv = jx_gat.GATConv(out_f, heads)
    params = conv.init(jax.random.key(4), jnp.asarray(fx["gat/x"]), plain)
    for k, v in params["params"].items():
        name = "proj/kernel" if k == "proj" else k
        fx[f"gat/params/{name}"] = np.asarray(v["kernel"] if k == "proj"
                                              else v)
    fx["gat/out"] = np.asarray(conv.apply(params, jnp.asarray(fx["gat/x"]),
                                          plain))
    return fx


@pytest.fixture(scope="module")
def fresh():
    assert jax.default_backend() == "cpu", jax.default_backend()
    return make_attention_fixture()


def _port(fx):
    sp = pt.SparseTensor.from_csr(fx["rowptr"], fx["col"], None,
                                  sparse_sizes=(N, N))
    assert sp.storage.ell_plan() is not None
    return sp


def _inputs(fx):
    return [torch.from_numpy(fx[k]).requires_grad_()
            for k in ("s_row", "s_col", "x")]


def _grads(out, ct, inputs):
    return torch.autograd.grad((out * torch.from_numpy(ct)).sum(), inputs)


def test_forward_matches_the_oracle_and_jax(fresh):
    sp = _port(fresh)
    out = pt.gat_attention(sp, *_inputs(fresh)).detach().numpy()
    ref = oracle(fresh["rowptr"], fresh["col"], fresh["s_row"],
                 fresh["s_col"], fresh["x"])
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    np.testing.assert_allclose(out, fresh["attn/out"], **FWD_TOL)
    empty = np.diff(fresh["rowptr"]) == 0
    assert empty.any() and not out[empty].any()       # empty rows give 0


def test_grads_match_the_edge_route_and_jax(fresh):
    sp = _port(fresh)
    inputs = _inputs(fresh)
    got = _grads(pt.gat_attention(sp, *inputs), fresh["ct"], inputs)
    edge = _grads(_edge_space_attention(sp, *inputs, 0.2), fresh["ct"],
                  inputs)
    for name, g, e in zip(("s_row", "s_col", "x"), got, edge):
        np.testing.assert_allclose(g.numpy(), e.numpy(), **GRAD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), fresh[f"attn/grads/{name}"],
                                   **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("feat", [8, 24])
def test_duplicates_and_empty_rows_on_the_test_attention_graph(feat):
    # tests/test_attention.py's graph: duplicate edges (columns drawn with
    # replacement), every 17th row empty; forward against the oracle,
    # gradients against the port's edge route
    rowptr, col = clustered_csr(seed=21)
    sp = pt.SparseTensor.from_csr(rowptr, col, None, sparse_sizes=(N, N))
    assert sp.storage.ell_plan() is not None
    coo = np.repeat(np.arange(N), np.diff(rowptr))
    assert len(np.unique(coo * N + col)) < len(col)    # duplicates
    rng = np.random.default_rng(feat)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (
        rng.standard_normal(N).astype(np.float32),
        rng.standard_normal(N).astype(np.float32),
        rng.standard_normal((N, feat)).astype(np.float32))]
    ct = rng.standard_normal((N, feat)).astype(np.float32)
    out = pt.gat_attention(sp, *inputs)
    ref = oracle(rowptr, col, *(t.detach().numpy() for t in inputs))
    np.testing.assert_allclose(out.detach().numpy(), ref, **FWD_TOL)
    assert not out[torch.from_numpy(np.diff(rowptr) == 0)].any()
    edge = _edge_space_attention(sp, *inputs, 0.2)
    for g, e in zip(_grads(out, ct, inputs), _grads(edge, ct, inputs)):
        np.testing.assert_allclose(g.numpy(), e.numpy(), **GRAD_TOL)


def test_plain_storage_falls_back_to_the_edge_route():
    rowptr, col, _ = random_csr(400, 400, avg_degree=5.0, seed=4)
    sp = pt.SparseTensor.from_csr(rowptr, col, None, sparse_sizes=(400, 400))
    assert sp.storage.ell_plan() is None
    rng = np.random.default_rng(5)
    s_row, s_col = (rng.standard_normal(400).astype(np.float32)
                    for _ in range(2))
    x = rng.standard_normal((400, 8)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (s_row, s_col, x)]
    out = pt.gat_attention(sp, *args)
    torch.testing.assert_close(out, _edge_space_attention(sp, *args, 0.2),
                               rtol=0, atol=0)
    np.testing.assert_allclose(out.numpy(),
                               oracle(rowptr, col, s_row, s_col, x),
                               rtol=1e-4, atol=1e-4)


class _Sizes(TorchDispatchMode):
    """The shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes += [tuple(t.shape) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
        return out


def test_the_hybrid_route_builds_no_edge_order_tensor(fresh):
    # no op of the forward or the backward returns a tensor with a
    # dimension of nnz (one value per edge in CSR order); the edge route
    # does
    sp = _port(fresh)
    inputs = _inputs(fresh)
    pt.gat_attention(sp, *inputs)         # the slot maps are built once
    for fn, expect in ((pt.gat_attention, False),
                       (lambda *a: _edge_space_attention(*a, 0.2), True)):
        with _Sizes() as sizes:
            _grads(fn(sp, *inputs), fresh["ct"], inputs)
        assert any(sp.nnz in s for s in sizes.shapes) == expect


def test_gatconv_slot_branch_matches_jax_and_the_edge_branch(fresh,
                                                             monkeypatch):
    # with the gate lowered below the graph's edges, GATConv runs
    # gat_attention once a head; held to JAX's GATConv (its edge branch)
    # and to the port's edge branch, forward and gradients
    sp = _port(fresh)
    conv, x = fixture_gatconv(fresh, "cpu")
    ct = np.random.default_rng(6).standard_normal(
        fresh["gat/out"].shape).astype(np.float32)
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return pt.gat_attention(*args, **kw)

    def run():
        conv.zero_grad()
        out = conv(x, sp)
        (out * torch.from_numpy(ct)).sum().backward()
        return out.detach(), [p.grad.clone() for p in conv.parameters()]

    monkeypatch.setattr(pt_gat, "gat_attention", counted)
    edge_out, edge_grads = run()
    assert not calls                      # below the 2^21-edge gate
    monkeypatch.setattr(pt_gat, "GAT_SLOT_MIN_NNZ", sp.nnz)
    slot_out, slot_grads = run()
    assert len(calls) == CONV[2]          # one call a head
    np.testing.assert_allclose(slot_out.numpy(), fresh["gat/out"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(slot_out.numpy(), edge_out.numpy(),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(slot_grads, edge_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_attention_fixture_is_current(fresh):
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for k, v in fresh.items():
            if k.startswith(("attn/out", "attn/grads", "gat/out")):
                np.testing.assert_allclose(
                    stored[k], v, rtol=1e-5,
                    atol=1e-6 * float(np.abs(v).max()), err_msg=k)
            else:
                np.testing.assert_array_equal(stored[k], v, err_msg=k)
                assert stored[k].dtype == v.dtype, k


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    from dgsparse_tpu.kernels import pallas_spmm

    pallas_spmm.set_interpret(True)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **make_attention_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
