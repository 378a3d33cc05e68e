"""The port's slot-space ops (`ops/slot.py`) against the JAX package's.

The graphs are those of `tests/test_slot.py`: a 900 x 800 random CSR
(`make_ell`: the JAX package gives it a bucketed-ELL plan, the port no
hybrid plan, so its "plain" layout, every edge in `ell` in CSR order) and
the 1500-node community-clustered CSR without duplicate edges
(`make_hybrid`: both packages build a hybrid plan). The layouts differ, so
the two packages meet at the edge boundary: `slots_to_edges` of each
result, and `edges_to_slots` of the same edge values fed to both. The JAX
functions run as `tests/test_slot.py` runs them (the Pallas kernels in
interpret mode), each package's forward and gradient calls jitted once
per graph. Edge values are drawn from a normal distribution: no ties for
MAX/MIN.

Tolerances as in `tests/test_slot.py`: forwards at 1e-4 (2e-4 for the
semiring grid), the chain's gradients at 2e-3, the SpMM's at 1e-3, the
round trip exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgsparse_tpu as jx
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.ops import slot as S
from dgsparse_tpu_torch.utils.testing import hybrid_csr
from tests.test_slot import make_ell, make_hybrid

REDUCES = ("sum", "mean", "max", "min")
COMPUTES = ("add", "sub", "mul", "div")
KINDS = ("plain", "hybrid")


def _graph(kind):
    return make_ell(3) if kind == "plain" else make_hybrid(3)


def _jax_run(kind):
    """Every JAX result the tests compare with, on one graph: forwards in
    one jitted call, gradients of `jnp.vdot(out, ct)` in another."""
    sp, rowptr, col, d1, d2 = _graph(kind)
    m, n = sp.sparse_sizes()
    f = d1.shape[1]
    rng = np.random.default_rng(5)
    inp = {"d1": d1, "d2": d2,
           "x": rng.standard_normal((n, f)).astype(np.float32),
           "v": rng.standard_normal(sp.nnz).astype(np.float32),
           "vpos": rng.uniform(0.5, 1.5, sp.nnz).astype(np.float32),
           "ct": rng.standard_normal((m, f)).astype(np.float32),
           "ct_e": rng.standard_normal(sp.nnz).astype(np.float32)}
    a = {k: jnp.asarray(v) for k, v in inp.items()}

    @jax.jit
    def forward(a):
        sv = jx.sddmm_slots(sp, a["d1"], a["d2"])
        soft = jx.edge_softmax_slots(sp, sv)
        vs = jx.edges_to_slots(sp, a["v"])
        out = {"sddmm": jx.slots_to_edges(sp, sv),
               "softmax": jx.slots_to_edges(sp, soft),
               "chain": jx.spmm_slots(sp, soft, a["x"]),
               "roundtrip": jx.slots_to_edges(sp, vs)}
        for r in REDUCES:
            out[f"spmm/{r}"] = jx.spmm_slots(sp, vs, a["x"], r)
            # the slot grid on the hybrid layout (on the plain one the
            # port's grid is the edge-order gspmm, held to JAX's by
            # tests/test_torch_gspmm.py)
            for c in COMPUTES if kind == "hybrid" else ():
                w = jx.edges_to_slots(sp, a["vpos"]) if c == "div" else vs
                out[f"gspmm/{r}/{c}"] = jx.gspmm(sp, a["x"], r, c, values=w)
        return out

    @jax.jit
    def grads(a):
        def chain(d1, d2, x):
            sv = jx.sddmm_slots(sp, d1, d2)
            out = jx.spmm_slots(sp, jx.edge_softmax_slots(sp, sv), x)
            return jnp.vdot(out, a["ct"])

        def sddmm(d1, d2):
            return jnp.vdot(jx.slots_to_edges(
                sp, jx.sddmm_slots(sp, d1, d2)), a["ct_e"])

        def softmax(v):
            soft = jx.edge_softmax_slots(sp, jx.edges_to_slots(sp, v))
            return jnp.vdot(jx.slots_to_edges(sp, soft), a["ct_e"])

        out = {"chain": jax.grad(chain, (0, 1, 2))(a["d1"], a["d2"],
                                                   a["x"]),
               "sddmm": jax.grad(sddmm, (0, 1))(a["d1"], a["d2"]),
               "softmax": jax.grad(softmax)(a["v"])}
        for r in REDUCES:
            out[f"spmm/{r}"] = jax.grad(
                lambda v, x, r=r: jnp.vdot(jx.spmm_slots(
                    sp, jx.edges_to_slots(sp, v), x, r), a["ct"]),
                (0, 1))(a["v"], a["x"])
        return out

    ref = {**forward(a), **{f"grad/{k}": v for k, v in grads(a).items()}}
    ref = jax.tree.map(np.asarray, ref)
    port = pt.SparseTensor.from_csr(rowptr, col, None, sparse_sizes=(m, n))
    assert (port.storage.ell_plan() is not None) == (kind == "hybrid")
    return port, inp, ref


@pytest.fixture(scope="module", params=KINDS)
def run(request):
    return _jax_run(request.param)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol, err_msg=msg)


def test_sddmm_slots_matches_jax(run):
    sp, inp, ref = run
    d1, d2 = _t(inp["d1"], True), _t(inp["d2"], True)
    sv = pt.sddmm_slots(sp, d1, d2)
    e = pt.slots_to_edges(sp, sv)
    _close(e, ref["sddmm"], 1e-4)
    for g, r in zip(torch.autograd.grad((e * _t(inp["ct_e"])).sum(),
                                        (d1, d2)), ref["grad/sddmm"]):
        _close(g, r, 1e-3)


def test_edge_softmax_slots_matches_jax(run):
    sp, inp, ref = run
    v = _t(inp["v"], True)
    soft = pt.edge_softmax_slots(sp, pt.edges_to_slots(sp, v))
    e = pt.slots_to_edges(sp, soft)
    # the JAX reference softmaxes the dots; this one the edge values
    sv = pt.sddmm_slots(sp, _t(inp["d1"]), _t(inp["d2"]))
    _close(pt.slots_to_edges(sp, pt.edge_softmax_slots(sp, sv)),
           ref["softmax"], 1e-4)
    (g,) = torch.autograd.grad((e * _t(inp["ct_e"])).sum(), v)
    _close(g, ref["grad/softmax"], 1e-3)


@pytest.mark.parametrize("reduce", REDUCES)
def test_spmm_slots_matches_jax(run, reduce):
    sp, inp, ref = run
    v, x = _t(inp["v"], True), _t(inp["x"], True)
    out = pt.spmm_slots(sp, pt.edges_to_slots(sp, v), x, reduce)
    _close(out, ref[f"spmm/{reduce}"], 1e-4)
    grads = torch.autograd.grad((out * _t(inp["ct"])).sum(), (v, x))
    for g, r, name in zip(grads, ref[f"grad/spmm/{reduce}"], ("v", "x")):
        _close(g, r, 1e-3, name)


def test_full_chain_matches_jax(run):
    # sddmm_slots -> edge_softmax_slots -> spmm_slots, forward and
    # gradients, also equal to the port's own edge-order chain
    sp, inp, ref = run
    d1, d2, x = (_t(inp[k], True) for k in ("d1", "d2", "x"))
    ct = _t(inp["ct"])
    out = pt.spmm_slots(sp, pt.edge_softmax_slots(
        sp, pt.sddmm_slots(sp, d1, d2)), x)
    edge = pt.spmm(sp.set_values(pt.edge_softmax(sp, pt.sddmm(sp, d1, d2))),
                   x)
    _close(out, ref["chain"], 1e-4)
    _close(out, edge.detach().numpy(), 1e-4)
    grads = torch.autograd.grad((out * ct).sum(), (d1, d2, x))
    edge_grads = torch.autograd.grad((edge * ct).sum(), (d1, d2, x))
    for g, r, e in zip(grads, ref["grad/chain"], edge_grads):
        _close(g, r, 2e-3)
        _close(g, e.numpy(), 2e-3)


def test_boundary_roundtrip(run):
    sp, inp, ref = run
    v = _t(inp["v"])
    back = pt.slots_to_edges(sp, pt.edges_to_slots(sp, v))
    np.testing.assert_array_equal(back.numpy(), inp["v"])
    np.testing.assert_array_equal(ref["roundtrip"], inp["v"])


def test_gspmm_slot_grid_matches_jax(run):
    # the whole semiring grid with slot-space values against the port's
    # edge-order gspmm on the same values and, on the hybrid layout,
    # against JAX's slot grid
    sp, inp, ref = run
    x = _t(inp["x"])
    for r in REDUCES:
        for c in COMPUTES:
            v = _t(inp["vpos"] if c == "div" else inp["v"])
            got = pt.gspmm(sp, x, r, c, values=pt.edges_to_slots(sp, v))
            if sp.storage.ell_plan() is not None:
                _close(got, ref[f"gspmm/{r}/{c}"], 2e-4, f"{r} {c}")
            edge = pt.gspmm(sp.set_values(v), x, r, c)
            _close(got, edge.numpy(), 2e-4, f"{r} {c} (edge order)")


def test_public_entries_take_slot_values(run):
    # edge_softmax on SlotValues gives SlotValues; spmm_multihead on a
    # list of them is one spmm_slots a head, stacked
    sp, inp, ref = run
    sv = pt.sddmm_slots(sp, _t(inp["d1"]), _t(inp["d2"]))
    soft = pt.edge_softmax(sp, sv)
    assert isinstance(soft, pt.SlotValues)
    _close(pt.slots_to_edges(sp, soft), ref["softmax"], 1e-4)
    other = pt.edges_to_slots(sp, _t(inp["v"]))
    rng = np.random.default_rng(7)
    xh = torch.from_numpy(rng.standard_normal(
        (sp.sparse_sizes()[1], 2, inp["x"].shape[1])).astype(np.float32))
    for reduce in ("sum", "max"):
        out = pt.spmm_multihead(sp, [soft, other], xh, reduce)
        assert out.shape == (sp.sparse_sizes()[0], 2, xh.shape[2])
        for h, w in enumerate((soft, other)):
            torch.testing.assert_close(
                out[:, h], pt.spmm_slots(sp, w, xh[:, h].contiguous(),
                                         reduce), rtol=0, atol=0)
    with pytest.raises(TypeError):
        pt.spmm_multihead(sp, [soft, None], xh)


def test_duplicate_edges_share_their_cell_position():
    # on a graph with duplicate edges the dots of sddmm_slots, and a SpMM
    # over values that agree on duplicates, equal the edge-order ops: the
    # cells' multiplicity adds each duplicate once
    rowptr, col, _ = hybrid_csr(seed=4)
    n = len(rowptr) - 1
    sp = pt.SparseTensor.from_csr(rowptr, col, None, sparse_sizes=(n, n))
    assert sp.storage.ell_plan() is not None
    assert int(sp.storage.tier_values(ones=True)["cells"].max()) > 1
    rng = np.random.default_rng(8)
    d1, d2, x = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((n, 12), (n, 12), (n, 12)))
    sv = pt.sddmm_slots(sp, d1, d2)
    torch.testing.assert_close(pt.slots_to_edges(sp, sv), pt.sddmm(sp, d1, d2),
                               rtol=1e-5, atol=1e-5)
    coo = np.repeat(np.arange(n), np.diff(rowptr))
    v = torch.from_numpy((((coo * 7919 + col) % 101) / 101.0 - 0.5).astype(
        np.float32))
    for reduce in ("sum", "mean"):
        torch.testing.assert_close(
            pt.spmm_slots(sp, pt.edges_to_slots(sp, v), x, reduce),
            pt.spmm(sp.set_values(v), x, reduce), rtol=1e-4, atol=1e-4)


def test_plain_layout_without_plans():
    # a storage built without plans keeps every edge in `ell`: the slot
    # ops are the edge-order ones (the JAX package refuses it)
    rowptr, col, _ = hybrid_csr(seed=9)
    n = len(rowptr) - 1
    sp = pt.SparseTensor.from_csr(rowptr, col, None, sparse_sizes=(n, n),
                                  build_plans=False)
    rng = np.random.default_rng(10)
    d1, d2 = (torch.from_numpy(rng.standard_normal((n, 8)).astype(
        np.float32)) for _ in range(2))
    sv = pt.sddmm_slots(sp, d1, d2)
    assert sv.cells is None and sv.bell is None and sv.ell.shape == (sp.nnz,)
    torch.testing.assert_close(pt.slots_to_edges(sp, sv), pt.sddmm(sp, d1, d2))
    assert pt.edges_to_slots(sp, sv.ell).ell is sv.ell
    with pytest.raises(ValueError):
        S.spmm_slots(sp, sv, d1[:10])


def test_caches_made_in_inference_mode_serve_autograd():
    # a served forward (inference mode) builds the storage's ones' tiers
    # and slot maps; a later training call saves them for backward
    rowptr, col, _ = hybrid_csr(seed=11)
    n = len(rowptr) - 1
    sp = pt.SparseTensor.from_csr(rowptr, col, None, sparse_sizes=(n, n))
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    with torch.inference_mode():
        pt.gat_attention(sp, s, s, x)
        pt.edges_to_slots(sp, torch.zeros(sp.nnz))
    v = torch.from_numpy(rng.standard_normal(sp.nnz).astype(
        np.float32)).requires_grad_()
    soft = pt.edge_softmax_slots(sp, pt.edges_to_slots(sp, v))
    pt.spmm_slots(sp, soft, x).sum().backward()
    assert torch.isfinite(v.grad).all() and v.grad.abs().max() > 0


def test_a_plan_without_a_bell_tier():
    # a clustered graph whose dense cells leave no cell for BELL: the slot
    # ops and the attention run on cells and residue alone
    from dgsparse_tpu_torch.ops.attention import _edge_space_attention

    rowptr, col, _ = hybrid_csr(deg=60, comm=128, intra=0.95,
                                sparse_block=None)
    n = len(rowptr) - 1
    sp = pt.SparseTensor.from_csr(rowptr, col, None, sparse_sizes=(n, n))
    hp = sp.storage.ell_plan()
    assert hp.cells is not None and hp.bell is None and hp.res.nnz
    rng = np.random.default_rng(13)
    d1, d2, x = (torch.from_numpy(rng.standard_normal((n, 8)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    ct = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    slot = pt.spmm_slots(sp, pt.edge_softmax_slots(
        sp, pt.sddmm_slots(sp, d1, d2)), x)
    edge = pt.spmm(sp.set_values(pt.edge_softmax(sp, pt.sddmm(sp, d1, d2))),
                   x)
    attn = pt.gat_attention(sp, d1[:, 0], d2[:, 0], x)
    attn_edge = _edge_space_attention(sp, d1[:, 0], d2[:, 0], x, 0.2)
    for a, b in ((slot, edge), (attn, attn_edge)):
        _close(a, b.detach().numpy(), 1e-4)
        for g, e in zip(torch.autograd.grad((a * ct).sum(), (d1, d2, x)),
                        torch.autograd.grad((b * ct).sum(), (d1, d2, x))):
            _close(g, e.numpy(), 2e-3)
