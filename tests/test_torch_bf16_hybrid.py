"""The port's bf16 compute mode of the hybrid tiers against the JAX
package's `compute_dtype=bfloat16`.

In that mode the JAX package rounds the dense-cell blocks and the dense
operand to bf16, multiplies bf16 by bf16 and sums in float32
(`dgsparse_tpu/kernels/pallas_spmm.py::spmm_dense_cells`,
`pallas_sddmm.py::sddmm_cells`); `spmm` takes it for a bf16 `dense` (and
its `d_dense` for a bf16 cotangent) on a hybrid storage, `gat_attention`
on request. The port's kernels run their plain versions here, which round
the same way and multiply in float32 (a product of two bf16 values is
exact there).

Graphs: `tests/test_torch_hybrid.py::_pair(seed=32)` (row block 5 holds no
dense cell, so JAX's `spmm_dense_cells` leaves its rows NaN in interpret
mode: comparisons with it keep to the visited rows or columns, as
`_visited` marks them) and, for the attention, the graph and inputs of
`tests/fixtures/torch_port/attention_small.npz` (every row block has a
cell; its JAX edge-space gradients are kept current by
`test_torch_attention.py::test_attention_fixture_is_current`).

Tolerances, scaled by the terms' absolute sum (`assert_sum_close`): the
cell kernels at 1e-5 (the same bf16 products summed in another order);
`spmm`, its `d_dense`, `sddmm_hybrid` and the attention forward at 1e-2
(the tiers outside the cells round differently: JAX's BELL and residue
also round each product to bf16, `ops/hybrid.py` says why the port does
not); the attention's gradients at 1e-2 of each gradient's largest
magnitude.

`tests/fixtures/torch_port/bf16_hybrid_small.npz` freezes JAX's bf16-mode
`spmm` (SUM and MEAN, forward and `d_dense`) and `gat_attention` for the
card's machine, which has no JAX (`chip_smoke.py::phase_bf16_hybrid`);
`test_bf16_fixture_is_current` fails if it drifted. Rewrite it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bf16_hybrid.py
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.kernels.pallas_sddmm import sddmm_cells as jx_sddmm_cells
from dgsparse_tpu.kernels.pallas_sddmm import sddmm_hybrid as jx_sddmm_hybrid
from dgsparse_tpu.kernels.pallas_spmm import \
    spmm_dense_cells as jx_spmm_dense_cells
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.kernels import launch_counts, spmm_cells
from dgsparse_tpu_torch.ops import hybrid as pt_hybrid
from dgsparse_tpu_torch.ops.types import ReduceOp
from dgsparse_tpu_torch.utils.testing import assert_sum_close
from tests.test_torch_hybrid import N, _dense, _pair, _visited

FIXTURES = Path(__file__).parent / "fixtures" / "torch_port"
FIXTURE = FIXTURES / "bf16_hybrid_small.npz"
ATTENTION_FIXTURE = FIXTURES / "attention_small.npz"
BF16 = torch.bfloat16
SEED = 32
FEAT = 24
KERNEL_TOL = 1e-5
OP_TOL = 1e-2


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def _attention_inputs():
    with np.load(ATTENTION_FIXTURE) as fx:
        return {k: fx[k] for k in ("rowptr", "col", "s_row", "s_col", "x",
                                   "ct", "attn/grads/s_row",
                                   "attn/grads/s_col", "attn/grads/x")}


def make_bf16_fixture() -> dict:
    """The spmm graph, x and a cotangent; JAX's PALLAS_ROW_TILE `spmm` of a
    bf16 x (SUM, MEAN: the output and `d_dense` of `jnp.vdot(out, ct)`, as
    float32), and JAX's `gat_attention(..., compute_dtype=bfloat16)` on the
    attention fixture's graph and inputs."""
    _, j, (rowptr, col, vals) = _pair(seed=SEED)
    x, ct = _dense(SEED + 1, (N, FEAT), (N, FEAT))
    fx = {"rowptr": rowptr, "col": col, "vals": vals, "x": x, "ct": ct}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    for reduce in ("sum", "mean"):
        def loss(dense, reduce=reduce):
            out = jx.spmm(j, dense, reduce, jx.Algorithm.PALLAS_ROW_TILE)
            return jnp.vdot(out.astype(jnp.float32), jnp.asarray(ct)), out

        # jitted: eager interpret mode takes ~15x longer
        (_, out), d_x = jax.jit(jax.value_and_grad(loss, has_aux=True))(xb)
        assert out.dtype == d_x.dtype == jnp.bfloat16
        fx[f"spmm/{reduce}/out"] = np.asarray(out.astype(jnp.float32))
        fx[f"spmm/{reduce}/d_x"] = np.asarray(d_x.astype(jnp.float32))
    a = _attention_inputs()
    sp = jx.SparseTensor.from_csr(jnp.asarray(a["rowptr"]),
                                  jnp.asarray(a["col"]), None,
                                  sparse_sizes=(N, N))
    args = tuple(jnp.asarray(a[k]) for k in ("s_row", "s_col", "x"))
    out = jax.jit(lambda s, t, u: jx.gat_attention(
        sp, s, t, u, compute_dtype=jnp.bfloat16))(*args)
    fx["attn/out"] = np.asarray(out)
    assert np.isfinite(fx["attn/out"]).all()
    return fx


@pytest.fixture(scope="module")
def fresh():
    assert jax.default_backend() == "cpu", jax.default_backend()
    return make_bf16_fixture()


@pytest.fixture(scope="module")
def pair():
    return _pair(seed=SEED)


# --- the cell kernels (plain versions) ---------------------------------------

@pytest.mark.parametrize("feat", [7, FEAT])
@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_dense_cells_bf16_matches_jax(pair, feat, transpose):
    p, j, _ = pair
    pc, jc = p.storage.ell_plan().cells, j.storage.ell_plan().cells
    tiers = p.storage.tier_values(compute_dtype=BF16)
    (x,) = _dense(feat + 40, (N, feat))
    xt = torch.from_numpy(x)
    out = spmm_cells.spmm_dense_cells(pc, tiers["cells_bf16"], xt, transpose,
                                      BF16)
    # the fp32 blocks rounded by the wrapper: the same products
    again = spmm_cells.spmm_dense_cells(pc, tiers["cells"], xt, transpose,
                                        BF16)
    assert torch.equal(out, again)
    ref = np.asarray(jx_spmm_dense_cells(
        jc, jnp.asarray(tiers["cells"].numpy()), jnp.asarray(x),
        transpose=transpose, compute_dtype=jnp.bfloat16))
    abs_sum = spmm_cells.spmm_dense_cells(
        pc, tiers["cells_bf16"].float().abs(),
        torch.from_numpy(np.abs(_bf16_round(x))), transpose)
    rows = _visited((pc.cell_cw if transpose else pc.cell_rb).numpy(), N)
    assert out.dtype == torch.float32
    assert transpose or not rows.all()          # block 5 has no cell
    assert_sum_close(out[rows], torch.from_numpy(ref[rows]), abs_sum[rows],
                     KERNEL_TOL)
    assert not out[~rows].any()
    assert launch_counts()["spmm_dense_cells_bf16"] == 0


@pytest.mark.parametrize("feat", [7, FEAT])
def test_sddmm_cells_bf16_matches_jax(pair, feat):
    p, j, _ = pair
    d1, d2 = _dense(feat + 50, (N, feat), (N, feat))
    plan = p.storage.ell_plan().cells
    out = spmm_cells.sddmm_cells(plan, torch.from_numpy(d1),
                                 torch.from_numpy(d2), BF16)
    ref = jx_sddmm_cells(j.storage.ell_plan().cells, jnp.asarray(d1),
                         jnp.asarray(d2), compute_dtype=jnp.bfloat16)
    abs_sum = spmm_cells.sddmm_cells(
        plan, torch.from_numpy(np.abs(_bf16_round(d1))),
        torch.from_numpy(np.abs(_bf16_round(d2))))
    assert_sum_close(out, torch.from_numpy(np.array(ref)), abs_sum,
                     KERNEL_TOL)


# --- the ops ----------------------------------------------------------------

@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_spmm_bf16_matches_jax_row_tile(fresh, pair, reduce):
    p, _, (_, _, v) = pair
    xb = torch.from_numpy(fresh["x"]).to(BF16).requires_grad_()
    ct = torch.from_numpy(fresh["ct"])
    out = pt.spmm(p, xb, reduce)
    (out.float() * ct).sum().backward()
    assert out.dtype == xb.grad.dtype == BF16
    # the terms' absolute sums, forward and transpose, on the CSR route
    a_abs = p.set_values(torch.from_numpy(np.abs(v)))
    z = torch.zeros(N, FEAT, requires_grad=True)
    (pt.spmm(a_abs, z, reduce, pt.Algorithm.XLA_SEGMENT)
     * ct.abs()).sum().backward()
    fwd_abs = pt.spmm(a_abs, xb.detach().float().abs(), reduce,
                      pt.Algorithm.XLA_SEGMENT)
    hp = p.storage.ell_plan()
    rows = _visited(hp.cells.cell_rb.numpy(), N)
    cols = _visited(hp.cells.cell_cw.numpy(), N)
    assert_sum_close(out.detach()[rows],
                     torch.from_numpy(fresh[f"spmm/{reduce}/out"][rows]),
                     fwd_abs[rows], OP_TOL)
    assert_sum_close(xb.grad[cols],
                     torch.from_numpy(fresh[f"spmm/{reduce}/d_x"][cols]),
                     z.grad[cols], OP_TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_sddmm_hybrid_bf16_matches_jax(pair, reduce):
    p, j, (rowptr, _, _) = pair
    d1, d2 = _dense(60, (N, 20), (N, 20))
    out = pt_hybrid.sddmm_hybrid(p.storage, torch.from_numpy(d1),
                                 torch.from_numpy(d2), ReduceOp(reduce), BF16)
    degrees = jnp.asarray(np.diff(rowptr))
    coo_row = jnp.asarray(np.repeat(np.arange(N), np.diff(rowptr)))
    ref = jx_sddmm_hybrid(j.storage.ell_plan(), jnp.asarray(d1),
                          jnp.asarray(d2), jx.ReduceOp(reduce), degrees,
                          coo_row, compute_dtype=jnp.bfloat16)
    abs_sum = pt_hybrid.sddmm_hybrid(
        p.storage, torch.from_numpy(np.abs(d1)), torch.from_numpy(np.abs(d2)),
        ReduceOp(reduce))
    assert_sum_close(out, torch.from_numpy(np.array(ref)), abs_sum, OP_TOL)


def _attention(a, compute_dtype):
    sp = pt.SparseTensor.from_csr(a["rowptr"], a["col"], None,
                                  sparse_sizes=(N, N))
    assert sp.storage.ell_plan() is not None
    inputs = [torch.from_numpy(a[k]).requires_grad_()
              for k in ("s_row", "s_col", "x")]
    out = pt.gat_attention(sp, *inputs, compute_dtype=compute_dtype)
    grads = torch.autograd.grad((out * torch.from_numpy(a["ct"])).sum(),
                                inputs)
    return sp, inputs, out.detach(), grads


def test_gat_attention_bf16_matches_jax(fresh):
    a = _attention_inputs()
    sp, inputs, out, grads = _attention(a, BF16)
    # the terms' absolute sum: the same softmax weights over |x|
    abs_sum = pt.gat_attention(sp, inputs[0].detach(), inputs[1].detach(),
                               inputs[2].detach().abs())
    assert_sum_close(out, torch.from_numpy(fresh["attn/out"]), abs_sum,
                     OP_TOL)
    _, _, out32, grads32 = _attention(a, torch.float32)
    assert not torch.equal(out, out32)      # the mode ran
    assert_sum_close(out, out32, abs_sum, OP_TOL)
    for name, g, g32 in zip(("s_row", "s_col", "x"), grads, grads32):
        for ref in (g32, torch.from_numpy(a[f"attn/grads/{name}"])):
            scale = float(ref.abs().max())
            err = float((g - ref).abs().max())
            assert err <= OP_TOL * scale, (name, err, scale)


def test_gat_attention_refuses_other_compute_dtypes():
    a = _attention_inputs()
    sp = pt.SparseTensor.from_csr(a["rowptr"], a["col"], None,
                                  sparse_sizes=(N, N))
    args = [torch.from_numpy(a[k]) for k in ("s_row", "s_col", "x")]
    with pytest.raises(ValueError):
        pt.gat_attention(sp, *args, compute_dtype=torch.float16)


# --- the twin and the routing ------------------------------------------------

@pytest.mark.parametrize("change", ["in_place", "set_values", "ones"])
def test_bf16_twin_follows_the_values(change):
    p, _, (_, _, v) = _pair(seed=SEED + 4)
    ones = change == "ones"
    if ones:
        p = p.set_values(None)
    st = p.storage
    tiers = st.tier_values(ones=ones)
    assert tiers["cells_bf16"] is None          # lazily built
    twin = st.tier_values(ones=ones, compute_dtype=BF16)["cells_bf16"]
    assert twin.dtype == BF16
    assert torch.equal(twin, tiers["cells"].to(BF16))
    assert st.tier_values(ones=ones, compute_dtype=BF16)["cells_bf16"] \
        is twin                                 # kept
    if ones:
        return
    if change == "in_place":
        st.values().mul_(3.0)
    else:
        p = p.set_values(torch.from_numpy(v * 3.0))
        st = p.storage
    new = st.tier_values(compute_dtype=BF16)
    assert new["cells_bf16"] is not twin
    assert torch.equal(new["cells_bf16"], new["cells"].to(BF16))
    assert not torch.equal(new["cells_bf16"], twin)


def test_bf16_operands_run_the_twin_and_fp32_never_does(monkeypatch, pair):
    p, _, _ = pair
    calls = []
    real = spmm_cells.spmm_dense_cells_plain

    def recorded(plan, cells, dense, transpose=False,
                 compute_dtype=torch.float32):
        calls.append((cells, compute_dtype))
        return real(plan, cells, dense, transpose, compute_dtype)

    monkeypatch.setattr(spmm_cells, "spmm_dense_cells_plain", recorded)
    (x,) = _dense(70, (N, 16))

    def fwd_bwd(dtype):
        calls.clear()
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        pt.spmm(p, xt).float().sum().backward()
        return list(calls)

    for cells, cd in fwd_bwd(torch.float32):
        assert cd == torch.float32 and cells.dtype == torch.float32
    twin = p.storage.tier_values(compute_dtype=BF16)["cells_bf16"]
    seen = fwd_bwd(BF16)
    assert len(seen) == 2                       # forward and d_dense
    for cells, cd in seen:
        assert cd == BF16 and cells is twin
    a = _attention_inputs()
    for cd in (torch.float32, BF16):
        calls.clear()
        _attention(a, cd)
        # forward, d_x, d_s_row, d_s_col: only the first two in bf16
        assert [c for _, c in calls] == [cd, cd, torch.float32,
                                         torch.float32]
    assert launch_counts()["spmm_dense_cells_bf16"] == 0


def test_bf16_fixture_is_current(fresh):
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for k, v in fresh.items():
            if k.startswith(("spmm/", "attn/")):
                np.testing.assert_allclose(
                    stored[k], v, rtol=1e-5,
                    atol=1e-6 * float(np.nanmax(np.abs(v))), err_msg=k)
            else:
                np.testing.assert_array_equal(stored[k], v, err_msg=k)
                assert stored[k].dtype == v.dtype, k


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    from dgsparse_tpu.kernels import pallas_spmm

    pallas_spmm.set_interpret(True)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **make_bf16_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
