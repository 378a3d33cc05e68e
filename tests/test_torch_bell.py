"""The port's BELL plan and BELL SpMM (plain version on the CPU) against the
JAX package's `build_bell_plan` and Pallas `spmm_bell` (interpret mode).

Two kinds of plan: the BELL tier of a hybrid plan (edge tiles of 256,
`eperm` in the full graph's edge ids) and a whole-graph BELL plan with
empty rows and row blocks without edges, whose all-padding tiles must
leave zeros. Tolerance 1e-5: float32 sums of the same products in another
order (JAX's fp32 one-hot products are exact through the bf16 hi/lo
split).

The plan's row runs (what the card's kernel walks) are checked against
the tiles, and `_emulate` replays the kernel's order of summation on the
CPU: each run summed from 0 in slot order (fmaf, emulated in float64),
the runs added in tile order into a row sum from 0, added to out once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgsparse_tpu.core import planner as jx_planner
from dgsparse_tpu.kernels.pallas_spmm import spmm_bell as jx_spmm_bell
from dgsparse_tpu.ops.types import ReduceOp as JxReduceOp
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.core import planner
from dgsparse_tpu_torch.kernels import spmm_bell
from dgsparse_tpu_torch.ops.hybrid import spmm_hybrid
from dgsparse_tpu_torch.utils.testing import block_csr as _block_graph
from dgsparse_tpu_torch.utils.testing import hybrid_csr

TOL = dict(rtol=1e-5, atol=1e-5)
N = 1500                   # hybrid_csr's default size


def _plans(rowptr, col, n, edge_tile):
    jp = jx_planner.build_bell_plan(rowptr, col, n, edge_tile=edge_tile)
    pp = planner.build_bell_plan(rowptr, col, n, edge_tile=edge_tile)
    return jp, pp


@pytest.mark.parametrize("edge_tile", [128, 256])
def test_bell_plan_matches_jax(edge_tile):
    rowptr, col, _, n = _block_graph()
    jp, pp = _plans(rowptr, col, n, edge_tile)
    assert (pp.num_tiles, pp.num_row_blocks, pp.num_col_windows) == \
        (jp.num_tiles, jp.num_row_blocks, jp.num_col_windows)
    np.testing.assert_array_equal(pp.eperm, np.asarray(jp.eperm))
    for name in ("lcol", "lrow", "tile_rb", "tile_cw"):
        np.testing.assert_array_equal(getattr(pp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    # each row block's run of tiles; the empty blocks' padding is outside
    ptr = pp.tile_ptr.numpy()
    rb = pp.tile_rb.numpy()
    for b in range(pp.num_row_blocks):
        assert (rb[ptr[b]:ptr[b + 1]] == b).all()
    empty = [b for b in range(pp.num_row_blocks) if ptr[b] == ptr[b + 1]]
    assert empty == [1, 3, 5]
    # within a tile rows do not decrease (the kernel's segmented sum)
    lrow = pp.lrow.numpy().reshape(-1, edge_tile)
    ep = pp.eperm.reshape(-1, edge_tile)
    for t in range(ptr[-1]):
        live = lrow[t][ep[t] >= 0]
        assert (np.diff(live) >= 0).all()


@pytest.mark.parametrize("feat", [1, 33, 64])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("has_value", [True, False])
def test_spmm_bell_plain_matches_jax(feat, reduce, has_value):
    rowptr, col, vals, n = _block_graph(seed=feat)
    jp, pp = _plans(rowptr, col, n, 128)
    v = vals if has_value else None
    x = np.random.default_rng(feat).standard_normal((n, feat)).astype(
        np.float32)
    degrees = np.diff(rowptr)
    ep = pp.eperm
    w = np.ones(len(ep), np.float32) if v is None else v[np.maximum(ep, 0)]
    slot_vals = torch.from_numpy(np.where(ep >= 0, w, 0).astype(np.float32))
    out = spmm_bell.spmm_bell(pp, slot_vals, torch.from_numpy(x), reduce,
                              torch.from_numpy(degrees)).numpy()
    ref = np.asarray(jx_spmm_bell(
        jp, None if v is None else jnp.asarray(v), jnp.asarray(x),
        JxReduceOp(reduce), jnp.asarray(degrees)))
    np.testing.assert_allclose(out, ref, **TOL)
    # the row blocks without edges are zero
    assert not out[128:256].any() and not out[384:512].any()
    assert spmm_bell.LAUNCHES["spmm_bell"] == 0


@pytest.mark.parametrize("has_value", [True, False])
def test_hybrid_bell_tier_matches_jax(has_value):
    rowptr, col, vals = hybrid_csr(seed=30)
    v = vals if has_value else None
    p = pt.SparseTensor.from_csr(
        rowptr, col, None if v is None else torch.from_numpy(v),
        sparse_sizes=(N, N))
    hp = p.storage.ell_plan()
    jp = jx_planner.build_hybrid_plan(rowptr, col, N)
    assert hp.bell.edge_tile == jp.bell.edge_tile == 256
    slot_vals = p.storage.tier_values(ones=not has_value)["bell"]
    x = np.random.default_rng(31).standard_normal((N, 48)).astype(np.float32)
    out = spmm_bell.spmm_bell(hp.bell, slot_vals, torch.from_numpy(x))
    ref = jx_spmm_bell(jp.bell, None if v is None else jnp.asarray(v),
                       jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_spmm_bell_checks_its_inputs():
    rowptr, col, _, n = _block_graph()
    _, pp = _plans(rowptr, col, n, 128)
    x = torch.ones(n, 4)
    with pytest.raises(ValueError, match="vals"):
        spmm_bell.spmm_bell(pp, torch.ones(3), x)
    with pytest.raises(ValueError, match="SUM/MEAN"):
        spmm_bell.spmm_bell(pp, torch.ones(pp.padded_edges), x, "max")
    with pytest.raises(ValueError, match="degrees"):
        spmm_bell.spmm_bell(pp, torch.ones(pp.padded_edges), x, "mean")
    with pytest.raises(ValueError, match="CUDA"):
        spmm_bell.spmm_bell_cuda(pp, torch.ones(pp.padded_edges), x)
    ones = torch.ones(pp.padded_edges)
    for bad in (torch.zeros(pp.num_rows, 4, dtype=torch.float64),
                torch.zeros(pp.num_rows + 1, 4),
                torch.zeros(4, pp.num_rows).t()):
        with pytest.raises(ValueError, match="out"):
            spmm_bell.spmm_bell(pp, ones, x, out=bad)


# --- the row runs and the kernel's order of summation ------------------------

def _hybrid_bell(seed=30, has_value=True):
    rowptr, col, vals = hybrid_csr(seed=seed)
    p = pt.SparseTensor.from_csr(
        rowptr, col, torch.from_numpy(vals) if has_value else None,
        sparse_sizes=(N, N))
    return p.storage, rowptr, col


def _plan_cases():
    rowptr, col, _, n = _block_graph()
    yield "block-128", planner.build_bell_plan(rowptr, col, n, edge_tile=128)
    yield "block-256", planner.build_bell_plan(rowptr, col, n, edge_tile=256)
    rowptr, col, _, n = _block_graph(heavy=True)
    yield "heavy-128", planner.build_bell_plan(rowptr, col, n, edge_tile=128)
    yield "hybrid", _hybrid_bell()[0].ell_plan().bell


def _runs(plan):
    return tuple(getattr(plan, k).numpy().astype(np.int64)
                 for k in ("rows", "run_ptr", "run_slot", "run_len"))


@pytest.mark.parametrize("case", ["block-128", "block-256", "heavy-128",
                                  "hybrid"])
def test_row_runs_cover_every_real_slot_once(case):
    plan = dict(_plan_cases())[case]
    rows, run_ptr, run_slot, run_len = _runs(plan)
    e = plan.edge_tile
    tile_rb = plan.tile_rb.numpy().astype(np.int64)
    lrow = plan.lrow.numpy().astype(np.int64)
    real = plan.eperm >= 0
    # the short rows, then the long ones (LONG_ROW_SLOTS or more slots),
    # each part ascending
    slots = np.add.reduceat(run_len, run_ptr[:-1])
    n_short = len(rows) - plan.num_long_rows
    assert (slots[:n_short] < planner.LONG_ROW_SLOTS).all()
    assert (slots[n_short:] >= planner.LONG_ROW_SLOTS).all()
    assert plan.num_long_rows == (3 if case == "heavy-128" else 0)
    assert len(rows) and (np.diff(rows[:n_short]) > 0).all()
    assert (np.diff(rows[n_short:]) > 0).all()
    assert run_ptr[0] == 0 and run_ptr[-1] == len(run_slot)
    assert (np.diff(run_ptr) > 0).all() and (run_len > 0).all()
    covered = np.zeros(plan.padded_edges, np.int64)
    for i, row in enumerate(rows):
        ks = np.arange(run_ptr[i], run_ptr[i + 1])
        # runs in tile order, then slot order; each within one tile
        assert (np.diff(run_slot[ks]) > 0).all()
        last = run_slot[ks] + run_len[ks] - 1
        assert (run_slot[ks] // e == last // e).all()
        for k in ks:
            s = np.arange(run_slot[k], run_slot[k] + run_len[k])
            covered[s] += 1
            assert real[s].all()
            np.testing.assert_array_equal(
                tile_rb[s // e] * plan.row_block + lrow[s], row)
    np.testing.assert_array_equal(covered, real.astype(np.int64))
    # the rows with edges, and only they, have runs
    coo_row = tile_rb.repeat(e) * plan.row_block + lrow
    np.testing.assert_array_equal(np.sort(rows), np.unique(coo_row[real]))
    assert plan.num_bell_rows == len(rows)
    assert not (rows % 17 == 0).any()       # the empty rows have no run
    if case.startswith("block"):
        # nor do the row blocks without edges (all-padding tiles)
        assert not np.isin(rows // 128, [1, 3, 5]).any()


def _emulate(plan, vals, dense, out=None):
    """The kernel's sum, vectorised over runs and rows: runs from 0 in
    slot order (fmaf in float64, rounded once to float32), then a row sum
    from 0 in tile order, added to out (zeros without it)."""
    rows, run_ptr, run_slot, run_len = (torch.from_numpy(a) for a in
                                        _runs(plan))
    win = plan.tile_cw.long()[run_slot // plan.edge_tile] * plan.col_window
    x = dense.float()
    run = torch.zeros(len(run_slot), dense.shape[1])
    for j in range(int(run_len.max()) if len(run_len) else 0):
        on = run_len > j
        s = run_slot[on] + j
        prod = vals[s].double()[:, None] * x[win[on] + plan.lcol.long()[s]]
        run[on] = (prod + run[on].double()).float()
    total = torch.zeros(len(rows), dense.shape[1])
    nruns = run_ptr[1:] - run_ptr[:-1]
    for q in range(int(nruns.max()) if len(nruns) else 0):
        on = nruns > q
        total[on] = total[on] + run[run_ptr[:-1][on] + q]
    out = (torch.zeros(plan.num_rows, dense.shape[1]) if out is None
           else out.clone())
    out[rows] = out[rows] + total
    return out


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("feat", [1, 33])
def test_emulated_kernel_order_matches_plain_and_jax(feat, reduce, heavy):
    rowptr, col, vals, n = _block_graph(seed=feat + 1, heavy=heavy)
    jp, pp = _plans(rowptr, col, n, 128)
    ep = pp.eperm
    slot_vals = torch.from_numpy(np.where(ep >= 0, vals[np.maximum(ep, 0)],
                                          0).astype(np.float32))
    x = np.random.default_rng(feat).standard_normal((n, feat)).astype(
        np.float32)
    degrees = torch.from_numpy(np.diff(rowptr))
    v = spmm_bell._slot_values(pp, slot_vals, reduce, degrees)
    emu = _emulate(pp, v, torch.from_numpy(x))
    plain = spmm_bell.spmm_bell_plain(pp, slot_vals, torch.from_numpy(x),
                                      reduce, degrees)
    ref = np.asarray(jx_spmm_bell(jp, jnp.asarray(vals), jnp.asarray(x),
                                  JxReduceOp(reduce), jnp.asarray(degrees)))
    np.testing.assert_allclose(emu.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(emu.numpy(), ref, **TOL)
    # and added into a given out, rows without BELL edges untouched
    o = torch.from_numpy(np.random.default_rng(feat + 7).standard_normal(
        (pp.num_rows, feat)).astype(np.float32))
    emu_o = _emulate(pp, v, torch.from_numpy(x), o)
    np.testing.assert_allclose(emu_o.numpy(), (o + plain).numpy(), **TOL)
    off = np.setdiff1d(np.arange(pp.num_rows), pp.rows.numpy())
    assert torch.equal(emu_o[off], o[off])


def test_emulated_kernel_order_on_the_hybrid_tier_matches_jax():
    st, rowptr, col = _hybrid_bell()
    jp = jx_planner.build_hybrid_plan(rowptr, col, N)
    x = np.random.default_rng(32).standard_normal((N, 24)).astype(np.float32)
    emu = _emulate(st.ell_plan().bell, st.tier_values()["bell"],
                   torch.from_numpy(x))
    ref = jx_spmm_bell(jp.bell, jnp.asarray(st.values().numpy()),
                       jnp.asarray(x))
    np.testing.assert_allclose(emu.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_spmm_bell_into_out_is_out_plus_standalone(reduce):
    st, rowptr, _ = _hybrid_bell(seed=33)
    plan, vals = st.ell_plan().bell, st.tier_values()["bell"]
    degrees = torch.from_numpy(np.diff(rowptr))
    rng = np.random.default_rng(34)
    x = torch.from_numpy(rng.standard_normal((N, 40)).astype(np.float32))
    o = torch.from_numpy(rng.standard_normal((N, 40)).astype(np.float32))
    want = o + spmm_bell.spmm_bell(plan, vals, x, reduce, degrees)
    o2 = o.clone()
    got = spmm_bell.spmm_bell(plan, vals, x, reduce, degrees, out=o2)
    assert got is o2 and torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_spmm_hybrid_keeps_the_bits_of_the_old_tier_sum(reduce, dtype):
    from dgsparse_tpu_torch.kernels.spmm_cells import spmm_dense_cells
    from dgsparse_tpu_torch.kernels.spmm_csr import csr_spmm
    from dgsparse_tpu_torch.ops.types import ReduceOp

    st = _hybrid_bell(seed=35)[0]
    hp, tiers = st.ell_plan(), st.tier_values()
    x = torch.from_numpy(np.random.default_rng(36).standard_normal(
        (N, 24)).astype(np.float32)).to(getattr(torch, dtype))
    # the tier sum as it was: a fresh BELL output added to it
    old = csr_spmm(hp.res.rowptr, hp.res.col, tiers["res"], x,
                   ReduceOp.SUM).float()
    old += spmm_dense_cells(hp.cells, tiers["cells"], x)
    old += spmm_bell.spmm_bell(hp.bell, tiers["bell"], x)
    if reduce == "mean":
        deg = st.rowptr()[1:] - st.rowptr()[:-1]
        old /= torch.clamp(deg, min=1).float()[:, None]
    got = spmm_hybrid(st, tiers, x, ReduceOp(reduce))
    assert got.dtype == x.dtype
    assert torch.equal(got, old.to(x.dtype))
