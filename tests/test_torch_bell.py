"""The port's BELL plan and BELL SpMM (plain version on the CPU) against the
JAX package's `build_bell_plan` and Pallas `spmm_bell` (interpret mode).

Two kinds of plan: the BELL tier of a hybrid plan (edge tiles of 256,
`eperm` in the full graph's edge ids) and a whole-graph BELL plan with
empty rows and row blocks without edges, whose all-padding tiles must
leave zeros. Tolerance 1e-5: float32 sums of the same products in another
order (JAX's fp32 one-hot products are exact through the bf16 hi/lo
split).
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
from dgsparse_tpu_torch.utils.testing import hybrid_csr

TOL = dict(rtol=1e-5, atol=1e-5)
N = 1500                   # hybrid_csr's default size


def _block_graph(m=700, n=600, seed=0):
    """Rows in blocks 0, 2 and 4 with ~150 edges per (block, window) cell,
    rows of blocks 1, 3 and 5 empty (so all-padding tiles), duplicates kept,
    columns unsorted within a row (a self-loop appended last)."""
    rng = np.random.default_rng(seed)
    degs = np.where((np.arange(m) // 128) % 2 == 0,
                    rng.poisson(6, m), 0).astype(np.int64)
    degs[::17] = 0
    cols = [np.append(np.sort(rng.integers(0, n, d)), r % n)
            if d else np.zeros(0, np.int64) for r, d in enumerate(degs)]
    col = np.concatenate(cols).astype(np.int32)
    rowptr = np.zeros(m + 1, np.int64)
    rowptr[1:] = np.cumsum([len(c) for c in cols])
    vals = rng.standard_normal(len(col)).astype(np.float32)
    return rowptr.astype(np.int32), col, vals, n


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
