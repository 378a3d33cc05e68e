"""The CSR SpMM's split plan for hub rows, on the CPU.

`kernels/spmm_csr.py::split_plan` cuts every row longer than C entries into
chunks of C consecutive entries; `csrc/spmm_csr.cu` runs the chunks in the
first blocks of the launch and skips those rows in the others. These tests
hold the plan to its definition, replay the launch's index arithmetic
(`_walked`) to show that every entry of every row is summed by exactly one
lane per feature, and check that a `Storage` builds, carries and swaps the
plans of both views. `csrc/sddmm_csr.cu` takes the same plan in both of
its mappings (chunks first, rows after, no fix-up): `_sddmm_walked`
replays that launch to show that every (entry, head, feature) is
multiplied by one lane and every (entry, head) written once.
`csrc/edge_softmax.cu` takes it too (chunk partials, then a second launch
that combines a row's partials): `_softmax_walked` replays both launches
in float32, forward and backward, against a float64 oracle. The kernels
themselves run only on a card (`tests/test_torch_kernels_gpu.py`).
"""

import numpy as np
import pytest
import torch

import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.kernels import edge_softmax as ES
from dgsparse_tpu_torch.kernels import sddmm_csr as S
from dgsparse_tpu_torch.kernels import spmm_csr
from dgsparse_tpu_torch.utils.testing import random_csr
from tests.test_torch_sddmm_paths import _covered

WARP, WARPS = 32, 8           # lanes a warp, warps a block (common.cuh)


def _rowptr(lengths) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)


# row lengths: a star's hub, a Zipf tail, the lengths around C and a
# multiple of it, empty rows between
GRAPHS = {
    "star": _rowptr([300] + [1] * 299),
    "zipf": random_csr(400, 600, avg_degree=12.0, seed=3, skew=1.6)[0],
    "edges": _rowptr([0, 15, 16, 17, 0, 32, 33, 48, 1, 100]),
}


def _plan_arrays(plan):
    return (plan.chunk_row.numpy(), plan.chunk_start.numpy(),
            plan.chunk_ptr.numpy())


@pytest.mark.parametrize("chunk", [4, 16, 64])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_split_plan_chunks_every_long_row_once(graph, chunk):
    rowptr = GRAPHS[graph]
    plan = spmm_csr.split_plan(rowptr, chunk)
    chunk_row, chunk_start, chunk_ptr = _plan_arrays(plan)
    lengths = np.diff(rowptr)
    long_rows = np.flatnonzero(lengths > chunk)
    assert plan.index.dtype == torch.int32
    assert (plan.num_split_rows, plan.num_chunks, plan.chunk) == (
        len(long_rows), len(chunk_row), chunk)
    assert (plan.num_rows, plan.nnz) == (len(lengths), rowptr[-1])
    assert len(chunk_ptr) == len(long_rows) + 1 and chunk_ptr[0] == 0
    for i, row in enumerate(long_rows):
        c0, c1 = chunk_ptr[i], chunk_ptr[i + 1]
        assert (chunk_row[c0:c1] == row).all()
        ends = np.minimum(chunk_start[c0:c1] + chunk, rowptr[row + 1])
        # consecutive chunks of at most C entries, in CSR order, covering
        # [rowptr[row], rowptr[row + 1]) exactly once
        assert chunk_start[c0] == rowptr[row]
        assert (chunk_start[c0 + 1:c1] == ends[:-1]).all()
        assert ends[-1] == rowptr[row + 1]
        assert (ends - chunk_start[c0:c1] >= 1).all()
        assert (ends - chunk_start[c0:c1] <= chunk).all()
    assert chunk_ptr[-1] == len(chunk_row)


@pytest.mark.parametrize("graph", ["uniform", "empty_rows", "no_rows"])
def test_split_plan_is_empty_without_long_rows(graph):
    rowptr = {"uniform": random_csr(300, 300, avg_degree=6.0, seed=1,
                                    skew=0.3)[0],
              "empty_rows": _rowptr([0, spmm_csr.SPLIT_CHUNK, 0,
                                     spmm_csr.SPLIT_CHUNK - 1, 1]),
              "no_rows": np.zeros(1, np.int32)}[graph]
    assert np.diff(rowptr).max(initial=0) <= spmm_csr.SPLIT_CHUNK
    plan = spmm_csr.split_plan(rowptr)
    assert (plan.num_chunks, plan.num_split_rows) == (0, 0)
    assert plan.chunk_ptr.tolist() == [0]
    assert plan.chunk == spmm_csr.SPLIT_CHUNK


def _walked(rowptr, plan, path, feat):
    """How many lanes sum each (entry, feature) and write each (row,
    feature), as the split launch maps them: the first chunk_blocks blocks
    take the plan's chunks, the rest the rows, skipping a row longer than
    C; the fix-up writes the split rows."""
    vec, group, nv = path
    per_block = WARPS * (WARP // group)
    num_rows = len(rowptr) - 1
    chunk_blocks = -(-plan.num_chunks // per_block)
    grid_x = chunk_blocks + -(-num_rows // per_block)
    grid_y = -(-feat // (group * nv * vec))
    chunk_row, chunk_start, _ = _plan_arrays(plan)
    summed = np.zeros((rowptr[-1], feat), np.int64)
    written = np.zeros((num_rows, feat), np.int64)
    for bx in range(grid_x):
        chunks = bx < chunk_blocks
        for warp in range(WARPS):
            for lane in range(WARP):
                slot = (((bx if chunks else bx - chunk_blocks) * WARPS
                         + warp) * (WARP // group) + lane // group)
                if chunks:
                    if slot >= plan.num_chunks:
                        continue
                    start = chunk_start[slot]
                    end = min(start + plan.chunk,
                              rowptr[chunk_row[slot] + 1])
                elif slot < num_rows:
                    start, end = rowptr[slot], rowptr[slot + 1]
                    if end - start > plan.chunk:
                        continue
                else:
                    continue
                for by in range(grid_y):
                    for v in range(nv):
                        f = ((by * nv + v) * group + lane % group) * vec
                        if f < feat:
                            summed[start:end, f:f + vec] += 1
                            if not chunks:
                                written[slot, f:f + vec] += 1
    written[np.flatnonzero(np.diff(rowptr) > plan.chunk)] += 1
    return summed, written


@pytest.mark.parametrize("feat", [7, 40, 256])
@pytest.mark.parametrize("graph", ["star", "zipf"])
def test_split_launch_sums_every_entry_once(graph, feat):
    rowptr = GRAPHS[graph]
    plan = spmm_csr.split_plan(rowptr, 16)
    path = spmm_csr.spmm_path(feat, 1, 4)
    summed, written = _walked(rowptr, plan, path, feat)
    assert (summed == 1).all() and (written == 1).all()


# --- sddmm_csr's split launch ------------------------------------------------

def _warp_lanes(feat):
    """(K, LPH) of the one-warp-a-row kernel for a head of `feat` features
    (`launch` in csrc/sddmm_csr.cu)."""
    for most, lph in ((4, 1), (8, 2), (16, 4), (32, 8), (64, 16),
                      (128, 32)):
        if feat <= most:
            return 4, lph
    return 8, 32


def _warp_covered(feat, heads, deg):
    """`_covered` for one warp a row (`sddmm_csr_kernel`): (edge, head,
    feature) of every element a row of `deg` edges multiplies, and (edge,
    head) of every output it writes."""
    k, lph = _warp_lanes(feat)
    per_pass = 1
    while per_pass < heads and per_pass * 2 * lph <= WARP:
        per_pass *= 2
    per_edge = per_pass * lph
    loads, writes = [], []
    for base in range(0, deg, WARP):
        n = min(WARP, deg - base)
        h0, s, ch, kk, lane = np.meshgrid(
            np.arange(0, heads, per_pass),
            np.arange(0, n, WARP // per_edge),
            np.arange(-(-feat // (lph * k))), np.arange(k), np.arange(WARP),
            indexing="ij")
        h = h0 + lane % per_edge // lph
        j = s + lane // per_edge
        lg = lane % lph
        f = ch * lph * k + lg + kk * lph
        valid = (h < heads) & (j < n)
        loads.append(np.stack([base + j, h, f], -1)[valid & (f < feat)])
        first = (ch == 0) & (kk == 0) & (lg == 0)
        writes.append(np.stack([base + j, h], -1)[valid & first])
    if not loads:
        return np.zeros((0, 3), int), np.zeros((0, 2), int)
    return np.concatenate(loads), np.concatenate(writes)


def _sddmm_units(rowptr, plan, group):
    """What each group of the split sddmm_csr launch is given, as the
    kernel maps them: (block, warp, group in the warp, start, end, the
    whole row's degree) for every group that walks edges; the first
    chunk_blocks blocks take the plan's chunks, the rest the rows,
    skipping a row longer than C. `group` is 32 on one warp a row. Also
    the grid's width."""
    per_warp = WARP // group
    per_block = WARPS * per_warp
    num_rows = len(rowptr) - 1
    chunks = plan.num_chunks if plan is not None else 0
    chunk_blocks = -(-chunks // per_block)
    grid_x = chunk_blocks + -(-num_rows // per_block)
    chunk_row = plan.chunk_row.numpy() if chunks else None
    chunk_start = plan.chunk_start.numpy() if chunks else None
    units = []
    for bx in range(grid_x):
        role_chunks = bx < chunk_blocks
        for warp in range(WARPS):
            for g in range(per_warp):
                slot = (((bx if role_chunks else bx - chunk_blocks) * WARPS
                         + warp) * per_warp + g)
                if role_chunks:
                    if slot >= chunks:
                        continue
                    row = chunk_row[slot]
                    start = chunk_start[slot]
                    end = min(start + plan.chunk, rowptr[row + 1])
                elif slot < num_rows:
                    row, start, end = slot, rowptr[slot], rowptr[slot + 1]
                    if chunks and end - start > plan.chunk:
                        continue
                else:
                    continue
                units.append((bx, warp, g, int(start), int(end),
                              int(rowptr[row + 1] - rowptr[row])))
    return units, grid_x


def _sddmm_walked(rowptr, plan, path, feat, heads):
    """How many lanes multiply each (entry, head, feature) and write each
    (entry, head), and the degree each write divides by (MEAN), as the
    split launch on `path` (a path of `sddmm_path`, or WARP_PER_ROW) maps
    them."""
    nnz = int(rowptr[-1])
    group = WARP if path == S.WARP_PER_ROW else path[4]
    units, _ = _sddmm_units(rowptr, plan, group)
    mult = np.zeros((nnz, heads, feat), np.int64)
    written = np.zeros((nnz, heads), np.int64)
    denom = np.zeros((nnz, heads), np.int64)
    for *_, start, end, deg in units:
        if path == S.WARP_PER_ROW:
            vec = 1
            loads, writes = _warp_covered(feat, heads, end - start)
        else:
            vec = path[0]
            loads, writes = _covered(path, feat, heads, end - start)
        for i in range(vec):
            np.add.at(mult, (start + loads[:, 0], loads[:, 1],
                             loads[:, 2] + i), 1)
        np.add.at(written, (start + writes[:, 0], writes[:, 1]), 1)
        denom[start + writes[:, 0], writes[:, 1]] = deg
    return mult, written, denom


# (F, H): GAT's two layers on the benchmark (8 heads of 8, one of 40), a
# head of 16 in 4, an odd head on either mapping, a head of 259 in chunks
SDDMM_SHAPES = [(8, 8), (40, 1), (16, 4), (7, 1), (41, 1), (259, 1)]


@pytest.mark.parametrize("mapping", ["group", "warp_per_row"])
@pytest.mark.parametrize("feat,heads", SDDMM_SHAPES)
@pytest.mark.parametrize("graph", ["star", "zipf"])
def test_split_sddmm_covers_every_edge_once(graph, feat, heads, mapping):
    rowptr = GRAPHS[graph]
    plan = spmm_csr.split_plan(rowptr, 16)
    assert plan.num_chunks > 0
    path = (S.sddmm_path(feat, heads, 4) if mapping == "group"
            else S.WARP_PER_ROW)
    mult, written, denom = _sddmm_walked(rowptr, plan, path, feat, heads)
    assert (mult == 1).all() and (written == 1).all()
    # MEAN divides a chunk's edges by the whole row's degree
    degree = np.repeat(np.diff(rowptr), np.diff(rowptr))
    assert (denom == degree[:, None]).all()


@pytest.mark.parametrize("mapping", ["group", "warp_per_row"])
def test_empty_sddmm_plan_keeps_the_launch(mapping):
    # a graph without rows longer than C: the plan is empty, and the
    # launch gives every group the row it has without a plan, on the grid
    # it has without one
    rowptr = random_csr(300, 300, avg_degree=6.0, seed=1, skew=0.3)[0]
    plan = spmm_csr.split_plan(rowptr)
    assert plan.num_chunks == 0
    group = WARP if mapping == "warp_per_row" else S.sddmm_path(8, 8, 4)[4]
    assert _sddmm_units(rowptr, plan, group) == \
        _sddmm_units(rowptr, None, group)
    # on a graph with hub rows, the row blocks give the rows of at most C
    # entries, in order, to the groups they have without a plan, shifted
    # by the chunks' blocks
    rowptr = GRAPHS["zipf"]
    plan = spmm_csr.split_plan(rowptr, 16)
    chunk_blocks = -(-plan.num_chunks // (WARPS * (WARP // group)))
    split, _ = _sddmm_units(rowptr, plan, group)
    whole, _ = _sddmm_units(rowptr, None, group)
    assert [(bx - chunk_blocks, *u) for bx, *u in split
            if bx >= chunk_blocks] == \
        [u for u in whole if u[4] - u[3] <= 16]


def _storage(rowptr, device="cpu"):
    nnz = int(rowptr[-1])
    col = np.random.default_rng(0).integers(0, 500, nnz).astype(np.int32)
    return pt.SparseTensor.from_csr(rowptr, col, torch.rand(nnz),
                                    sparse_sizes=(len(rowptr) - 1, 500),
                                    device=device)


def _same_plan(a, b):
    assert (a.num_chunks, a.num_split_rows, a.chunk, a.num_rows, a.nnz) \
        == (b.num_chunks, b.num_split_rows, b.chunk, b.num_rows, b.nnz)
    assert torch.equal(a.index.cpu(), b.index.cpu())


@pytest.mark.parametrize("graph", ["star", "zipf"])
def test_storage_builds_the_plans_of_both_views(graph):
    sp = _storage(GRAPHS[graph] * 2)
    st = sp.storage
    assert "split_plan" in st.build_seconds
    _same_plan(st.row_split(), spmm_csr.split_plan(st.rowptr().numpy()))
    _same_plan(st.col_split(), spmm_csr.split_plan(st.colptr().numpy()))
    assert st.row_split().num_chunks > 0


@pytest.mark.parametrize("op", ["t", "to", "set_values"])
def test_views_carry_the_plans(op):
    sp = _storage(GRAPHS["star"] * 2)
    st = sp.storage
    if op == "t":
        other = sp.t().storage
        _same_plan(other.row_split(), st.col_split())
        _same_plan(other.col_split(), st.row_split())
        assert sp.t().t().storage.row_split() is st.row_split()
    else:
        other = (sp.to("cpu") if op == "to"
                 else sp.set_values(torch.ones(sp.nnz))).storage
        _same_plan(other.row_split(), st.row_split())
        _same_plan(other.col_split(), st.col_split())
        assert other.row_split().index.device == other.device


# --- edge_softmax's two launches ---------------------------------------------

def _softmax_walked(rowptr, plan, x, g=None):
    """The forward (g None) or backward of `csrc/edge_softmax.cu` replayed
    in float32 on `softmax_path`'s mapping: the first launch's slots (the
    plan's chunks first, then the rows of at most C entries, each lane's
    registers holding entries start + k E + sub for k < NV), its chunk
    partials, and the second launch's combination of a row's partials.
    Returns the output and how many times each (entry, head) was written."""
    nnz, heads = x.shape
    lanes, group = ES.softmax_path(heads)
    e, nv = group // lanes, ES.MAX_CHUNK // (group // lanes)
    slots = WARPS * (WARP // group)
    num_rows = len(rowptr) - 1
    chunk_row, chunk_start, _ = _plan_arrays(plan)
    chunk_blocks = -(-plan.num_chunks // slots)
    f32, floor = np.float32, np.float32(1e-38)
    out = np.zeros((nnz, heads), f32)
    written = np.zeros((nnz, heads), np.int64)
    work = {}

    def finite(v):
        return v if np.isfinite(v) else f32(0)

    for y in range(-(-heads // lanes)):
        for bx in range(chunk_blocks + -(-num_rows // slots)):
            for slot in range(slots):
                start = end = 0
                chunk = -1
                if bx < chunk_blocks:
                    c = bx * slots + slot
                    if c < plan.num_chunks:
                        chunk, start = c, chunk_start[c]
                        end = min(start + plan.chunk,
                                  rowptr[chunk_row[c] + 1])
                else:
                    r = (bx - chunk_blocks) * slots + slot
                    if r < num_rows and rowptr[r + 1] - rowptr[r] <= \
                            plan.chunk:
                        start, end = rowptr[r], rowptr[r + 1]
                for h in range(y * lanes, min((y + 1) * lanes, heads)):
                    n = end - start
                    held = [start + k * e + sub for sub in range(e)
                            for k in range(nv) if k * e < n]
                    held = np.array([i for i in held if i < end], np.int64)
                    if g is None:
                        v = x[held, h]
                        mx = v.max(initial=-np.inf)
                        ex = np.exp(v - finite(mx))
                        total = ex.sum(dtype=f32)
                        if chunk >= 0:
                            work[chunk, h] = (mx, total)
                        else:
                            out[held, h] = ex / max(total, floor)
                    else:
                        dot = (x[held, h] * g[held, h]).sum(dtype=f32)
                        if chunk >= 0:
                            work[chunk, h] = dot
                        else:
                            out[held, h] = x[held, h] * (g[held, h] - dot)
                    if chunk < 0:
                        written[held, h] += 1
    for c in range(plan.num_chunks):
        rs, re = rowptr[chunk_row[c]], rowptr[chunk_row[c] + 1]
        start = chunk_start[c]
        end = min(start + plan.chunk, re)
        first = c - (start - rs) // plan.chunk
        count = -(-(re - rs) // plan.chunk)
        assert (chunk_row[first:first + count] == chunk_row[c]).all()
        span = np.arange(start, end)
        for h in range(heads):
            parts = [work[k, h] for k in range(first, first + count)]
            if g is None:
                mx = max(p[0] for p in parts)
                total = f32(sum((s * np.exp(finite(m) - finite(mx))
                                 for m, s in parts if s != 0), f32(0)))
                out[span, h] = np.exp(x[span, h] - finite(mx)) / max(
                    total, floor)
            else:
                dot = f32(sum(parts, f32(0)))
                out[span, h] = x[span, h] * (g[span, h] - dot)
            written[span, h] += 1
    return out, written


def _softmax_oracle(rowptr, x, g=None):
    """float64 softmax per row (and head) of x [nnz] or [nnz, H], 0 for a
    row of -inf; or, given a cotangent g, the backward for alpha x."""
    out = np.zeros(x.shape)
    for s, e in zip(rowptr[:-1], rowptr[1:]):
        v = x[s:e].astype(np.float64)
        if g is not None:
            w = g[s:e].astype(np.float64)
            out[s:e] = v * (w - (v * w).sum(0))
            continue
        mx = v.max(0, initial=-np.inf)
        ex = np.exp(v - np.where(np.isfinite(mx), mx, 0))
        out[s:e] = ex / np.maximum(ex.sum(0), 1e-38)
    return out


@pytest.mark.parametrize("heads", [1, 3, 8, 16])
@pytest.mark.parametrize("chunk", [16, spmm_csr.SPLIT_CHUNK])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_edge_softmax_launches_write_every_entry_once(graph, chunk, heads):
    rowptr = GRAPHS[graph]
    nnz = int(rowptr[-1])
    plan = spmm_csr.split_plan(rowptr, chunk)
    rng = np.random.default_rng(heads)
    x = (3 * rng.standard_normal((nnz, heads))).astype(np.float32)
    long_rows = np.flatnonzero(np.diff(rowptr) > chunk)
    if len(long_rows):
        # a chunk of -inf in a row whose other logits lie near -100: its
        # partial must add nothing, not 0 * exp(100)
        s = rowptr[long_rows[0]]
        x[s:rowptr[long_rows[0] + 1]] -= 100
        x[s:s + chunk] = -np.inf
    r = int(np.argmax(np.diff(rowptr) > 0))
    x[rowptr[r]:rowptr[r + 1]] = -np.inf           # a row of -inf: alpha 0
    alpha, written = _softmax_walked(rowptr, plan, x)
    assert (written == 1).all()
    ref = _softmax_oracle(rowptr, x)
    np.testing.assert_allclose(alpha, ref, rtol=2e-5, atol=1e-7)
    g = rng.standard_normal((nnz, heads)).astype(np.float32)
    dx, written = _softmax_walked(rowptr, plan, alpha, g)
    assert (written == 1).all()
    ref = _softmax_oracle(rowptr, alpha, g)
    np.testing.assert_allclose(dx, ref, rtol=1e-4, atol=1e-6)
    assert not dx[rowptr[r]:rowptr[r + 1]].any()
