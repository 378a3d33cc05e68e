"""The hybrid plan: a construction-time split of a clustered graph's edges
into three tiers by the fill of their 128-row x 128-column cells.

Counterpart of the hybrid part of `dgsparse_tpu/core/planner.py`
(`DenseCellPlan` `:534-637`, `materialize_cells_np`, `HybridPlan`
`:640-897`, `BellPlan`/`build_bell_plan` `:900-1108`), with the same tier
rules, defaults and thresholds, and the same cell list, slot order, edge
permutations and BELL layout (`tests/test_torch_hybrid.py` holds them to
the JAX planner):
- cells with >= `dense_min_edges` edges (at most 65,536 of them, within a
  4 GiB budget) are materialized as dense [128, 128] fp32 blocks: SpMM
  over them is a block-sparse GEMM (`kernels/spmm_cells.py`);
- cells with >= `min_cell_edges` edges go to blocked ELL: per (row block,
  column window) tiles of `edge_tile` edges (`kernels/spmm_bell.py`);
- the rest, the residue, stays CSR (a sub-CSR run by `csr_spmm`).
`build_hybrid_plan` returns None when fewer than 25 % of the edges lie in
cells of >= `min_cell_edges` edges.

Left out of the JAX planner: the residue's and the transpose's
bucketed-ELL plans (the residue is a sub-CSR and the transpose of the
non-cell edges a CSC, both run by `csr_spmm`), BELL's chunking for the
TPU's scalar-prefetch memory (`tile_lb`, `block_inv`), and the native
C++ cell split (`native.cell_split`, which gives the same split as the
numpy path it replaces). The large stable sorts run on the card when the
plan is built for one (`core.transform.stable_argsort`).

Plans hold host numpy arrays for construction and value caching, and
int32 torch tensors on the storage's device for the kernels.
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dgsparse_tpu_torch.core.transform import (expand_rowptr_np,
                                               stable_argsort)


def _dev(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(device)


def _counts_ptr(keys: np.ndarray, n: int) -> np.ndarray:
    """CSR-style pointer [n + 1] over nondecreasing int keys in [0, n)."""
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=ptr[1:])
    return ptr.astype(np.int32)


class _OnDevice:
    """`to(device)` for a plan dataclass: its tensors and sub-plans move,
    its host arrays and sizes stay."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), (torch.Tensor, _OnDevice))})


@dataclasses.dataclass
class SubCsr(_OnDevice):
    """A subset of a CSR's edges as a CSR of its own: rowptr [M+1] and col
    (int32 tensors), and `ids`, each edge's id in the full CSR (host
    int32). Also used for a CSC (colptr, row)."""

    rowptr: torch.Tensor
    col: torch.Tensor
    ids: np.ndarray

    @property
    def nnz(self) -> int:
        return len(self.ids)


@dataclasses.dataclass
class DenseCellPlan(_OnDevice):
    """The materialized-cell tier. Host: `slot` [nnz_d], each dense-tier
    edge's flat slot (cell * R * C + lr * C + lc), ascending (duplicate
    edges share a slot and add), and `eperm`, its edge id. Device (int32):
    `cell_rb` [ncells] (nondecreasing) and `cell_cw`; `t_order`, the cells
    sorted by (cw, rb) for the transpose; and the kernels' per-output-block
    pointers, `fwd_ptr` [num_rb + 1] into the cells and `t_ptr`
    [num_cw + 1] into `t_order`."""

    slot: np.ndarray
    eperm: np.ndarray
    cell_rb: torch.Tensor
    cell_cw: torch.Tensor
    t_order: torch.Tensor
    fwd_ptr: torch.Tensor
    t_ptr: torch.Tensor
    num_cells: int
    row_block: int
    col_window: int
    num_rows: int
    num_cols: int
    nnz: int              # dense-tier edges only

    @property
    def cell_slots(self) -> int:
        return self.num_cells * self.row_block * self.col_window

    @property
    def num_row_blocks(self) -> int:
        return -(-self.num_rows // self.row_block)

    @property
    def num_col_windows(self) -> int:
        return -(-self.num_cols // self.col_window)

    def fill_ratio(self) -> float:
        return self.nnz / max(self.cell_slots, 1)


def materialize_cells_np(plan: DenseCellPlan, values) -> np.ndarray:
    """Host cell materialization, [ncells, R, C] float32: the sum of each
    slot's edge values (None: ones, the slot's multiplicity), summed in
    float64 by one bincount as the JAX planner does, so the cells equal
    its bit for bit."""
    slot = plan.slot
    n = plan.cell_slots
    shape = (plan.num_cells, plan.row_block, plan.col_window)
    if not len(slot):
        return np.zeros(shape, np.float32)
    if values is None:
        flat = np.bincount(slot, minlength=n).astype(np.float32)
    else:
        v = np.asarray(values)[plan.eperm].astype(np.float64)
        flat = np.bincount(slot, weights=v, minlength=n).astype(np.float32)
    return flat.reshape(shape)


def build_dense_cell_plan(coo_row, col, edge_ids, sel_cells, num_cw,
                          row_block, col_window, num_rows, num_cols,
                          nnz_total, device="cpu") -> DenseCellPlan:
    """The cell tier from its edges (row ids, columns, edge ids) and the
    sorted unique cell ids selected for materialization."""
    del nnz_total                         # the JAX signature's, unused
    ncells = len(sel_cells)
    coo_row = np.asarray(coo_row, np.int64)
    cell_of_edge = (coo_row // row_block) * num_cw + \
        col.astype(np.int64) // col_window
    # the index of each edge's cell among sel_cells (JAX: a searchsorted);
    # a lookup table over the cell ids is one gather
    sel = np.asarray(sel_cells, np.int64)
    lut = np.zeros(int(max(sel.max(initial=0),
                           cell_of_edge.max(initial=0))) + 1, np.int64)
    lut[sel] = np.arange(ncells)
    cidx = lut[cell_of_edge]
    slot = cidx * (row_block * col_window) + \
        (coo_row % row_block) * col_window + \
        col.astype(np.int64) % col_window
    del cell_of_edge, cidx
    order = stable_argsort(slot, device)
    cell_rb = (sel_cells // num_cw).astype(np.int32)
    cell_cw = (sel_cells % num_cw).astype(np.int32)
    t_order = np.lexsort((cell_rb, cell_cw)).astype(np.int32)
    num_rb = -(-num_rows // row_block)
    return DenseCellPlan(
        slot=slot[order].astype(np.int32),
        eperm=np.asarray(edge_ids)[order].astype(np.int32),
        cell_rb=_dev(cell_rb, device), cell_cw=_dev(cell_cw, device),
        t_order=_dev(t_order, device),
        fwd_ptr=_dev(_counts_ptr(cell_rb, num_rb), device),
        t_ptr=_dev(_counts_ptr(cell_cw[t_order], num_cw), device),
        num_cells=ncells, row_block=row_block, col_window=col_window,
        num_rows=num_rows, num_cols=num_cols, nnz=len(coo_row))


@dataclasses.dataclass
class BellPlan(_OnDevice):
    """Blocked ELL: (row block x column window) tiles of `edge_tile` edge
    slots. Host: `eperm` [T*E], each slot's edge id (-1 on padding). Device
    (int32): `lcol`/`lrow` [T*E], the slot's column and row within its tile
    (0 on padding); `tile_rb`/`tile_cw` [T]; `tile_ptr` [num_rb + 1], each
    row block's run of tiles. Tiles are sorted by (rb, cw) and, within a
    cell, keep CSR edge order, so `lrow` does not decrease inside a tile;
    row blocks without edges get one all-padding tile each, appended last
    (outside every `tile_ptr` run).

    The row runs, for the kernel's one pass over the rows that have edges
    (device, int32): within a tile a row's slots are one run of
    consecutive slots. `rows` [R] are the rows with edges: those of fewer
    than LONG_ROW_SLOTS slots, ascending, then the `num_long_rows` others,
    ascending; `run_ptr` [R + 1] each row's runs, in tile order;
    `run_slot` / `run_len` [number of runs] a run's first slot (its tile
    is `run_slot // edge_tile`) and its length. Padding slots are in no
    run."""

    lcol: torch.Tensor
    lrow: torch.Tensor
    eperm: np.ndarray
    tile_rb: torch.Tensor
    tile_cw: torch.Tensor
    tile_ptr: torch.Tensor
    rows: torch.Tensor
    run_ptr: torch.Tensor
    run_slot: torch.Tensor
    run_len: torch.Tensor
    num_long_rows: int
    num_tiles: int
    edge_tile: int
    row_block: int
    col_window: int
    num_row_blocks: int
    num_col_windows: int
    num_rows: int
    num_cols: int
    nnz: int

    @property
    def padded_edges(self) -> int:
        return self.num_tiles * self.edge_tile

    @property
    def num_bell_rows(self) -> int:
        return self.rows.shape[0]

    def pad_ratio(self) -> float:
        return self.padded_edges / max(self.nnz, 1)


# a BELL row of at least this many slots is "long": the kernel gives it a
# warp of its own with more gathers in flight (`csrc/spmm_bell.cu`)
LONG_ROW_SLOTS = 64


def _row_runs(slot: np.ndarray, row: np.ndarray, edge_tile: int):
    """(rows, run_ptr, run_slot, run_len, number of long rows) of BellPlan
    from the real slots `slot` (ascending) and their rows: a run is a
    maximal stretch of one row's consecutive slots in one tile; each row's
    runs in tile order; the rows of fewer than LONG_ROW_SLOTS slots first,
    then the long ones, each part ascending."""
    if len(slot) == 0:
        z = np.zeros(0, np.int64)
        return z, np.zeros(1, np.int64), z, z, 0
    tile = slot // edge_tile
    start = np.ones(len(slot), bool)
    start[1:] = (tile[1:] != tile[:-1]) | (row[1:] != row[:-1])
    first = np.nonzero(start)[0]
    run_len = np.diff(np.append(first, len(slot)))
    run_row = row[first]
    rows, counts = np.unique(run_row, return_counts=True)
    row_slots = np.bincount(np.searchsorted(rows, run_row), run_len)
    long = row_slots >= LONG_ROW_SLOTS
    # by (long, row), stable: each row's runs stay in tile order
    order = np.lexsort((run_row, long[np.searchsorted(rows, run_row)]))
    row_order = np.argsort(long, kind="stable")
    run_ptr = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(counts[row_order], out=run_ptr[1:])
    return (rows[row_order], run_ptr, slot[first][order], run_len[order],
            int(long.sum()))


def build_bell_plan(rowptr: np.ndarray, col: np.ndarray, num_cols: int,
                    edge_tile: int = 128, row_block: int = 128,
                    col_window: int = 128, device="cpu") -> BellPlan:
    """Tile a CSR into BELL: per row block, edges stably sorted by column
    window, each (block, window) cell padded to a multiple of edge_tile
    (`dgsparse_tpu/core/planner.py:958-1034`, without the chunking)."""
    rowptr = np.asarray(rowptr)
    col = np.asarray(col)
    m = len(rowptr) - 1
    nnz = len(col)
    num_rb = max(-(-m // row_block), 1)
    num_cw = max(-(-num_cols // col_window), 1)
    deg = np.diff(rowptr)
    coo_row = np.repeat(np.arange(m, dtype=np.int64), deg)
    if nnz:
        erb = coo_row // row_block
        ew = col.astype(np.int64) // col_window
        order = np.lexsort((np.arange(nnz), ew, erb))
        sc = col[order].astype(np.int64)
        srb = erb[order]
        sw = ew[order]
        lr_all = (coo_row[order] - srb * row_block).astype(np.int32)
        lc_all = (sc - sw * col_window).astype(np.int32)
        cell = srb * num_cw + sw
        uniq_mask = np.empty(nnz, bool)
        uniq_mask[0] = True
        np.not_equal(cell[1:], cell[:-1], out=uniq_mask[1:])
        cell_start = np.nonzero(uniq_mask)[0]
        counts = np.diff(np.append(cell_start, nnz))
        cell_rb = srb[cell_start].astype(np.int32)
        cell_cw = sw[cell_start].astype(np.int32)
        n_tiles_c = -(-counts // edge_tile)
        padded_c = n_tiles_c * edge_tile
        pad_off = np.concatenate([[0], np.cumsum(padded_c)[:-1]])
        total = int(padded_c.sum())
        within = np.arange(nnz, dtype=np.int64) - np.repeat(cell_start,
                                                            counts)
        slot = np.repeat(pad_off, counts) + within
        lcol = np.zeros(total, np.int32)
        lrow = np.zeros(total, np.int32)
        eperm = np.full(total, -1, np.int32)
        lcol[slot] = lc_all
        lrow[slot] = lr_all
        eperm[slot] = order.astype(np.int32)
        runs = _row_runs(slot, coo_row[order], edge_tile)
        tile_rb = np.repeat(cell_rb, n_tiles_c)
        tile_cw = np.repeat(cell_cw, n_tiles_c)
        blk_deg = np.zeros(num_rb, np.int64)
        np.add.at(blk_deg, np.arange(m) // row_block, deg)
        empty_rb = np.nonzero(blk_deg == 0)[0].astype(np.int32)
    else:
        lcol = lrow = np.zeros(0, np.int32)
        eperm = np.zeros(0, np.int32)
        tile_rb = tile_cw = np.zeros(0, np.int32)
        empty_rb = np.arange(num_rb, dtype=np.int32)
        runs = _row_runs(np.zeros(0, np.int64), None, edge_tile)
    tile_ptr = _counts_ptr(tile_rb, num_rb)
    if len(empty_rb):
        pad_n = len(empty_rb) * edge_tile
        lcol = np.concatenate([lcol, np.zeros(pad_n, np.int32)])
        lrow = np.concatenate([lrow, np.zeros(pad_n, np.int32)])
        eperm = np.concatenate([eperm, np.full(pad_n, -1, np.int32)])
        tile_rb = np.concatenate([tile_rb, empty_rb])
        tile_cw = np.concatenate([tile_cw,
                                  np.zeros(len(empty_rb), np.int32)])
    if len(lcol) >= 2 ** 31:
        raise ValueError(f"{len(lcol)} BELL slots: int32 slot ids take "
                         "fewer than 2^31")
    rows, run_ptr, run_slot, run_len, num_long = runs
    return BellPlan(
        lcol=_dev(lcol, device), lrow=_dev(lrow, device), eperm=eperm,
        tile_rb=_dev(tile_rb, device), tile_cw=_dev(tile_cw, device),
        tile_ptr=_dev(tile_ptr, device), rows=_dev(rows, device),
        run_ptr=_dev(run_ptr, device), run_slot=_dev(run_slot, device),
        run_len=_dev(run_len, device), num_long_rows=num_long,
        num_tiles=len(tile_rb),
        edge_tile=edge_tile, row_block=row_block, col_window=col_window,
        num_row_blocks=num_rb, num_col_windows=num_cw, num_rows=m,
        num_cols=num_cols, nnz=nnz)


@dataclasses.dataclass
class HybridPlan(_OnDevice):
    """The three tiers and what runs them.

    - `cells`: DenseCellPlan or None; its transpose reuses the same blocks.
    - `bell`: BellPlan or None, its `eperm` in the full CSR's edge ids.
    - `res`: the residue as a sub-CSR (the forward's third tier).
    - `nd`: every non-cell edge (BELL and residue) as a sub-CSR, and
      `nd_t` the same edges as a CSC (colptr, row; `ids` in the full CSR's
      edge ids): the transpose's second tier and the SDDMM's non-cell part.
    - `edge_src` [nnz] (device): each edge's position in the SDDMM stream
      [cell slots ++ `nd` edges]; one gather assembles CSR edge order.
    """

    cells: Optional[DenseCellPlan]
    bell: Optional[BellPlan]
    res: SubCsr
    nd: SubCsr
    nd_t: SubCsr
    edge_src: torch.Tensor
    num_rows: int
    num_cols: int
    nnz: int

    @property
    def dense_fraction(self) -> float:
        d = (self.bell.nnz if self.bell is not None else 0) + \
            (self.cells.nnz if self.cells is not None else 0)
        return d / max(self.nnz, 1)


def describe(plan: HybridPlan) -> dict:
    """The plan's shape, the tags of its set-up span: the cells and their
    edges, the dense fraction, BELL's rows and slots (padding included),
    and the edges of the residue and of the non-cell CSC."""
    cells, bell = plan.cells, plan.bell
    return {"cells": cells.num_cells if cells is not None else 0,
            "cell_edges": cells.nnz if cells is not None else 0,
            "dense_fraction": plan.dense_fraction,
            "bell_rows": bell.num_bell_rows if bell is not None else 0,
            "bell_slots": bell.padded_edges if bell is not None else 0,
            "residue_nnz": plan.res.nnz, "nd_t_nnz": plan.nd_t.nnz}


def tier_values(plan: HybridPlan, values, device) -> dict:
    """Each tier's edge values for the kernels, on `device`: "cells" the
    materialized blocks [ncells, R, C] (or None), "cells_bf16" their bf16
    twin (None until `with_bf16_cells` makes it), "bell" the BELL slot
    values [T*E] (0 on padding; or None), "res" and "nd_t" the residue's
    and the non-cell CSC's values in their edge orders (None for ones).

    `values` None means implicit ones; a numpy array is materialized on the
    host (`materialize_cells_np`, bit-equal to the JAX planner's cache); a
    tensor on its device, through the sorted slot order
    (`kernels.spmm_cells.materialize_cells`, the segment-sum kernel on
    CUDA) and gathers by the edge ids of `_tier_ids`. A tensor's tiers
    hold no autograd history (`gspmm`'s DIV builds them for 1/values on
    every call; its `d_values` flows through the CSR SDDMM)."""
    out = {"cells": None, "cells_bf16": None, "bell": None, "res": None,
           "nd_t": None}
    if isinstance(values, torch.Tensor):
        from dgsparse_tpu_torch.kernels.spmm_cells import materialize_cells

        v = values.detach().float().reshape(-1)
        ids = _tier_ids(plan, v.device)
        if plan.cells is not None:
            out["cells"] = materialize_cells(plan.cells, v)
        if plan.bell is not None:
            out["bell"] = torch.where(ids["bell_valid"],
                                      v.index_select(0, ids["bell"]), 0.0)
        out["res"] = v.index_select(0, ids["res"])
        out["nd_t"] = v.index_select(0, ids["nd_t"])
        return out

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            device)

    vals = None if values is None else np.asarray(values, np.float32)
    if plan.cells is not None:
        out["cells"] = put(materialize_cells_np(plan.cells, vals))
    if plan.bell is not None:
        ep = plan.bell.eperm
        w = (np.ones(len(ep), np.float32) if vals is None
             else vals[np.maximum(ep, 0)])
        out["bell"] = put(np.where(ep >= 0, w, 0))
    if vals is not None:
        out["res"] = put(vals[plan.res.ids])
        out["nd_t"] = put(vals[plan.nd_t.ids])
    return out


def _tier_ids(plan: HybridPlan, device) -> dict:
    """The edge ids `tier_values` gathers a values tensor by, int32 on
    `device`: "res" and "nd_t" (the residue's and the non-cell CSC's
    edges), "bell" (each BELL slot's edge, 0 on padding) and "bell_valid"
    (the real slots). Uploaded once per plan and device and kept, as
    `kernels.spmm_cells._slot_segments` keeps the cells' slot order: a
    per-call build (`gspmm`'s DIV tiers) would otherwise copy them from
    the host on every call, ~46 M ids at Reddit scale."""
    cache = plan.__dict__.setdefault("_tier_ids", {})
    key = str(device)
    if key not in cache:
        with torch.inference_mode(False):
            ids = {"res": _dev(plan.res.ids, device),
                   "nd_t": _dev(plan.nd_t.ids, device)}
            if plan.bell is not None:
                ep = plan.bell.eperm
                ids["bell"] = _dev(np.maximum(ep, 0), device)
                ids["bell_valid"] = torch.from_numpy(ep >= 0).to(device)
        cache[key] = ids
    return cache[key]


def with_bf16_cells(tiers: dict) -> dict:
    """`tiers` with "cells_bf16" filled in: the fp32 blocks rounded to bf16
    (to nearest even, as the JAX planner's `astype(bfloat16)` rounds them:
    duplicate edges were summed in fp32 first), made on their device at the
    first call and kept in the dict. The bf16 compute mode's cell passes
    read it, half the bytes of the fp32 blocks; float32-only callers never
    pay for it. The twin lives in the same dict as the blocks, so whatever
    rebuilds the tiers (new or changed values) drops it with them."""
    if tiers["cells"] is not None and tiers.get("cells_bf16") is None:
        tiers["cells_bf16"] = tiers["cells"].to(torch.bfloat16)
    return tiers


SLOT_MAPS = ("src", "take", "nd_t", "bell_nd", "bell_valid", "res_nd",
             "bell_rows", "bell_cols", "res_rows")


def slot_map(plan: HybridPlan, name: str, device) -> torch.Tensor:
    """An index map of slot space (`ops/slot.py`), on `device`. Slot
    space is the tiers' own layout: the stream [cell positions (ncells x R
    x C) ++ BELL slots (T x E) ++ residue edges (`res` order)].
    - "src" [nnz]: each CSR edge's position in the stream (int32 while
      the stream fits, else int64);
    - "take" [stream]: one edge at each stream position, nnz where none
      (a cell position without an edge, BELL padding); of duplicate edges
      at one cell position the last (int32 or int64, as "src");
    - "nd_t" [nd nnz]: each edge of the non-cell CSC `nd_t`, its position
      in the stream's [BELL ++ residue] part (int64);
    - "bell_nd" [T x E] / "res_nd" [res nnz]: each BELL slot's / residue
      edge's position in the non-cell sub-CSR `nd` (0 on padding; int64),
      with "bell_valid" [T x E] (bool) the real slots;
    - "bell_rows" / "bell_cols" [T x E], "res_rows" [res nnz]: each slot's
      row and column (int64; padding slots clamped into range).
    Built from the plan's host arrays (`cells.slot`/`eperm`,
    `bell.eperm`, `res.ids`, `nd.ids`, `nd_t.ids`)."""
    cells, bell = plan.cells, plan.bell
    cell_slots = cells.cell_slots if cells is not None else 0
    bell_slots = bell.padded_edges if bell is not None else 0
    total = cell_slots + bell_slots + plan.res.nnz
    nnz = plan.nnz
    ep = bell.eperm if bell is not None else np.zeros(0, np.int32)
    valid = ep >= 0

    def put(arr, dtype=np.int64):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(device)

    if name in ("src", "take"):
        idt = np.int32 if max(total, nnz) < 2 ** 31 - 1 else np.int64
        src = np.empty(nnz, idt)
        if cells is not None:
            src[cells.eperm] = cells.slot
        src[ep[valid]] = cell_slots + np.nonzero(valid)[0]
        src[plan.res.ids] = cell_slots + bell_slots + np.arange(plan.res.nnz)
        if name == "src":
            return put(src, idt)
        take = np.full(total, nnz, idt)
        take[src] = np.arange(nnz, dtype=idt)    # numpy: the last one wins
        return put(take, idt)
    if name == "bell_valid":
        return torch.from_numpy(valid).to(device)
    if name in ("bell_rows", "bell_cols"):
        tile = np.arange(bell_slots) // max(bell.edge_tile, 1)
        if name == "bell_rows":
            blk = plan.bell.tile_rb.cpu().numpy()[tile]
            loc = plan.bell.lrow.cpu().numpy()
            return put(np.minimum(blk.astype(np.int64) * bell.row_block
                                  + loc, plan.num_rows - 1))
        blk = plan.bell.tile_cw.cpu().numpy()[tile]
        loc = plan.bell.lcol.cpu().numpy()
        return put(np.minimum(blk.astype(np.int64) * bell.col_window + loc,
                              plan.num_cols - 1))
    if name == "res_rows":
        return put(expand_rowptr_np(plan.res.rowptr.cpu().numpy()))
    # positions in the non-cell sub-CSR `nd` (edge ids ascending)
    lut = np.zeros(nnz, np.int64)
    lut[plan.nd.ids] = np.arange(plan.nd.nnz)
    if name == "bell_nd":
        return put(np.where(valid, lut[np.maximum(ep, 0)], 0))
    if name == "res_nd":
        return put(lut[plan.res.ids])
    if name == "nd_t":
        stream = np.empty(plan.nd.nnz, np.int64)
        stream[lut[ep[valid]]] = np.nonzero(valid)[0]
        stream[lut[plan.res.ids]] = bell_slots + np.arange(plan.res.nnz)
        return put(stream[lut[plan.nd_t.ids]])
    raise ValueError(f"unknown slot map {name!r}; one of {SLOT_MAPS}")


def _sub_csr(rowptr: np.ndarray, col: np.ndarray, ids: np.ndarray,
             device) -> Tuple[np.ndarray, np.ndarray, SubCsr]:
    """The sub-CSR of a sorted edge-id subset (`planner.py:806-812`):
    per-row counts by one searchsorted over rowptr."""
    ids = np.asarray(ids)
    sub_col = col[ids]
    sub_rowptr = np.searchsorted(ids, rowptr).astype(np.int32)
    ids = ids.astype(np.int32, copy=False)
    return sub_rowptr, sub_col, SubCsr(_dev(sub_rowptr, device),
                                       _dev(sub_col, device), ids)


def build_hybrid_plan(
    rowptr: np.ndarray,
    col: np.ndarray,
    num_cols: int,
    edge_tile: int = 256,
    row_block: int = 128,
    col_window: int = 128,
    min_cell_edges: int = 96,
    dense_min_edges: int = 768,
    cells_budget_bytes: int = 4 << 30,
    device="cpu",
) -> Optional[HybridPlan]:
    """Split the edges by cell fill: >= dense_min_edges -> materialized
    cells, >= min_cell_edges -> BELL tiles, else the residue. None when
    fewer than 25 % of the edges lie in cells of >= min_cell_edges edges.
    Follows the numpy path of `dgsparse_tpu/core/planner.py:695-897`;
    `device` is where the plan's tensors live and its large sorts run."""
    rowptr = np.asarray(rowptr)
    col = np.asarray(col)
    m = len(rowptr) - 1
    nnz = len(col)
    if nnz == 0:
        return None
    coo_row = expand_rowptr_np(rowptr)
    num_cw = max(-(-num_cols // col_window), 1)
    max_cells = min(int(cells_budget_bytes) // (4 * row_block * col_window),
                    65536)

    cell = (coo_row.astype(np.int64) // row_block) * num_cw \
        + col.astype(np.int64) // col_window
    order = stable_argsort(cell, device)
    cs = cell[order]
    del cell
    uniq_mask = np.empty(nnz, bool)
    uniq_mask[0] = True
    np.not_equal(cs[1:], cs[:-1], out=uniq_mask[1:])
    starts = np.nonzero(uniq_mask)[0]
    counts = np.diff(np.append(starts, nnz))
    uniq_cells = cs[starts]
    del cs, uniq_mask
    nonsparse_cells = counts >= int(min_cell_edges)
    dense_mask_sorted = np.repeat(nonsparse_cells, counts)
    if int(dense_mask_sorted.sum()) < 0.25 * nnz:
        return None

    # the densest cells, within the materialization budget
    mat_cells = counts >= int(dense_min_edges)
    if int(mat_cells.sum()) > max_cells:
        cand = np.nonzero(mat_cells)[0]
        keep = cand[np.argsort(counts[cand], kind="stable")[::-1]
                    [:max_cells]]
        mat_cells = np.zeros(len(counts), bool)
        mat_cells[keep] = True
    bell_cells = nonsparse_cells & ~mat_cells

    mat_edges = order[np.repeat(mat_cells, counts)]
    bell_edges = np.sort(order[np.repeat(bell_cells, counts)])
    dense_edge_mask = np.zeros(nnz, bool)
    dense_edge_mask[order[dense_mask_sorted]] = True
    del order, dense_mask_sorted
    res_ids = np.nonzero(~dense_edge_mask)[0]
    del dense_edge_mask

    cells = None
    if len(mat_edges):
        cells = build_dense_cell_plan(
            coo_row[mat_edges], col[mat_edges], mat_edges,
            uniq_cells[mat_cells], num_cw, row_block, col_window, m,
            num_cols, nnz, device)
    del mat_edges

    bell = None
    if len(bell_edges):
        b_rowptr, b_col, b_sub = _sub_csr(rowptr, col, bell_edges, "cpu")
        bell = build_bell_plan(b_rowptr, b_col, num_cols,
                               edge_tile=edge_tile, row_block=row_block,
                               col_window=col_window, device=device)
        bp = bell.eperm
        bell.eperm = np.where(bp >= 0, b_sub.ids[np.maximum(bp, 0)],
                              -1).astype(np.int32)
    _, _, res = _sub_csr(rowptr, col, res_ids, device)

    # the non-cell edges, as a sub-CSR and as its CSC
    nd_ids = np.sort(np.concatenate([np.asarray(bell_edges, np.int64),
                                     res_ids]))
    del res_ids
    _, nd_col, nd = _sub_csr(rowptr, col, nd_ids, device)
    perm_t = stable_argsort(nd_col, device)
    colptr_t = np.zeros(num_cols + 1, np.int64)
    colptr_t[1:] = np.cumsum(np.bincount(nd_col, minlength=num_cols))
    nd_t = SubCsr(_dev(colptr_t, device),
                  _dev(coo_row[nd.ids[perm_t]], device),
                  nd.ids[perm_t].astype(np.int32))
    del nd_col, perm_t, coo_row

    # SDDMM stream position of every edge: [cell slots ++ nd edges]
    cell_slots = cells.cell_slots if cells is not None else 0
    src = np.empty(nnz, np.int64 if cell_slots + nnz >= 2 ** 31
                   else np.int32)
    if cells is not None:
        src[cells.eperm] = cells.slot
    src[nd.ids] = cell_slots + np.arange(nd.nnz)
    return HybridPlan(cells=cells, bell=bell, res=res, nd=nd, nd_t=nd_t,
                      edge_src=torch.from_numpy(src).to(device),
                      num_rows=m, num_cols=num_cols, nnz=nnz)
