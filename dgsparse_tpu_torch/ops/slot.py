"""Slot-space edge values: SDDMM -> softmax -> SpMM without a CSR-edge-order
array in between.

Counterpart of `dgsparse_tpu/ops/slot.py`. `SlotValues` holds per-edge
values in a storage's slot space, which in the port is the hybrid tiers'
own layout (`core/planner.py::HybridPlan`), the arrays the tier kernels
take as they are, so no call pays a conversion:

- `cells` [ncells, R, C]: the dense-cell tier, one value per (row, col)
  POSITION. Duplicate edges at one position share it; consumers weight it
  by the multiplicity grid (the "cells" entry of
  `Storage.tier_values(ones=True)`, 0 at positions without an edge), so
  duplicates add as in edge order. Values at positions without an edge
  mean nothing.
- `bell` [T * E]: the BELL tier in BELL slot order, 0 on padding slots.
- `ell`: the residue's edges in `hp.res` order. In the JAX package the
  residue is a bucketed-ELL plan and `ell` its flat slots; in the port the
  residue is a sub-CSR, so `ell` is one value per residue edge, in CSR
  edge order among them.

A storage with no hybrid plan keeps only `ell`, which then holds every
edge in CSR edge order: `slots_to_edges` and `edges_to_slots` are
identities there and the ops are the edge-order ones. (The JAX package's
pure-ELL plans are not ported.)

The boundary converters go through index maps composed once per plan on
the host and kept on the `Storage` (`Storage.slot_map`, as JAX's
`slot_gmap`): the stream [cells ++ bell ++ ell] to CSR edge order
(`slots_to_edges`, one gather) and back (`edges_to_slots`, one gather
that picks one edge per position). Duplicate edges with different values
have no slot representation: `edges_to_slots` keeps the last one's value
at their shared cell position (as in JAX, where the scatter's last writer
wins). The transposes read the non-cell edges through a map from the
non-cell CSC `hp.nd_t` into [bell ++ ell].

Ops (differentiable, `torch.autograd.Function`s over the tier kernels of
`ops/hybrid.py`, with JAX's gradient structure):
- `sddmm_slots(sp, d1, d2)`: the cells' blocks from `sddmm_cells`, the
  other edges' dots from `sddmm_csr` over the non-cell sub-CSR `hp.nd`,
  placed into BELL slots and residue edges. Its backward: d_d1 the hybrid
  SpMM with the cotangent as tier values, d_d2 the hybrid transpose.
- `edge_softmax_slots(sp, sv)`: the exact row softmax (true per-row max
  over every tier, detached), plain PyTorch, differentiated by autograd.
- `spmm_slots(sp, sv, x, reduce)`: SUM/MEAN as `spmm_hybrid` with the
  tiers {cells * multiplicity, bell, ell}; its backward d_sv is the
  slot-space SDDMM of (g, x) (`sddmm_cells` times the multiplicity, and
  `sddmm_csr` over `hp.nd` mapped into bell slots and residue edges) and
  d_x the hybrid transpose `spmm_hybrid_t`. MAX/MIN are not tierwise
  decomposable and the port has no K-slot kernel: they pay the one
  edge-order boundary and take the edge-order `spmm`, on a hybrid storage
  as the JAX package does (`slot.py:660-672`) and on the plain layout too.
- `sv_rowsum`, `slots_to_edges`, `edges_to_slots`, and the private
  `_sv_ones` / `_sv_reciprocal` that `gspmm`'s slot grid needs.
"""

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor, Storage
from dgsparse_tpu_torch.kernels.sddmm_csr import sddmm_csr
from dgsparse_tpu_torch.kernels.spmm_cells import sddmm_cells
from dgsparse_tpu_torch.ops.hybrid import spmm_hybrid, spmm_hybrid_t
from dgsparse_tpu_torch.ops.sddmm import _SDDMM, sddmm_span
from dgsparse_tpu_torch.ops.spmm import aggregate, op_span
from dgsparse_tpu_torch.ops.types import ReduceOp, as_reduce
from dgsparse_tpu_torch.utils import metrics

# a denominator floor well inside float32's normal range
_TINY = 1e-30


@dataclasses.dataclass
class SlotValues:
    """Per-edge values in slot space (see the module docstring)."""

    cells: Optional[torch.Tensor]   # [ncells, R, C] or None
    bell: Optional[torch.Tensor]    # [T * E] or None
    ell: torch.Tensor               # [residue edges], or [nnz] (plain)

    def map(self, fn: Callable) -> "SlotValues":
        """fn applied to every tier (the JAX class is a pytree, mapped
        with `jax.tree.map`). fn(0) must be 0 for the BELL padding to stay
        0."""
        return SlotValues(*(None if t is None else fn(t)
                            for t in (self.cells, self.bell, self.ell)))

    def astype(self, dtype) -> "SlotValues":
        return self.map(lambda t: t.to(dtype))


# ---------------------------------------------------------------------------
# layout helpers, shared with ops/attention.py
# ---------------------------------------------------------------------------

def _hybrid(sparse: SparseTensor):
    return sparse.storage.ell_plan()


def cell_mult(st: Storage) -> torch.Tensor:
    """[ncells, R, C] multiplicity grid of the dense cells (0 at positions
    without an edge): the cached ones' tier, shared; never change it in
    place."""
    return st.tier_values(ones=True)["cells"]


def _padded(v: torch.Tensor, size: int, pad) -> torch.Tensor:
    """v [n] extended to [size] with `pad`, a number or a 0-d tensor (kept
    on the device: no host sync)."""
    fill = torch.as_tensor(pad, dtype=v.dtype, device=v.device)
    return torch.cat([v, fill.reshape(1).expand(size - v.shape[0])])


def cell_rows(hp, per_row: torch.Tensor, pad=0.0) -> torch.Tensor:
    """Per-row values [M] laid out per cell: [ncells, R] (rows past M
    take `pad`)."""
    cp = hp.cells
    v = _padded(per_row, cp.num_row_blocks * cp.row_block, pad)
    return v.view(-1, cp.row_block).index_select(0, cp.cell_rb)


def cell_cols(hp, per_col: torch.Tensor, pad=0.0) -> torch.Tensor:
    """Per-column values [N] laid out per cell: [ncells, C] (columns past
    N take `pad`)."""
    cp = hp.cells
    v = _padded(per_col, cp.num_col_windows * cp.col_window, pad)
    return v.view(-1, cp.col_window).index_select(0, cp.cell_cw)


def cell_row_reduce(hp, x: torch.Tensor, reduce: str) -> torch.Tensor:
    """Per-row "sum" or "amax" [M] of per-cell row values x [ncells, R]
    over each row block's cells."""
    cp = hp.cells
    idx = cp.cell_rb.long()
    if reduce == "sum":
        out = x.new_zeros(cp.num_row_blocks, cp.row_block).index_add(0, idx, x)
    else:
        out = x.new_full((cp.num_row_blocks, cp.row_block), float("-inf"))
        out = out.scatter_reduce(0, idx[:, None].expand_as(x), x, "amax")
    return out.reshape(-1)[:cp.num_rows]


def nd_to_tiers(st: Storage, v_nd: torch.Tensor
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(bell, ell) from values [nd nnz] in the non-cell sub-CSR's order:
    the BELL slots' (0 on padding) and the residue edges'."""
    hp = st.ell_plan()
    bell = None
    if hp.bell is not None:
        bell = torch.where(st.slot_map("bell_valid"),
                           v_nd.index_select(0, st.slot_map("bell_nd")), 0.0)
    return bell, v_nd.index_select(0, st.slot_map("res_nd"))


def noncell_stream(bell: Optional[torch.Tensor],
                   ell: torch.Tensor) -> torch.Tensor:
    """The stream [bell ++ ell] of the non-cell tiers."""
    return ell if bell is None else torch.cat([bell, ell])


def forward_tiers(cells, bell, ell) -> dict:
    """`spmm_hybrid`'s tiers from slot-space weights (cells already
    weighted by the multiplicity), float32 and contiguous."""
    f = (lambda t: None if t is None else t.float().contiguous())  # noqa: E731
    return {"cells": f(cells), "bell": f(bell), "res": f(ell)}


def transpose_tiers(st: Storage, cells, bell, ell) -> dict:
    """`spmm_hybrid_t`'s tiers: the same cell blocks, and the non-cell
    weights gathered into the CSC `nd_t`'s order."""
    stream = noncell_stream(bell, ell).float()
    return {"cells": None if cells is None else cells.float().contiguous(),
            "nd_t": stream.index_select(0, st.slot_map("nd_t"))}


def slot_dots(st: Storage, d1: torch.Tensor, d2: torch.Tensor,
              mult: Optional[torch.Tensor] = None):
    """(cells, bell, ell) of per-edge dots dot(d1[row], d2[col]) in slot
    space, float32: `sddmm_cells` (times `mult` where given) and
    `sddmm_csr` over the non-cell sub-CSR. d1 and d2 of one dtype."""
    hp = st.ell_plan()
    cells = None
    if hp.cells is not None:
        cp = hp.cells
        cells = sddmm_cells(cp, d1, d2).view(cp.num_cells, cp.row_block,
                                             cp.col_window)
        if mult is not None:
            cells = cells * mult
    dots = sddmm_csr(hp.nd.rowptr, hp.nd.col, d1, d2).reshape(-1)
    return (cells, *nd_to_tiers(st, dots))


def _present(*ts):
    return tuple(t for t in ts if t is not None)


def _unpack(flags, ts):
    it = iter(ts)
    return [next(it) if f else None for f in flags]


# ---------------------------------------------------------------------------
# sddmm_slots
# ---------------------------------------------------------------------------

class _SDDMMSlots(torch.autograd.Function):
    """(cells, bell, ell) dots on a hybrid storage, the tiers it has."""

    @staticmethod
    def forward(ctx, d1, d2, st: Storage):
        ctx.st = st
        ctx.span = metrics.current()
        ctx.save_for_backward(d1, d2)
        cells, bell, ell = slot_dots(st, d1, d2)
        ctx.flags = (cells is not None, bell is not None, True)
        return _present(cells, bell, ell)

    @staticmethod
    def backward(ctx, *grads):
        with metrics.backward_span(ctx.span, d_d1=ctx.needs_input_grad[0],
                                   d_d2=ctx.needs_input_grad[1]):
            return _SDDMMSlots._backward(ctx, *grads)

    @staticmethod
    def _backward(ctx, *grads):
        d1, d2 = ctx.saved_tensors
        st = ctx.st
        g_cells, g_bell, g_ell = _unpack(ctx.flags, grads)
        d_d1 = d_d2 = None
        if ctx.needs_input_grad[0]:
            d_d1 = spmm_hybrid(st, forward_tiers(g_cells, g_bell, g_ell),
                               d2).to(d1.dtype)
        if ctx.needs_input_grad[1]:
            d_d2 = spmm_hybrid_t(st, transpose_tiers(st, g_cells, g_bell,
                                                     g_ell), d1).to(d2.dtype)
        return d_d1, d_d2, None


def sddmm_slots(sparse: SparseTensor, d1: torch.Tensor,
                d2: torch.Tensor) -> SlotValues:
    """Per-edge dots dot(d1[row_e], d2[col_e]) in slot space, float32,
    differentiable in d1 and d2. The dense-cell tier computes whole
    [R, C] blocks (one value per position, shared by duplicate edges)."""
    m, n = sparse.sparse_sizes()
    if d1.dim() != 2 or d2.dim() != 2 or d1.shape[1] != d2.shape[1] \
            or d1.shape[0] != m or d2.shape[0] != n:
        raise ValueError(
            f"d1 {tuple(d1.shape)} and d2 {tuple(d2.shape)} must be [{m}, F] "
            f"and [{n}, F]")
    st = sparse.storage
    hybrid = _hybrid(sparse) is not None
    metrics.record("sddmm_slots", hybrid=hybrid, nnz=st.nnz,
                   feat=d1.shape[1])
    with sddmm_span("slots" if hybrid else "csr", st, d1, d2):
        if not hybrid:
            return SlotValues(None, None, _SDDMM.apply(
                d1.contiguous(), d2.contiguous(), st, ReduceOp.SUM, False))
        flags = (st.ell_plan().cells is not None,
                 st.ell_plan().bell is not None, True)
        out = _SDDMMSlots.apply(d1.contiguous(), d2.contiguous(), st)
        return SlotValues(*_unpack(flags, out))


# ---------------------------------------------------------------------------
# edge_softmax_slots (plain PyTorch, differentiated by autograd)
# ---------------------------------------------------------------------------

def edge_softmax_slots(sparse: SparseTensor, sv: SlotValues) -> SlotValues:
    """Row softmax of slot-space logits. Exact: the shift is the true
    per-row max over every tier (detached, which is exact for softmax);
    empty rows are a no-op. The result's cells carry one weight per
    position (0 where no edge); `spmm_slots` weights them by the
    multiplicity."""
    hp = _hybrid(sparse)
    if hp is None:
        from dgsparse_tpu_torch.ops.edge_softmax import edge_softmax

        return SlotValues(None, None, edge_softmax(sparse, sv.ell))
    st = sparse.storage
    metrics.record("edge_softmax_slots", nnz=st.nnz)
    with metrics.span("dgsparse.op.edge_softmax.slots.fwd", m=st.num_rows,
                      nnz=st.nnz, heads=1, dtype=str(sv.ell.dtype)[6:]):
        return _edge_softmax_slots(st, hp, sv)


def _edge_softmax_slots(st: Storage, hp, sv: SlotValues) -> SlotValues:
    """`edge_softmax_slots` on a hybrid storage."""
    m = st.num_rows
    neg = float("-inf")
    res_rows = st.slot_map("res_rows")
    mult = cell_mult(st) if hp.cells is not None else None
    bell_rows = st.slot_map("bell_rows") if hp.bell is not None else None
    valid = st.slot_map("bell_valid") if hp.bell is not None else None
    with torch.no_grad():
        row_max = torch.full((m,), neg, device=sv.ell.device)
        if mult is not None:
            vc = torch.where(mult > 0, sv.cells.float(), neg)
            row_max = torch.maximum(row_max,
                                    cell_row_reduce(hp, vc.amax(2), "amax"))
        if bell_rows is not None:
            vb = torch.where(valid, sv.bell.float(), neg)
            row_max = row_max.scatter_reduce(0, bell_rows, vb, "amax")
        row_max = row_max.scatter_reduce(0, res_rows, sv.ell.float(), "amax")
        shift = torch.where(torch.isfinite(row_max), row_max, 0.0)

    # exp(v - shift), masked before the exp so no gradient meets an inf
    denom = torch.zeros(m, device=sv.ell.device)
    e_cells = e_bell = None
    if mult is not None:
        sh = cell_rows(hp, shift)[:, :, None]
        e_cells = torch.exp(torch.where(mult > 0, sv.cells.float() - sh, neg))
        denom = denom + cell_row_reduce(hp, (e_cells * mult).sum(2), "sum")
    if bell_rows is not None:
        e_bell = torch.exp(torch.where(
            valid, sv.bell.float() - shift.index_select(0, bell_rows), neg))
        denom = denom.index_add(0, bell_rows, e_bell)
    e_ell = torch.exp(sv.ell.float() - shift.index_select(0, res_rows))
    denom = denom.index_add(0, res_rows, e_ell)
    inv = 1.0 / torch.clamp(denom, min=_TINY)
    return SlotValues(
        None if e_cells is None else e_cells * cell_rows(hp, inv)[:, :, None],
        None if e_bell is None else e_bell * inv.index_select(0, bell_rows),
        e_ell * inv.index_select(0, res_rows))


# ---------------------------------------------------------------------------
# spmm_slots
# ---------------------------------------------------------------------------

class _SpMMSlots(torch.autograd.Function):
    """[M, F] float32 SUM SpMM with slot-space values on a hybrid
    storage."""

    @staticmethod
    def forward(ctx, x, cells, bell, ell, st: Storage):
        ctx.st = st
        ctx.span = metrics.current()
        ctx.save_for_backward(x, cells, bell, ell)
        mult = cell_mult(st) if cells is not None else None
        w_cells = None if cells is None else cells.float() * mult
        return spmm_hybrid(st, forward_tiers(w_cells, bell, ell),
                           x.float().contiguous())

    @staticmethod
    def backward(ctx, g):
        with metrics.backward_span(ctx.span, d_dense=ctx.needs_input_grad[0],
                                   d_values=any(ctx.needs_input_grad[1:4])):
            return _SpMMSlots._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        x, cells, bell, ell = ctx.saved_tensors
        st = ctx.st
        g32 = g.float().contiguous()
        mult = cell_mult(st) if cells is not None else None
        d_x = d_cells = d_bell = d_ell = None
        if any(ctx.needs_input_grad[1:4]):
            # d_sv: the slot-space SDDMM of (g, x), cells by multiplicity
            d_cells, d_bell, d_ell = slot_dots(
                st, g32, x.float().contiguous(), mult)
            d_cells = None if cells is None else d_cells.to(cells.dtype)
            d_bell = None if bell is None else d_bell.to(bell.dtype)
            d_ell = d_ell.to(ell.dtype)
        if ctx.needs_input_grad[0]:
            w_cells = None if cells is None else cells.float() * mult
            d_x = spmm_hybrid_t(st, transpose_tiers(st, w_cells, bell, ell),
                                g32).to(x.dtype)
        return d_x, d_cells, d_bell, d_ell, None


def spmm_slots(sparse: SparseTensor, sv: SlotValues, x: torch.Tensor,
               reduce="sum") -> torch.Tensor:
    """out[r] = reduce over r's edges e of v_e * x[col_e], with the edge
    values v taken from `sv` (the SparseTensor's own are ignored); [M, F]
    in x's dtype, differentiable in sv and x. SUM/MEAN run the tier
    kernels, the cells weighted by the multiplicity, so duplicate edges
    add as in edge order. MAX/MIN pay one `slots_to_edges` and take the
    edge-order `spmm` (its winner-mask backward)."""
    reduce = as_reduce(reduce)
    if x.dim() != 2 or x.shape[0] != sparse.sparse_sizes()[1]:
        raise ValueError(f"x must be [{sparse.sparse_sizes()[1]}, F], got "
                         f"{tuple(x.shape)}")
    if reduce in (ReduceOp.MAX, ReduceOp.MIN):
        from dgsparse_tpu_torch.ops.spmm import spmm

        return spmm(sparse.set_values(slots_to_edges(sparse, sv).float()),
                    x, reduce)
    st = sparse.storage
    hybrid = _hybrid(sparse) is not None
    metrics.record("spmm_slots", hybrid=hybrid, reduce=reduce.value,
                   nnz=st.nnz, feat=x.shape[1])
    with op_span("spmm", "slots" if hybrid else "csr", st, sv.ell, x,
                 reduce):
        if not hybrid:
            out = aggregate(sv.ell.float().unsqueeze(1),
                            x.contiguous().unsqueeze(1), st,
                            reduce).squeeze(1)
            return out.to(x.dtype)
        out = _SpMMSlots.apply(x, sv.cells, sv.bell, sv.ell, st)
        if reduce == ReduceOp.MEAN:
            deg = torch.clamp(st.rowptr()[1:] - st.rowptr()[:-1], min=1)
            out = out / deg.to(out.dtype)[:, None]
        return out.to(x.dtype)


def sv_rowsum(sparse: SparseTensor, sv: SlotValues) -> torch.Tensor:
    """Per-row sums [M] of slot-space edge values (differentiable): the
    edge side of the ADD/SUB semiring decomposition."""
    ones = torch.ones(sparse.sparse_sizes()[1], 1, device=sv.ell.device)
    return spmm_slots(sparse, sv, ones, "sum")[:, 0]


def _sv_ones(sparse: SparseTensor, sv: SlotValues) -> SlotValues:
    """Ones on every edge of `sv`'s layout (0 on BELL padding; cells all
    ones, which their multiplicity makes exact): copy_u weights."""
    hp = _hybrid(sparse)
    bell = None
    if hp is not None and sv.bell is not None:
        bell = sparse.storage.slot_map("bell_valid").to(sv.bell.dtype)
    return SlotValues(None if sv.cells is None else torch.ones_like(sv.cells),
                      bell, torch.ones_like(sv.ell))


def _sv_reciprocal(sparse: SparseTensor, sv: SlotValues) -> SlotValues:
    """1 / v on every edge, 0 on BELL padding and at cell positions
    without an edge (a bare 1/0 there would poison the sums with inf)."""
    hp = _hybrid(sparse)

    def recip(v, valid):
        one = torch.ones((), dtype=v.dtype, device=v.device)
        return torch.where(valid, 1.0 / torch.where(valid, v, one), 0.0).to(
            v.dtype)

    if hp is None:
        return SlotValues(None, None, 1.0 / sv.ell)
    st = sparse.storage
    cells = None if sv.cells is None else recip(sv.cells, cell_mult(st) > 0)
    bell = None if sv.bell is None else recip(sv.bell,
                                              st.slot_map("bell_valid"))
    return SlotValues(cells, bell, 1.0 / sv.ell)


# ---------------------------------------------------------------------------
# the boundary converters
# ---------------------------------------------------------------------------

def slots_to_edges(sparse: SparseTensor, sv: SlotValues) -> torch.Tensor:
    """CSR-edge-order values [nnz] from slot space: one gather of the
    stream [cells ++ bell ++ ell] (the identity on the plain layout)."""
    if _hybrid(sparse) is None:
        return sv.ell
    parts = [t.reshape(-1) for t in (sv.cells, sv.bell) if t is not None]
    stream = torch.cat(parts + [sv.ell]) if parts else sv.ell
    return stream.index_select(0, sparse.storage.slot_map("src"))


def edges_to_slots(sparse: SparseTensor, values: torch.Tensor) -> SlotValues:
    """Slot space from CSR-edge-order values [nnz]: one gather that takes,
    at each position, the value of one edge there (0 where none). Of
    duplicate edges at one cell position the last one's value is kept:
    build such values in slot space instead."""
    hp = _hybrid(sparse)
    if hp is None:
        return SlotValues(None, None, values)
    ext = torch.cat([values, values.new_zeros(1)])
    stream = ext.index_select(0, sparse.storage.slot_map("take"))
    cells = bell = None
    o = 0
    if hp.cells is not None:
        cp = hp.cells
        cells = stream[:cp.cell_slots].view(cp.num_cells, cp.row_block,
                                            cp.col_window)
        o = cp.cell_slots
    if hp.bell is not None:
        bell = stream[o:o + hp.bell.padded_edges]
        o += hp.bell.padded_edges
    return SlotValues(cells, bell, stream[o:])
