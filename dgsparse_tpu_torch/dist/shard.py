"""Row-block sharded SpMM and SDDMM over the ranks of a process group.

Counterpart of `dgsparse_tpu/dist/shard.py`: the CSR's rows are cut into
`num_shards` contiguous blocks, one a rank (the rank in the group is the
shard), node features are sharded by row, and each rank calls the op with
its own block. The forward all-gathers the features (`comm.all_gather`)
and runs the port's single-card op on the rank's rows; no output
collective follows. The backward of the gather is a reduce-scatter, the
`psum_scatter` JAX's autodiff derives.

`shard_csr` keeps JAX's host plan (`bounds`, `rows_per_shard`,
`row_starts`, the block-layout column remap of balance="edges", the
per-shard padded `rowptr`/`col`/`values`/`local_row`, `edge_map`) and its
refusals, without the TPU's per-shard edge-tile plans (`p_cols`,
`p_vals`, `p_lrow`, `p_tile_rb`, `num_tiles`, `edge_tile`, `row_block`)
and `_FORCE_PALLAS`. In their place `ShardedCSR.local(rank, device)` is
that rank's `SparseTensor` [rows_per_shard, n_gather] of its real edges
and no hybrid plan, so the local SpMM is `csr_spmm` (JAX's
`segment_matmul`), its backward `csr_spmm` over the CSC view and the local
SDDMM `sddmm_csr`, the Hopper kernels on the card.
"""

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
from torch.nn import functional as F

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.dist import comm
from dgsparse_tpu_torch.ops.sddmm import sddmm
from dgsparse_tpu_torch.ops.spmm import spmm


def segments_to_blocks(x: torch.Tensor, lengths, rows: int) -> torch.Tensor:
    """[sum(lengths), ...] -> [len(lengths) * rows, ...]: x's consecutive
    segments of the given lengths, each padded with zero rows to `rows`."""
    parts, s = [], 0
    for n in lengths:
        parts.append(F.pad(x[s:s + n], (0, 0) * (x.dim() - 1)
                           + (0, rows - n)))
        s += n
    return torch.cat(parts)


def blocks_to_segments(y: torch.Tensor, lengths, rows: int) -> torch.Tensor:
    """Inverse of segments_to_blocks."""
    return torch.cat([y[d * rows: d * rows + n]
                      for d, n in enumerate(lengths)])


@dataclasses.dataclass
class ShardedCSR:
    """Row-block sharded CSR on the host. Arrays carry a leading shard axis
    [D, ...] and identical per-shard shapes (padded); `row_starts` gives
    each shard's first global row."""

    rowptr: np.ndarray       # [D, rows_per_shard + 1] local rowptr
    col: np.ndarray          # [D, max_nnz] gather-space column ids (0 pad)
    values: np.ndarray       # [D, max_nnz] (0 padding; ones without values)
    local_row: np.ndarray    # [D, max_nnz] local row id per edge (0 pad)
    num_shards: int
    rows_per_shard: int
    num_rows: int
    num_cols: int
    row_starts: tuple
    # [nnz] global CSR edge id -> position in the flat [D * max_nnz] block
    edge_map: np.ndarray
    balance: str = "rows"
    has_value: bool = True
    _local: Dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def max_nnz(self) -> int:
        return self.col.shape[1]

    @property
    def nnz(self) -> np.ndarray:
        """Real edges of each shard."""
        return self.rowptr[:, -1].copy()

    @property
    def n_gather(self) -> int:
        """Rows of the all-gathered features: the block layout's D * rps
        under balance="edges", else the padded node count."""
        if self.balance == "edges":
            return self.num_shards * self.rows_per_shard
        return self.num_shards * -(-self.num_cols // self.num_shards)

    def row_range(self, rank: int):
        """(first, end) global rows of shard `rank`."""
        return self.row_starts[rank], (self.row_starts[rank + 1]
                                       if rank + 1 < self.num_shards
                                       else self.num_rows)

    def _lengths(self):
        return [hi - lo for lo, hi in map(self.row_range,
                                          range(self.num_shards))]

    def local(self, rank: int, device) -> SparseTensor:
        """Shard `rank`'s SparseTensor [rows_per_shard, n_gather] on
        `device`: its real edges (values only where the sharded matrix had
        them), no hybrid plan; built once a (rank, device)."""
        key = (rank, str(torch.device(device)))
        if key not in self._local:
            k = int(self.rowptr[rank, -1])
            vals = (torch.from_numpy(self.values[rank, :k].copy())
                    if self.has_value else None)
            self._local[key] = SparseTensor.from_csr(
                self.rowptr[rank], self.col[rank, :k], vals,
                sparse_sizes=(self.rows_per_shard, self.n_gather),
                device=device, build_plans=False)
        return self._local[key]

    def to_block_layout(self, x: torch.Tensor) -> torch.Tensor:
        """[num_rows, ...] -> [D * rps, ...]: each shard's row range padded
        to rows_per_shard (identity plus tail padding for balance="rows")."""
        return segments_to_blocks(x, self._lengths(), self.rows_per_shard)

    def from_block_layout(self, y: torch.Tensor) -> torch.Tensor:
        """Inverse of to_block_layout: [D * rps, ...] -> [num_rows, ...]."""
        return blocks_to_segments(y, self._lengths(), self.rows_per_shard)

    def edges_to_csr(self, e_block: torch.Tensor) -> torch.Tensor:
        """[D, max_nnz] (or flat) per-shard padded edge values -> [nnz] in
        global CSR edge order."""
        return e_block.reshape(-1)[
            torch.from_numpy(self.edge_map).to(e_block.device).long()]


def shard_csr(sp: SparseTensor, num_shards: int,
              balance: str = "rows") -> ShardedCSR:
    """Host-side partition of a SparseTensor into contiguous row ranges
    (`dgsparse_tpu/dist/shard.py::shard_csr` without its edge-tile plans).

    balance="rows": equal row counts per shard. balance="edges": bounds at
    nnz quantiles, so max_nnz ~ nnz / D on power-law graphs; columns are
    remapped to their block-layout positions d * rps + (c - bounds[d]),
    and features enter through `to_block_layout` (square graphs only).
    """
    st = sp.storage
    rowptr = st.rowptr().cpu().numpy().astype(np.int64)
    col = st.col().cpu().numpy()
    vals = sp.values_or_ones().detach().cpu().numpy()
    m, n = sp.sparse_sizes()
    total_nnz = int(rowptr[-1])
    if balance == "edges" and total_nnz > 0:
        targets = (np.arange(1, num_shards) * total_nnz) // num_shards
        cuts = np.searchsorted(rowptr, targets, side="left")
        bounds = np.concatenate([[0], cuts, [m]]).astype(np.int64)
        bounds = np.maximum.accumulate(bounds)   # monotone row ranges
        rps = int(np.diff(bounds).max())
    else:
        rps = -(-m // num_shards)
        bounds = np.minimum(np.arange(num_shards + 1) * rps, m)

    if balance == "edges":
        if m != n:
            raise ValueError("balance='edges' requires a square graph "
                             "(node features shard by the same bounds)")
        colmap = np.empty(n, np.int64)
        for d in range(num_shards):
            lo, hi = int(bounds[d]), int(bounds[d + 1])
            colmap[lo:hi] = d * rps + np.arange(hi - lo)
        col = colmap[col].astype(np.int32)

    nnz_per = [int(rowptr[bounds[d + 1]] - rowptr[bounds[d]])
               for d in range(num_shards)]
    max_nnz = max(max(nnz_per), 1)
    if num_shards * max_nnz >= (1 << 31):
        # the int32 ceiling of edge_map: a skewed balance='rows' split pads
        # every shard to the straggler
        raise ValueError(
            f"num_shards * max_nnz = {num_shards * max_nnz} exceeds the "
            f"int32 edge-block index range; use balance='edges' (max_nnz "
            f"~ nnz/D) or fewer shards")

    rp_l = np.zeros((num_shards, rps + 1), np.int32)
    col_l = np.zeros((num_shards, max_nnz), np.int32)
    val_l = np.zeros((num_shards, max_nnz), vals.dtype)
    lrow_l = np.zeros((num_shards, max_nnz), np.int32)
    for d in range(num_shards):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        e0, e1 = int(rowptr[lo]), int(rowptr[hi])
        rp_local = rowptr[lo:hi + 1] - e0
        rp_l[d, :hi - lo + 1] = rp_local
        rp_l[d, hi - lo + 1:] = rp_local[-1]
        col_l[d, :e1 - e0] = col[e0:e1]
        val_l[d, :e1 - e0] = vals[e0:e1]
        lrow_l[d, :e1 - e0] = np.repeat(
            np.arange(hi - lo, dtype=np.int32), np.diff(rp_local))
    edge_map = np.concatenate(
        [d * max_nnz + np.arange(nnz_per[d], dtype=np.int64)
         for d in range(num_shards)]) if total_nnz else np.zeros(0, np.int64)
    return ShardedCSR(
        rowptr=rp_l, col=col_l, values=val_l, local_row=lrow_l,
        num_shards=num_shards, rows_per_shard=rps, num_rows=m, num_cols=n,
        row_starts=tuple(int(b) for b in bounds[:-1]),
        edge_map=edge_map.astype(np.int32), balance=balance,
        has_value=sp.has_value)


def _check_reduce(op: str, reduce) -> None:
    if reduce not in ("sum", "mean"):
        raise ValueError(f"sharded {op} supports sum/mean")


def _local_spmm(sharded: ShardedCSR, x: torch.Tensor, group, rank: int,
                reduce: str) -> torch.Tensor:
    if dist.get_world_size(group) != sharded.num_shards:
        raise ValueError(
            f"{sharded.num_shards} shards on a group of "
            f"{dist.get_world_size(group)} ranks")
    xg = comm.all_gather(x, group)
    return spmm(sharded.local(rank, x.device), xg, reduce).to(x.dtype)


def spmm_sharded(sharded: ShardedCSR, x: torch.Tensor, group=None,
                 reduce: str = "sum") -> torch.Tensor:
    """Row-sharded SpMM: this rank's rows [rows_per_shard, F] of A @ x,
    from its block x [n_gather / D, F] of the node features (`pad_nodes`,
    or `to_block_layout` for balance="edges"). MEAN divides by the row's
    degree. Differentiable in x."""
    _check_reduce("spmm", reduce)
    return _local_spmm(sharded, x, group, dist.get_rank(group), reduce)


def sddmm_sharded(sharded: ShardedCSR, x: torch.Tensor, y: torch.Tensor,
                  group=None, reduce: str = "sum") -> torch.Tensor:
    """Row-sharded SDDMM: this rank's [max_nnz] edge values e[k] =
    <x[row(k)], y[col(k)]> (MEAN: over the row's degree), zeros in the
    padding, as one row of JAX's [D, max_nnz] (`edges_to_csr` of the
    stacked rows gives CSR order). x is this rank's block-layout rows
    [rps, F]; y its block of the column features, laid out as
    `spmm_sharded`'s x. Differentiable in x (locally) and y (through the
    gather's reduce-scatter)."""
    _check_reduce("sddmm", reduce)
    yg = comm.all_gather(y, group)
    sp = sharded.local(dist.get_rank(group), x.device)
    e = sddmm(sp, x, yg, reduce)
    return F.pad(e, (0, sharded.max_nnz - e.shape[0]))


def spmm_feature_sharded(sparse: SparseTensor, x: torch.Tensor,
                         reduce: str = "sum") -> torch.Tensor:
    """Feature-sharded SpMM: every rank holds the whole structure and a
    slice of the feature columns, so no rank communicates, forward or
    backward; this is the port's `spmm` on that slice."""
    return spmm(sparse, x, reduce)


def pad_nodes(x: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Pad the node axis so it divides evenly across shards."""
    pad = -(-x.shape[0] // num_shards) * num_shards - x.shape[0]
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad)) if pad else x


def spmm_sharded_2d(sharded: ShardedCSR, x: torch.Tensor, mesh,
                    graph_axis: str = "graph",
                    reduce: str = "sum") -> torch.Tensor:
    """SpMM over a 2-D `DeviceMesh` (graph x feat): rows of A over
    `graph_axis`, feature columns over the other. x is this rank's block
    [n_gather / G, F / feat]; the features are gathered along `graph_axis`
    only, so a rank's gather moves 1/feat of what the 1-D mesh's does.
    Returns this rank's [rows_per_shard, F / feat] block."""
    _check_reduce("spmm", reduce)
    return _local_spmm(sharded, x, mesh.get_group(graph_axis),
                       mesh.get_local_rank(graph_axis), reduce)
