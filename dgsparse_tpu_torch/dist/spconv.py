"""Spatially sharded submanifold sparse convolution with a halo exchange.

Counterpart of `dgsparse_tpu/dist/spconv.py`. Voxels are cut into
contiguous X-axis slabs, one a rank; a submanifold conv of kernel radius r
needs only the voxels within r planes of a slab's boundary from each
neighbour, so a rank's conv is:
  1. its boundary ("halo") rows, picked by plan-time ids, sent to both
     neighbours (`comm.neighbour_exchange`, whose backward is the reversed
     exchange: dX's halo rows go back and are added into the sender's own
     rows at `send_left` / `send_right`);
  2. the conv of its own rows against the local input
     [own rows | left halo | right halo] (own_max + 2 * h_max rows): the
     center tap one `torch.matmul` over the own rows, the other taps the
     fused Hopper kernels over the plan's pairs (`spconv_pairs` by output id
     forward, by input id with W^T for dX, `spconv_dw` for dW) through
     `ops/spconv.py::spconv`;
  3. in the backward, dW summed over the ranks (`comm.replicated`), so
     every rank holds the global dW, as JAX's autodiff gives it.
`shard_pointcloud` builds JAX's plan arrays (`o2i`, `out_mask`,
`send_left` / `send_right`, `counts`, `own_max`, `h_max`) with sorted keys
and `searchsorted` in place of JAX's per-voxel dict, equal to them;
`spconv_sharded_plain` is JAX's per-tap gather and product
(`dist/spconv.py:227-250`), the plain version the tests hold the kernel
path to.
"""

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgsparse_tpu_torch.dist import comm
from dgsparse_tpu_torch.dist.shard import (blocks_to_segments,
                                           segments_to_blocks)
from dgsparse_tpu_torch.ops.spconv import (SpConvPlan, _dot, _encode,
                                           _finalize_plan, _triple, spconv)


@dataclasses.dataclass
class LocalConv:
    """One rank's device side of a `ShardedSpConv`."""

    taps: SpConvPlan          # the off-center pairs, own <- local input
    o2i: torch.Tensor         # [k_vol, own_max] int32 (the plain version)
    send_left: torch.Tensor   # [h_max] int64 own-row ids
    send_right: torch.Tensor
    out_mask: torch.Tensor    # [own_max] float32


@dataclasses.dataclass
class ShardedSpConv:
    """Plan of a spatially sharded submanifold conv (host arrays with a
    leading shard axis [D, ...]); o2i indexes the local input layout
    [own_max | left halo h_max | right halo h_max], -1 a miss."""

    o2i: np.ndarray           # [D, k_vol, own_max] int32
    out_mask: np.ndarray      # [D, own_max] float32, 1 for real voxels
    send_left: np.ndarray     # [D, h_max] int32 own-row ids to send left
    send_right: np.ndarray    # [D, h_max] int32 own-row ids to send right
    num_shards: int
    own_max: int
    h_max: int
    k_vol: int
    mid: int
    num_voxels: int
    counts: tuple             # [D] real voxels per shard
    _local: Dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    def local(self, rank: int, device) -> LocalConv:
        """Shard `rank`'s pair layouts and ids on `device`, built once a
        (rank, device): each off-center offset's (own row, local input
        row) pairs from o2i without its misses."""
        key = (rank, str(torch.device(device)))
        if key not in self._local:
            o2i = self.o2i[rank]
            omaps = [np.nonzero(o2i[k] >= 0)[0].astype(np.int32)
                     for k in range(self.k_vol)]
            imaps = [o2i[k][om] for k, om in enumerate(omaps)]
            taps = _finalize_plan(imaps, omaps, [len(om) for om in omaps],
                                  self.k_vol, self.own_max,
                                  self.own_max + 2 * self.h_max, False, 128,
                                  device)
            as_t = lambda a: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a)).to(device)
            self._local[key] = LocalConv(
                taps, as_t(o2i), as_t(self.send_left[rank].astype(np.int64)),
                as_t(self.send_right[rank].astype(np.int64)),
                as_t(self.out_mask[rank]))
        return self._local[key]

    def to_block_layout(self, x: torch.Tensor) -> torch.Tensor:
        """[num_voxels (slab-sorted), ...] -> [D * own_max, ...]."""
        return segments_to_blocks(x, self.counts, self.own_max)

    def from_block_layout(self, y: torch.Tensor) -> torch.Tensor:
        return blocks_to_segments(y, self.counts, self.own_max)


def shard_pointcloud(coords: np.ndarray, num_shards: int, kernel_size=3,
                     spatial_shape=None) -> Tuple[ShardedSpConv, np.ndarray]:
    """Partition a voxel cloud into X-slabs and build each shard's
    halo-aware submanifold rulebook on the host (odd kernel, stride 1).

    Returns (plan, order): `order` is the slab-sort permutation; features
    go in as features[order] through `plan.to_block_layout`.
    """
    ks = _triple(kernel_size)
    if any(k % 2 == 0 for k in ks):
        raise ValueError("sharded submanifold conv needs odd kernels")
    r = ks[0] // 2
    k_vol = ks[0] * ks[1] * ks[2]
    mid = (k_vol - 1) // 2
    coords = np.asarray(coords, np.int64)
    n = len(coords)
    if spatial_shape is None:
        spatial_shape = tuple(int(coords[:, i + 1].max()) + 1
                              for i in range(3))
    dims = np.array([s + max(ks) + 2 for s in spatial_shape], np.int64)

    # slab-sort by x, stable; cut at count quantiles, never inside a plane
    order = np.argsort(coords[:, 1], kind="stable").astype(np.int64)
    sorted_c = coords[order]
    bounds = [0]
    for d in range(1, num_shards):
        t = max((d * n) // num_shards, bounds[-1])
        while t < n and t > bounds[-1] and \
                sorted_c[t, 1] == sorted_c[t - 1, 1]:
            t += 1
        bounds.append(max(min(t, n), bounds[-1]))
    bounds.append(n)
    counts = [bounds[d + 1] - bounds[d] for d in range(num_shards)]
    own_max = max(max(counts), 1)

    # the exchange reaches one neighbour: every interior slab must span at
    # least r x-planes (edge slabs have nothing beyond them)
    if r > 0:
        for d in range(1, num_shards - 1):
            lo, hi = bounds[d], bounds[d + 1]
            span = (int(sorted_c[hi - 1, 1]) - int(sorted_c[lo, 1]) + 1
                    if hi > lo else 0)
            if span < r:
                raise ValueError(
                    f"shard {d} spans {span} x-plane(s) < kernel radius "
                    f"{r}: nearest-neighbor halo exchange would drop "
                    f"contributions. Use fewer shards or a smaller kernel.")

    # halos: own rows within r planes of the slab's boundary, to send
    empty = np.empty(0, np.int64)
    halos_l, halos_r = [], []
    for d in range(num_shards):
        seg = sorted_c[bounds[d]:bounds[d + 1]]
        if len(seg):
            xmin, xmax = int(seg[0, 1]), int(seg[-1, 1])
            halos_l.append(np.nonzero(seg[:, 1] <= xmin + r - 1)[0]
                           if d > 0 else empty)
            halos_r.append(np.nonzero(seg[:, 1] >= xmax - r + 1)[0]
                           if d < num_shards - 1 else empty)
        else:
            halos_l.append(empty)
            halos_r.append(empty)
    h_max = max(max(len(h) for h in halos_l + halos_r), 1)

    o2i = np.full((num_shards, k_vol, own_max), -1, np.int32)
    out_mask = np.zeros((num_shards, own_max), np.float32)
    send_l = np.zeros((num_shards, h_max), np.int32)
    send_r = np.zeros((num_shards, h_max), np.int32)
    offs = [(i, j, k) for i in range(ks[0]) for j in range(ks[1])
            for k in range(ks[2])]
    for d in range(num_shards):
        lo, hi = bounds[d], bounds[d + 1]
        send_l[d, :len(halos_l[d])] = halos_l[d]
        send_r[d, :len(halos_r[d])] = halos_r[d]
        seg = sorted_c[lo:hi]
        out_mask[d, :hi - lo] = 1.0
        # the local input's keys: own rows, the left neighbour's right halo
        # at own_max, the right neighbour's left halo after it; where a key
        # repeats the last one wins, as in JAX's dict
        keys = [_encode(seg, dims)]
        rows = [np.arange(hi - lo)]
        if d > 0:
            src = sorted_c[bounds[d - 1]:bounds[d]][halos_r[d - 1]]
            keys.append(_encode(src, dims))
            rows.append(own_max + np.arange(len(src)))
        if d < num_shards - 1:
            src = sorted_c[bounds[d + 1]:bounds[d + 2]][halos_l[d + 1]]
            keys.append(_encode(src, dims))
            rows.append(own_max + h_max + np.arange(len(src)))
        keys, rows = np.concatenate(keys)[::-1], np.concatenate(rows)[::-1]
        ukeys, last = np.unique(keys, return_index=True)
        urows = rows[last]
        if not len(ukeys) or not len(seg):
            continue
        for kp, (oi, oj, ok) in enumerate(offs):
            if kp == mid:
                continue   # the center tap is the dense product
            q = seg.copy()
            q[:, 1] += oi - r
            q[:, 2] += oj - ks[1] // 2
            q[:, 3] += ok - ks[2] // 2
            probe = _encode(q, dims)
            pos = np.minimum(np.searchsorted(ukeys, probe), len(ukeys) - 1)
            o2i[d, kp, :hi - lo] = np.where(ukeys[pos] == probe, urows[pos],
                                            -1)
    plan = ShardedSpConv(
        o2i=o2i, out_mask=out_mask, send_left=send_l, send_right=send_r,
        num_shards=num_shards, own_max=own_max, h_max=h_max, k_vol=k_vol,
        mid=mid, num_voxels=n, counts=tuple(counts))
    return plan, order


def _local_input(plan: ShardedSpConv, lc: LocalConv, x: torch.Tensor,
                 group) -> torch.Tensor:
    """[own | left halo | right halo]: x with the neighbours' halo rows."""
    from_left, from_right = comm.neighbour_exchange(
        x.index_select(0, lc.send_right), x.index_select(0, lc.send_left),
        group)
    return torch.cat([x, from_left, from_right])


def _local(plan: ShardedSpConv, x: torch.Tensor, group) -> LocalConv:
    if dist.get_world_size(group) != plan.num_shards:
        raise ValueError(f"{plan.num_shards} shards on a group of "
                         f"{dist.get_world_size(group)} ranks")
    if x.shape[0] != plan.own_max:
        raise ValueError(f"x has {x.shape[0]} rows, the plan {plan.own_max}")
    return plan.local(dist.get_rank(group), x.device)


def spconv_sharded(plan: ShardedSpConv, x: torch.Tensor,
                   kernel: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's slab of the sharded submanifold conv: x [own_max, C_in]
    (its block of `to_block_layout`), kernel [k_vol, C_in, C_out] the same
    on every rank; returns [own_max, C_out], 0 on padding rows.
    Differentiable in x and kernel; every rank gets the global dW, as
    JAX's replicated kernel gives it (`comm.replicated`)."""
    lc = _local(plan, x, group)
    kernel = comm.replicated(kernel, group)
    out = spconv(_local_input(plan, lc, x, group), kernel, lc.taps)
    out = out + _dot(x, kernel[plan.mid], x.dtype)
    return out * lc.out_mask[:, None].to(out.dtype)


def spconv_sharded_plain(plan: ShardedSpConv, x: torch.Tensor,
                         kernel: torch.Tensor, group=None) -> torch.Tensor:
    """`spconv_sharded` as JAX computes it: a gather and a product per
    off-center tap of the local input (misses as zeros), plus the center
    tap; no kernel of this package."""
    lc = _local(plan, x, group)
    kernel = comm.replicated(kernel, group)
    x_in = _local_input(plan, lc, x, group)
    out = _dot(x, kernel[plan.mid], torch.float32)
    for kp in range(plan.k_vol):
        if kp == plan.mid:
            continue
        idx = lc.o2i[kp].long()
        g = torch.where((idx >= 0)[:, None], x_in[idx.clamp(min=0)],
                        x_in.new_zeros(()))
        out = out + _dot(g, kernel[kp], torch.float32)
    return (out * lc.out_mask[:, None]).to(x.dtype)
