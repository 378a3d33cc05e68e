"""The CSR SDDMM's path choice, on the CPU.

`kernels/sddmm_csr.py::sddmm_path` picks (vec, k, q, heads_per_pass,
group) for the group kernel of `csrc/sddmm_csr.cu`: `vec` elements a
load, `k` vectors a lane, `q` lanes a head, `heads_per_pass` heads of an
edge side by side and `group` lanes a row. `_covered` repeats the kernel's
index arithmetic (rows per warp, edge slots, heads, chunks, passes) so
that these tests can hold every path to what the kernel
needs: each (edge, head, feature) of a row multiplied by exactly one lane,
each output written by exactly one lane, no vector straddling two heads,
and the lane and register budgets the kernel's launcher accepts.
"""

import numpy as np
import pytest

from dgsparse_tpu_torch.kernels import sddmm_csr as S

WARP, WARPS = 32, 8           # lanes a warp, warps a block (common.cuh)
DEGREES = (0, 7, 37)          # an empty, a short and a long row


def _rows_of_groups(group, rows=37):
    """Row of each (block, warp, lane) that has one, as the kernel maps
    them: every row exactly once, by `group` consecutive lanes."""
    per_warp = WARP // group
    blocks = -(-rows // (WARPS * per_warp))
    bx, warp, lane = np.meshgrid(np.arange(blocks), np.arange(WARPS),
                                 np.arange(WARP), indexing="ij")
    row = (bx * WARPS + warp) * per_warp + lane // group
    return row[row < rows]


def _covered(path, feat, heads, deg):
    """(edge, head, first feature) of every vector a row of `deg` edges
    multiplies, and (edge, head) of every output it writes."""
    vec, k, q, per_pass, group = path
    per_edge = q * per_pass
    in_pass = group // per_edge
    head_vecs = feat // vec
    chunks = -(-head_vecs // (q * k))
    passes = -(-deg // in_pass)
    h0, base, ch, kk, li = np.meshgrid(
        np.arange(0, heads, per_pass), np.arange(passes) * in_pass,
        np.arange(chunks), np.arange(k), np.arange(group), indexing="ij")
    slot, hp, ql = li // per_edge, li % per_edge // q, li % q
    h, e = h0 + hp, base + slot
    v = ch * q * k + ql + kk * q
    valid = (h < heads) & (e < deg)
    loads = np.stack([e, h, v * vec], -1)[valid & (v < head_vecs)]
    first = (ch == 0) & (kk == 0) & (ql == 0)       # one writer an output
    return loads, np.stack([e, h], -1)[valid & first]


def _check(feat, heads, itemsize, align):
    vec, k, q, per_pass, group = path = S.sddmm_path(feat, heads, itemsize,
                                                     align)
    assert vec * itemsize <= min(16, align) and feat % vec == 0, path
    assert k in S.KS and k * vec * itemsize <= S.LANE_BYTES, path
    assert k * vec * itemsize <= S.LANE_BYTES // 2 or vec * itemsize == 16 \
        or feat * itemsize <= S.LANE_BYTES, path
    for n in (q, per_pass, group):
        assert n & (n - 1) == 0, path
    assert q * per_pass <= group <= WARP, path
    for deg in DEGREES:
        loads, writes = _covered(path, feat, heads, deg)
        flat = ((loads[:, 0] * heads + loads[:, 1]) * feat
                + loads[:, 2])[:, None] + np.arange(vec)
        count = np.bincount(flat.ravel(), minlength=deg * heads * feat)
        assert (count == 1).all(), (feat, heads, path, deg)
        assert (loads[:, 2] + vec <= feat).all(), (feat, heads, path)
        out = np.bincount(writes[:, 0] * heads + writes[:, 1],
                          minlength=deg * heads)
        assert (out == 1).all(), (feat, heads, path, deg)
    return path


def test_every_row_is_served_by_one_group():
    for group in (1, 2, 4, 8, 16, 32):
        rows = _rows_of_groups(group)
        assert (np.bincount(rows) == group).all()


@pytest.mark.parametrize("itemsize,align", [(4, 16), (2, 16), (4, 4),
                                            (2, 2)])
def test_every_path_covers_each_edge_head_and_feature_once(itemsize, align):
    # head widths from 1 to 300 at 1 and 4 heads, and every width up to 64
    # at any number of heads
    cases = {(f, h) for f in range(1, 301) for h in (1, 4)}
    cases |= {(f // h, h) for f in range(1, 65) for h in range(1, f + 1)
              if f % h == 0}
    for feat, heads in sorted(cases):
        _check(feat, heads, itemsize, align)


def test_gat_and_reddit_widths_take_32_bytes_a_lane():
    # arxiv's GAT: 4 heads of 16 (two 16-byte loads a lane, 2 lanes a head,
    # 4 edges a pass) and 1 head of 7 (an edge a lane, 8 lanes a row)
    assert S.sddmm_path(16, 4, 4) == (4, 2, 2, 4, 32)
    assert S.sddmm_path(7, 1, 4) == (1, 8, 1, 1, 8)
    assert S.sddmm_path(16, 4, 2) == (8, 2, 1, 4, 32)   # bf16: a head a lane
    # the Reddit storage's non-cell edges: F = 64 and 41, one head
    assert S.sddmm_path(64, 1, 4) == (4, 2, 8, 1, 32)
    assert S.sddmm_path(41, 1, 4) == (1, 4, 16, 1, 32)  # scalars: 16 B a lane
    # an odd head past 32 lanes' 4 elements runs in chunks
    vec, k, q, _, _ = S.sddmm_path(259, 1, 4)
    assert (vec, q) == (1, 32) and -(-259 // (q * k)) == 3


@pytest.mark.parametrize("itemsize,align", [(4, 16), (2, 16), (4, 4)])
def test_scalar_loads_go_to_one_warp_a_row(itemsize, align):
    # the group mapping wherever it loads vectors, one warp a row wherever
    # it would load scalars
    for feat in range(1, 301):
        for heads in (1, 4):
            path = S.sddmm_path(feat, heads, itemsize, align)
            picked = S.pick_sddmm(feat, heads, itemsize, align)
            assert picked == (S.WARP_PER_ROW if path[0] == 1 else path)
    # the timed shapes on each side: arxiv's GAT H=4 F=16 and the Reddit
    # non-cell edges at F = 64 take the group mapping, H=1 F=7 and F = 41
    # one warp a row
    assert S.pick_sddmm(16, 4, 4) == S.sddmm_path(16, 4, 4)
    assert S.pick_sddmm(64, 1, 4) == S.sddmm_path(64, 1, 4)
    assert S.pick_sddmm(7, 1, 4) == S.WARP_PER_ROW
    assert S.pick_sddmm(41, 1, 4) == S.WARP_PER_ROW
