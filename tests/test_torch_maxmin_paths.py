"""The max/min SpMM forward's path choice, on the CPU.

`kernels/spmm_maxmin.py::maxmin_path` picks (vec, group, nv) for the
forward kernel of `csrc/spmm_maxmin.cu`: `vec` elements a load, `group`
lanes a row, `nv` vectors a lane, so a feature slice of group * nv * vec
features, the grid's slowest dimension. `_covered` repeats the kernel's
index arithmetic (rows per warp, lanes per row, slices on gridDim.y) so
that these tests can hold every path to what the kernel needs: each
(row, feature) reduced by exactly one lane, no vector straddling two
heads, slices that keep heads whole or lie inside one, and, at the GIN
path's arxiv shape, one slice of X small enough to stay in L2.
"""

import numpy as np
import pytest

from dgsparse_tpu_torch.kernels import spmm_csr
from dgsparse_tpu_torch.kernels import spmm_maxmin as M

WARP, WARPS = 32, 8           # lanes a warp, warps a block (common.cuh)
ROWS = 37                     # a ragged last block at every group width
ARXIV_ROWS = 169_343          # entry.CONFIGS["arxiv"]
L2_BYTES = 50 * 2 ** 20       # an H100's L2


def _covered(path, feat, rows=ROWS):
    """(row, slice, first feature) of every vector the launch reduces, as
    the kernel computes them from its block and lane."""
    vec, group, nv = path
    per_warp = WARP // group
    grid_x = -(-rows // (WARPS * per_warp))
    grid_y = -(-feat // (group * nv * vec))
    bx, by, warp, lane, v = np.meshgrid(
        np.arange(grid_x), np.arange(grid_y), np.arange(WARPS),
        np.arange(WARP), np.arange(nv), indexing="ij")
    row = (bx * WARPS + warp) * per_warp + lane // group
    f = ((by * nv + v) * group + lane % group) * vec
    keep = (row < rows) & (f < feat)
    return row[keep], by[keep], f[keep]


def _check(path, feat, heads, itemsize, align):
    vec, group, nv = path
    assert group in spmm_csr.GROUPS and 1 <= nv <= M.MAX_VECTORS
    assert vec * itemsize <= min(16, align)
    row, sl, f = _covered(path, feat)
    flat = (row * feat + f)[:, None] + np.arange(vec)
    count = np.bincount(flat.ravel(), minlength=ROWS * feat)
    assert (count == 1).all(), (feat, heads, path)
    head_feat = feat // heads
    assert (f // head_feat == (f + vec - 1) // head_feat).all(), \
        (feat, heads, path)
    return sl, f


def _slice_heads(sl, f, vec, head_feat):
    """Per slice: (first head, last head, whole heads) of its features."""
    out = {}
    for s in np.unique(sl):
        fs = f[sl == s]
        lo, hi = fs.min(), fs.max() + vec           # [lo, hi) features
        out[int(s)] = (lo // head_feat, (hi - 1) // head_feat,
                       lo % head_feat == 0 and hi % head_feat == 0)
    return out


@pytest.mark.parametrize("itemsize,align", [(4, 16), (2, 16), (4, 4),
                                            (2, 2)])
def test_every_path_covers_each_feature_once_within_a_head(itemsize, align):
    for feat in range(1, 321):
        for heads in [h for h in range(1, feat + 1) if feat % h == 0]:
            path = M.maxmin_path(feat, heads, itemsize, align)
            _check(path, feat, heads, itemsize, align)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_slices_keep_heads_whole_or_lie_inside_one(itemsize):
    # wherever the head width is a power-of-two count of vectors (every
    # width the models use), a slice holds whole heads or lies in one head
    for feat in range(1, 513):
        for heads in [h for h in (1, 2, 4, 8) if feat % h == 0]:
            vec, group, nv = path = M.maxmin_path(feat, heads, itemsize)
            head_vecs = feat // heads // vec
            if head_vecs & (head_vecs - 1):
                continue
            sl, f = _check(path, feat, heads, itemsize, 16)
            for first, last, whole in _slice_heads(
                    sl, f, vec, feat // heads).values():
                assert first == last or whole, (feat, heads, path)
            assert not M.slices_cross_heads(group * nv, feat // vec, heads)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("feat", [128, 256])
def test_a_slice_of_arxiv_features_stays_in_l2(feat, itemsize):
    vec, group, nv = M.maxmin_path(feat, 1, itemsize)
    slice_bytes = group * nv * vec * itemsize
    assert slice_bytes <= M.SLICE_BYTES
    assert ARXIV_ROWS * slice_bytes < L2_BYTES


def test_narrow_and_multihead_widths_take_valid_paths():
    # F = 7 and 41 (odd: scalar loads), 4 heads of 16
    for feat, heads, itemsize, want in ((7, 1, 4, (1, 8, 1)),
                                        (41, 1, 4, (1, 32, 2)),
                                        (41, 1, 2, (1, 32, 2)),
                                        (64, 4, 4, (2, 32, 1)),
                                        (64, 4, 2, (2, 32, 1))):
        path = M.maxmin_path(feat, heads, itemsize)
        assert path == want, (feat, heads, itemsize, path)
        sl, f = _check(path, feat, heads, itemsize, 16)
        slices = _slice_heads(sl, f, path[0], feat // heads)
        assert all(a == b or whole for a, b, whole in slices.values())
    # the GIN path's widths: one row a warp over 256-byte slices (p2p's
    # 32 features: the whole 128-byte row)
    assert M.maxmin_path(32, 1, 4) == (1, 32, 1)
    assert M.maxmin_path(128, 1, 4) == M.maxmin_path(256, 1, 4) == (2, 32, 1)
    assert M.maxmin_path(256, 1, 2) == (4, 32, 1)
