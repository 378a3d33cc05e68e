"""The CSR SpMM kernel's path choice and the cell SDDMM's chunking, on the
CPU.

`kernels/spmm_csr.py::spmm_path` picks (vec, group, nv) for the kernel of
`csrc/spmm_csr.cu`: `vec` elements a load, `group` lanes a row, `nv`
vectors a lane. `_covered` repeats the kernel's index arithmetic (rows per
warp, lanes per row, feature slices on gridDim.y) so that these tests can
hold every path to what the kernel needs: each (row, feature) summed by
exactly one lane, no vector straddling two heads, no load wider than 16
bytes or than the pointers' alignment.
"""

import numpy as np
import pytest

from dgsparse_tpu_torch.kernels import spmm_cells, spmm_csr

WARP, WARPS = 32, 8           # lanes a warp, warps a block (common.cuh)
ROWS = 37                     # a few rows: more than one block's worth at
                              # 4 lanes a row, and a ragged last block


def _covered(path, feat, rows=ROWS):
    """(row, first feature, vec) of every vector the launch loads and
    stores, as the kernel computes them from its block and lane."""
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
    return row[keep], f[keep]


@pytest.mark.parametrize("itemsize,align", [(4, 16), (2, 16), (4, 4),
                                            (2, 2)])
def test_every_path_covers_each_feature_once_within_a_head(itemsize, align):
    for feat in range(1, 321):
        seen = {}
        for heads in [h for h in range(1, feat + 1) if feat % h == 0]:
            vec, group, nv = path = spmm_csr.spmm_path(feat, heads,
                                                       itemsize, align)
            if path not in seen:
                assert group in spmm_csr.GROUPS
                assert 1 <= nv <= spmm_csr.max_vectors(vec, itemsize)
                assert vec * itemsize <= min(16, align)
                row, f = _covered(path, feat)
                flat = (row * feat + f)[:, None] + np.arange(vec)
                count = np.bincount(flat.ravel(), minlength=ROWS * feat)
                assert (count == 1).all(), (feat, heads, path)
                seen[path] = f
            f = seen[path]
            head_feat = feat // heads
            assert (f // head_feat == (f + vec - 1) // head_feat).all(), \
                (feat, heads, path)


def test_narrow_widths_take_one_pass_over_each_row():
    # one group of lanes spans the row: the row's edges are read once
    for feat, path in ((40, (4, 16, 1)), (41, (1, 16, 3)), (7, (1, 8, 1)),
                       (64, (4, 16, 1))):
        assert spmm_csr.spmm_path(feat, 1, 4) == path
        vec, group, nv = path
        assert group * nv * vec >= feat
    # four heads of 16: 16-byte loads, each inside one head
    assert spmm_csr.spmm_path(64, 4, 4) == (4, 16, 1)
    # F = 256: one 16-byte vector a lane, a warp a row, in two slices
    assert spmm_csr.spmm_path(256, 1, 4) == (4, 32, 1)


def test_sddmm_chunks_cover_every_cell_in_one_wave():
    for cells in (1, 24, 263, 264, 265, 6332, 65536):
        for sms in (1, 132):
            chunk = spmm_cells.cells_per_cta(cells, sms)
            ctas = -(-cells // chunk)
            assert chunk >= 1 and ctas * chunk >= cells
            assert ctas <= spmm_cells.CTAS_PER_SM * sms
