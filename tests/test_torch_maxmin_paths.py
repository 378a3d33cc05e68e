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

The backward's d_dense kernel runs in two passes: a winner-mask pass over
the CSR rows (`_winner_masks` repeats its words, chunks of 32 edges and
ballots) and a column pass over the CSC view on `d_dense_path`
(`_column_terms`). These tests hold the two to the plain definition: each
element an edge won reaches that edge's column exactly once, every mask
word is written exactly once, an edge holds ceil(F / 32) words, and at the
arxiv GIN shape the slice of g being gathered stays in L2.
"""

import numpy as np
import pytest

from dgsparse_tpu_torch.kernels import spmm_csr
from dgsparse_tpu_torch.kernels import spmm_maxmin as M

WARP, WARPS = 32, 8           # lanes a warp, warps a block (common.cuh)
ROWS = 37                     # a ragged last block at every group width
ARXIV_ROWS = 169_343          # entry.CONFIGS["arxiv"]
L2_BYTES = 50 * 2 ** 20       # an H100's L2
BITS = 32                     # features a winner-mask word covers


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


# --- d_dense: the winner-mask pass and the column pass -----------------------

def _skewed_graph(seed, m=70, n=50):
    """CSR (rowptr, col) with empty rows, rows of 33 and 70 edges and one
    column repeated in a row; its CSC view (colptr, row_csc, perm) and
    slot, the CSC slot of each CSR edge."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, m)
    deg[[3, 4, 5, 6]] = [0, 33, 70, 6]
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    col = rng.integers(0, n, rowptr[-1])
    col[rowptr[6]:rowptr[7]] = col[rowptr[6]]    # one column, six edges
    row = np.repeat(np.arange(m), deg)
    perm = np.argsort(col, kind="stable")
    colptr = np.concatenate([[0], np.cumsum(np.bincount(col, minlength=n))])
    slot = np.empty_like(perm)
    slot[perm] = np.arange(len(perm))
    return rowptr, col, row, colptr, row[perm], slot


def _winners(rng, rowptr, feat):
    """arg [M, F]: a random edge of each row (the sentinel nnz in an
    empty row)."""
    m, nnz = len(rowptr) - 1, rowptr[-1]
    deg = np.diff(rowptr)[:, None]
    pick = rowptr[:-1, None] + (rng.random((m, feat)) * deg).astype(int)
    return np.where(deg > 0, pick, nnz)


def _at(w, k, nnz, sw):
    """Flat index of word w of CSC slot k: masks [ceil(W / sw), nnz, sw]."""
    return (w // sw * nnz + k) * sw + w % sw


def _winner_masks(rowptr, slot, arg, feat, sw):
    """The mask pass as the kernel runs it: per row, word and chunk of 32
    edges, lane t's word from the ballots of the places' bits (as many
    as the chunk needs), written at edge t's CSC slot; the flat masks and
    how often each word was written."""
    nnz, words = rowptr[-1], M.mask_words(feat)
    size = -(-words // sw) * nnz * sw
    mask = np.zeros(size, np.int64)
    writes = np.zeros(size, np.int64)
    lane = np.arange(BITS)
    for r in range(len(rowptr) - 1):
        start, end = rowptr[r], rowptr[r + 1]
        if start == end:
            continue
        for w in range(-(-words // sw) * sw):
            f = w * BITS + lane
            a = np.where((w < words) & (f < feat),
                         arg[r, np.minimum(f, feat - 1)], -1)
            for c0 in range(start, end, BITS):
                n = min(BITS, end - c0)
                j = a - c0
                ok = (j >= 0) & (j < n)
                bits = next(b for b in (1, 2, 3, 4, 5) if n <= 1 << b)
                ballot = lambda p: int((p << lane).sum())  # noqa: E731
                mine = np.full(BITS, ballot(ok))
                for b in range(bits):
                    s = ballot(ok & ((j >> b) & 1 == 1))
                    mine &= np.where((lane >> b) & 1 == 1, s, ~s)
                at = _at(w, slot[c0:c0 + n], nnz, sw)
                mask[at] = mine[:n] if w < words else 0
                writes[at] += 1
    return mask, writes


def _column_terms(path, colptr, row_csc, mask, feat):
    """(column, row, feature) of every g element the column pass adds, as
    its lanes read the masks: each lane's vector starts, over every
    slice, and the bits of its word at them."""
    vec, group, nv = path
    sw, nnz = M.slice_words(path), len(row_csc)
    slices = -(-feat // (group * nv * vec))
    f = np.arange(slices * group * nv) * vec
    f = f[f < feat]
    terms = []
    for c in range(len(colptr) - 1):
        for k in range(colptr[c], colptr[c + 1]):
            word = mask[_at(f // BITS, k, nnz, sw)]
            won = (word >> (f % BITS)) & ((1 << vec) - 1)
            for q in range(vec):
                hit = (won >> q) & 1 == 1
                terms += [(c, row_csc[k], x + q) for x in f[hit]]
    return terms


@pytest.mark.parametrize("heads,feat", [(1, 1), (1, 7), (1, 32), (1, 41),
                                        (4, 64), (1, 256), (1, 300)])
def test_d_dense_passes_send_each_won_element_to_its_column_once(heads,
                                                                 feat):
    rowptr, col, row, colptr, row_csc, slot = _skewed_graph(feat)
    arg = _winners(np.random.default_rng(feat + 1), rowptr, feat)
    want = sorted((col[e], row[e], f) for (r, f), e in np.ndenumerate(arg)
                  if e < rowptr[-1])
    for itemsize in (4, 2):
        path = M.d_dense_path(feat, heads, itemsize)
        vec, group, nv = path
        assert vec * itemsize <= 16 and (feat // heads) % vec == 0, path
        assert group in spmm_csr.GROUPS and 1 <= nv <= M.MAX_VECTORS, path
        sw = M.slice_words(path)
        assert sw in (1, 2, 4), path
        mask, writes = _winner_masks(rowptr, slot, arg, feat, sw)
        assert mask.size == -(-M.mask_words(feat) // sw) * sw * rowptr[-1]
        assert (writes == 1).all()     # every word, once: no zero-fill
        got = _column_terms(path, colptr, row_csc, mask, feat)
        assert sorted(got) == want, (feat, heads, path)


def test_a_slice_of_g_for_d_dense_stays_in_l2():
    # the column pass gathers g [M, F] a slice at a time: at the arxiv GIN
    # shape (F = 256) one slice of it fits an H100's L2, in fp32 and bf16
    for itemsize in (4, 2):
        vec, group, nv = M.d_dense_path(256, 1, itemsize)
        assert ARXIV_ROWS * group * nv * vec * itemsize < L2_BYTES
    assert M.d_dense_path(256, 1, 4) == (4, 16, 1)     # 64 features
    assert M.d_dense_path(32, 1, 4) == (4, 8, 1)       # p2p: 4 columns a warp
    # ceil(F / 32) words an edge, sw of them a slice
    assert M.mask_words(256) == 8 and M.mask_words(300) == 10
    assert M.slice_words((4, 16, 1)) == 2 and M.slice_words((4, 8, 1)) == 1


def test_d_dense_takes_the_winner_masks_only_where_they_pay():
    # the arxiv GIN graph's second aggregation (F = 256): 6.4 edges a row,
    # arg 173 MB past L2, masks 35 MB within it
    arxiv_nnz = 1_089_553
    assert M.pick_d_dense(256, 1, 4, 16, arxiv_nnz, ARXIV_ROWS) == (4, 16, 1)
    assert M.pick_d_dense(128, 1, 4, 16, arxiv_nnz, ARXIV_ROWS) == \
        M.d_dense_path(128, 1, 4)
    # p2p-Gnutella31 (2.4 edges a row) and Cora (3.9) at every width
    for rows, nnz in ((62_586, 147_892), (2_708, 10_556)):
        for feat in (7, 32, 64, 256, 300):
            assert M.pick_d_dense(feat, 1, 4, 16, nnz, rows) == \
                M.WARP_PER_COLUMN
    # each condition alone turns the masks down: rows shorter than
    # MASK_MIN_DEGREE, arg within 1.5 L2s (F = 64 at arxiv: 43 MB), masks
    # past L2 (12 edges a row at F = 256: 62 MB)
    short = M.MASK_MIN_DEGREE * ARXIV_ROWS - 1
    assert M.pick_d_dense(256, 1, 4, 16, short, ARXIV_ROWS) == \
        M.WARP_PER_COLUMN
    assert M.pick_d_dense(256, 1, 4, 16, short + 1, ARXIV_ROWS) != \
        M.WARP_PER_COLUMN
    assert M.pick_d_dense(64, 1, 4, 16, arxiv_nnz, ARXIV_ROWS) == \
        M.WARP_PER_COLUMN
    assert 4 * 8 * 12 * ARXIV_ROWS > L2_BYTES
    assert M.pick_d_dense(256, 1, 4, 16, 12 * ARXIV_ROWS, ARXIV_ROWS) == \
        M.WARP_PER_COLUMN
