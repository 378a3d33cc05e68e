"""The port's RCM reordering (`core/reorder.py`) against the JAX package's
on `tests/test_reorder.py`'s geometric graphs: the permutation, the
permuted CSR and the bandwidth equal JAX's exactly (both run the same
stable sorts), and the SpMM of the permuted graph is the permuted SpMM.
`utils/testing.py::geometric_graph`, the k-d tree copy of the test's
generator that `chip_smoke.py` runs at 10^5 nodes, gives the same graph.
"""

import numpy as np
import pytest
import torch

from dgsparse_tpu.core import reorder as jx_reorder
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.core import reorder
from dgsparse_tpu_torch.utils.testing import assert_sum_close, geometric_graph
from tests.test_reorder import geometric_graph as jx_geometric_graph


@pytest.mark.parametrize("seed", [0, 3])
def test_geometric_graph_is_the_tests(seed):
    for got, want in zip(geometric_graph(seed=seed),
                         jx_geometric_graph(seed=seed)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_rcm_matches_jax(seed, as_tensor):
    rowptr, col, n = jx_geometric_graph(seed=seed)
    vals = np.random.default_rng(seed + 1).standard_normal(
        len(col)).astype(np.float32)
    perm_j = jx_reorder.rcm_permutation(rowptr, col)
    want = jx_reorder.permute_csr(rowptr, col, vals, perm_j)
    args = (torch.from_numpy(rowptr), torch.from_numpy(col)) if as_tensor \
        else (rowptr, col)
    perm = reorder.rcm_permutation(*args)
    assert perm.dtype == perm_j.dtype
    np.testing.assert_array_equal(perm, perm_j)
    v = torch.from_numpy(vals) if as_tensor else vals
    got = reorder.permute_csr(*args, v, perm)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert reorder.bandwidth(*args) == jx_reorder.bandwidth(rowptr, col)
    assert reorder.bandwidth(got[0], got[1]) == \
        jx_reorder.bandwidth(want[0], want[1])
    assert reorder.bandwidth(got[0], got[1]) < 0.5 * reorder.bandwidth(
        rowptr, col)


def test_permuted_spmm_is_the_permuted_spmm():
    rowptr, col, n = geometric_graph(seed=3)
    rng = np.random.default_rng(4)
    vals = rng.standard_normal(len(col)).astype(np.float32)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    sp = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                                  sparse_sizes=(n, n))
    out = pt.spmm_sum(sp, torch.from_numpy(x))
    perm = reorder.rcm_permutation(rowptr, col)
    rp2, col2, vals2 = reorder.permute_csr(rowptr, col, vals, perm)
    sp2 = pt.SparseTensor.from_csr(rp2, col2, torch.from_numpy(vals2),
                                   sparse_sizes=(n, n))
    out2 = pt.spmm_sum(sp2, torch.from_numpy(x[perm]))
    abs_sum = pt.spmm_sum(sp.set_values(sp.storage.values().abs()),
                          torch.from_numpy(np.abs(x)))
    idx = torch.from_numpy(perm).long()
    assert_sum_close(out2, out[idx], abs_sum[idx], 1e-5)
