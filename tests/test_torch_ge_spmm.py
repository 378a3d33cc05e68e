"""The port's GE-SpMM C-API surface (`ge_spmm.py`) against the JAX
package's, on `tests/test_ge_spmm.py`'s cases.

Results at 1e-4 against the JAX function and the numpy oracle, as
`tests/test_ge_spmm.py` holds JAX's; the heuristic's choices exactly.
The JAX package's lane-packed ELL case for tiny widths is a TPU layout
with no counterpart; an odd tiny width (7) runs here through every
algorithm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgsparse_tpu import ge_spmm as jx_ge
from dgsparse_tpu.utils.testing import random_csr, spmm_oracle
from dgsparse_tpu_torch import ge_spmm
from dgsparse_tpu_torch.ops import spmm as spmm_ops
from dgsparse_tpu_torch.utils.testing import hybrid_csr

TOL = dict(rtol=1e-4, atol=1e-4)


def make(seed=0, m=180, n=150, f=24):
    rowptr, col, vals = random_csr(m, n, avg_degree=5, seed=seed)
    rng = np.random.default_rng(seed + 1)
    B = rng.standard_normal((n, f)).astype(np.float32)
    t = ge_spmm.SpMatCsrDescr_t(
        nrow=m, ncol=n, nnz=len(col), indptr=torch.from_numpy(rowptr),
        indices=torch.from_numpy(col), data=torch.from_numpy(vals))
    j = jx_ge.SpMatCsrDescr_t(
        nrow=m, ncol=n, nnz=len(col), indptr=jnp.asarray(rowptr),
        indices=jnp.asarray(col), data=jnp.asarray(vals))
    return t, j, rowptr, col, vals, B


@pytest.mark.parametrize("f", [7, 24])
def test_all_algs_match_jax_and_the_oracle(f):
    t, j, rowptr, col, vals, B = make(f, f=f)
    ref = spmm_oracle(rowptr, col, vals, B, "sum")
    assert [a.value for a in ge_spmm.GespmmAlg] == \
        [a.value for a in jx_ge.GespmmAlg]
    for alg in ge_spmm.GespmmAlg:
        out = ge_spmm.gespmmCsrSpMM(t, torch.from_numpy(B), alg).numpy()
        np.testing.assert_allclose(out, ref, **TOL, err_msg=alg.name)
        jout = jx_ge.gespmmCsrSpMM(j, jnp.asarray(B), jx_ge.GespmmAlg(
            alg.value))
        np.testing.assert_allclose(out, np.asarray(jout), **TOL,
                                   err_msg=alg.name)


def test_non_transpose_layout():
    t, j, rowptr, col, vals, B = make(2)
    Bt = B.T.copy()
    out = ge_spmm.gespmmCsrSpMM(t, torch.from_numpy(Bt), transpose=False)
    assert out.shape == (B.shape[1], 180)
    np.testing.assert_allclose(out.numpy(),
                               spmm_oracle(rowptr, col, vals, B, "sum").T,
                               **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jx_ge.gespmmCsrSpMM(
        j, jnp.asarray(Bt), transpose=False)), **TOL)


def test_alg_sel_matches_the_reference_heuristic():
    for n in (1, 2, 4, 5, 16, 31, 32, 64, 1024):
        for transpose in (True, False):
            assert ge_spmm.gespmmAlgSel(n, transpose).value == \
                jx_ge.gespmmAlgSel(n, transpose).value, (n, transpose)
    assert ge_spmm.gespmmAlgSel(64) == \
        ge_spmm.GespmmAlg.ROWCACHING_ROWBALANCE
    assert ge_spmm.gespmmAlgSel(16) == ge_spmm.GespmmAlg.SEQREDUCE_ROWBALANCE
    assert ge_spmm.gespmmAlgSel(2) == ge_spmm.GespmmAlg.PARREDUCE_ROWBALANCE


def test_legacy_aliases_and_the_coo_entry():
    t, j, rowptr, col, vals, B = make(3)
    Bt = torch.from_numpy(B)
    np.testing.assert_allclose(ge_spmm.spmm_cuda(t, Bt).numpy(),
                               spmm_oracle(rowptr, col, vals, B, "sum"),
                               **TOL)
    out = ge_spmm.spmm_cuda_no_edge_value(t, Bt).numpy()
    np.testing.assert_allclose(out, spmm_oracle(rowptr, col, None, B, "sum"),
                               **TOL)
    np.testing.assert_allclose(out, np.asarray(jx_ge.spmm_cuda_no_edge_value(
        j, jnp.asarray(B))), **TOL)
    # the COO entry on shuffled edges, both layouts
    row = np.repeat(np.arange(180, dtype=np.int32), np.diff(rowptr))
    perm = np.random.default_rng(4).permutation(len(col))
    args = (row[perm], col[perm], vals[perm])
    for transpose, b in ((True, B), (False, B.T.copy())):
        out = ge_spmm.cuda_csr_coo_spmm(*(torch.from_numpy(a) for a in args),
                                        torch.from_numpy(b), 180, transpose)
        ref = jx_ge.cuda_csr_coo_spmm(*(jnp.asarray(a) for a in args),
                                      jnp.asarray(b), 180, transpose)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_descriptor_memoizes_and_the_no_value_twin_is_apart():
    t, _, rowptr, col, vals, B = make(8)
    Bt = torch.from_numpy(B)
    valued = ge_spmm.gespmmCsrSpMM(t, Bt).numpy()
    sp = t.to_sparse_tensor()
    assert t.to_sparse_tensor() is sp
    ones = ge_spmm.spmm_cuda_no_edge_value(t, Bt).numpy()
    np.testing.assert_allclose(ones, spmm_oracle(rowptr, col, None, B, "sum"),
                               **TOL)
    assert not np.allclose(ones, valued)
    twin = t._no_value_twin
    assert twin.to_sparse_tensor() is not sp
    ge_spmm.spmm_cuda_no_edge_value(t, Bt)
    assert t._no_value_twin is twin and t.to_sparse_tensor() is sp


def test_row_balance_takes_the_hybrid_tiers(monkeypatch):
    # on a storage with a hybrid plan, DEFAULT and the row-balance
    # algorithms run the tiers; nnz-balance and row caching the CSR kernel
    rowptr, col, vals = hybrid_csr(seed=6)
    n = len(rowptr) - 1
    t = ge_spmm.SpMatCsrDescr_t(n, n, len(col), torch.from_numpy(rowptr),
                                torch.from_numpy(col), torch.from_numpy(vals))
    assert t.to_sparse_tensor().storage.ell_plan() is not None
    calls = []
    real = spmm_ops.spmm_hybrid
    monkeypatch.setattr(spmm_ops, "spmm_hybrid",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    B = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n, 16)).astype(np.float32))
    ref = spmm_oracle(rowptr, col, vals, B.numpy(), "sum")
    for alg in ge_spmm.GespmmAlg:
        calls.clear()
        out = ge_spmm.gespmmCsrSpMM(t, B, alg)
        np.testing.assert_allclose(out.numpy(), ref, **TOL, err_msg=alg.name)
        hybrid = alg.name == "DEFAULT" or (
            alg.name.endswith("REDUCE_ROWBALANCE"))
        assert bool(calls) == hybrid, alg.name
