"""The port's CSR containers and transforms against the JAX package's.

Same inputs, made with numpy from a seed, go through `dgsparse_tpu` and
`dgsparse_tpu_torch`; every structure array must be equal exactly.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.core import transform as jx_T
from dgsparse_tpu.utils.testing import random_csr
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.core import transform as pt_T

REPO = Path(__file__).resolve().parents[1]

_ARRAYS = ("rowptr", "col", "colptr", "row", "csr2csc", "coo_row", "csc_col")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_storage(p, j):
    assert p.sparse_sizes() == j.sparse_sizes()
    assert p.nnz == j.nnz
    assert p.has_value == j.has_value
    for name in _ARRAYS:
        a = _np(getattr(p.storage, name)())
        b = np.asarray(getattr(j.storage, name)())
        assert a.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    pv, jv = p.storage.values(), j.storage.values()
    assert (pv is None) == (jv is None)
    if pv is not None:
        np.testing.assert_array_equal(_np(pv), np.asarray(jv))


def _edges(seed, m=60, n=45, nnz=300):
    """Unsorted COO edges with duplicates, plus edge values."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, m, nnz), rng.integers(0, n, nnz)])
    ei = ei.astype(np.int32)
    ei[:, 10:20] = ei[:, :10]                     # exact duplicates
    return ei, rng.standard_normal(nnz).astype(np.float32)


@pytest.mark.parametrize("has_value", [True, False])
@pytest.mark.parametrize("shape", [(120, 90), (80, 150)])
def test_from_csr_matches_jax(shape, has_value):
    m, n = shape
    rowptr, col, values = random_csr(m, n, avg_degree=5.0, seed=m + n)
    v = values if has_value else None
    p = pt.SparseTensor.from_csr(
        rowptr, col, None if v is None else torch.from_numpy(v),
        sparse_sizes=(m, n))
    j = jx.SparseTensor.from_csr(
        jnp.asarray(rowptr), jnp.asarray(col),
        None if v is None else jnp.asarray(v), sparse_sizes=(m, n))
    assert_same_storage(p, j)
    assert_same_storage(p.t(), j.t())
    np.testing.assert_array_equal(_np(p.to_dense()), np.asarray(j.to_dense()))
    np.testing.assert_array_equal(_np(p.values_or_ones()),
                                  np.asarray(j.values_or_ones()))


@pytest.mark.parametrize("sized", [True, False])
def test_from_edge_index_matches_jax(sized):
    ei, attr = _edges(1)
    sizes = (70, 50) if sized else None
    p = pt.SparseTensor.from_edge_index(ei, torch.from_numpy(attr),
                                        sparse_sizes=sizes)
    j = jx.SparseTensor.from_edge_index(jnp.asarray(ei), jnp.asarray(attr),
                                        sparse_sizes=sizes)
    assert_same_storage(p, j)
    assert_same_storage(p.t(), j.t())
    # duplicates add in to_dense
    np.testing.assert_array_equal(_np(p.to_dense()), np.asarray(j.to_dense()))


def test_from_dense_and_scipy_match_jax():
    rng = np.random.default_rng(2)
    mat = rng.standard_normal((40, 30)).astype(np.float32)
    mat[rng.random(mat.shape) < 0.8] = 0
    assert_same_storage(pt.SparseTensor.from_dense(mat),
                        jx.SparseTensor.from_dense(mat))
    sp = scipy.sparse.random(50, 35, density=0.1, random_state=3,
                             dtype=np.float32, format="coo")
    assert_same_storage(pt.SparseTensor.from_scipy(sp),
                        jx.SparseTensor.from_scipy(sp))


def test_ftransform_matches_jax():
    rowptr, col, values = random_csr(90, 70, avg_degree=4.0, seed=4)
    p = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                 sparse_sizes=(90, 70))
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 jnp.asarray(values), sparse_sizes=(90, 70))
    for a, b in zip(pt.ftransform.csr2csc(p), jx.ftransform.csr2csc(j)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    for a, b in zip(pt.ftransform.csr2coo(p), jx.ftransform.csr2coo(j)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_transforms_match_jax():
    rowptr, col, values = random_csr(100, 80, avg_degree=6.0, seed=5)
    nnz = len(col)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        _np(pt_T.expand_rowptr(t(rowptr), nnz)),
        np.asarray(jx_T.expand_rowptr(jnp.asarray(rowptr), nnz)))
    for a, b in zip(pt_T.csr2csc(t(rowptr), t(col), t(values), 80),
                    jx_T.csr2csc(jnp.asarray(rowptr), jnp.asarray(col),
                                 jnp.asarray(values), 80)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    ei, attr = _edges(6)
    for a, b in zip(pt_T.coo2csr(t(ei[0]), t(ei[1]), t(attr), 60),
                    jx_T.coo2csr(jnp.asarray(ei[0]), jnp.asarray(ei[1]),
                                 jnp.asarray(attr), 60)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(pt_T.row_degrees(t(rowptr))),
                                  np.diff(rowptr))


def test_csr2csc_np_matches_jax_native_path():
    # >= 4096 edges: the JAX package takes its native C++ transpose here
    rowptr, col, _ = random_csr(900, 700, avg_degree=8.0, seed=7)
    assert len(col) >= 4096
    for a, b in zip(pt_T.csr2csc_np(rowptr, col, 700),
                    jx_T.csr2csc_np(rowptr, col, 700)):
        np.testing.assert_array_equal(a, b)


def test_bad_inputs_raise():
    rowptr, col, _ = random_csr(10, 10, avg_degree=3.0, seed=8)
    with pytest.raises(TypeError):
        pt.SparseTensor.from_csr(rowptr, col.astype(np.float32))
    with pytest.raises(ValueError):
        pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(10, 2))
    with pytest.raises(ValueError):
        pt.SparseTensor.from_csr(rowptr, col, torch.ones(len(col) + 1))


# a CSR that breaks one invariant each: the kernels walk [rowptr[m],
# rowptr[m + 1]) of col and values unchecked
BAD_CSR = {
    "rowptr past nnz": ([0, 2, 5], [0, 1, 1]),
    "rowptr not starting at 0": ([1, 2, 3], [0, 1, 1]),
    "rowptr decreasing": ([0, 3, 2, 3], [0, 1, 1]),
    "negative column": ([0, 2, 3], [0, -1, 1]),
}


@pytest.mark.parametrize("case", [*BAD_CSR, "jax refuses rowptr past nnz"])
def test_storage_refuses_a_broken_csr(case):
    if case.startswith("jax"):
        rowptr, col = (np.asarray(a, np.int32)
                       for a in BAD_CSR["rowptr past nnz"])
        with pytest.raises(ValueError, match="end at nnz"):
            jx.SparseTensor.from_csr(rowptr, col, np.ones(3, np.float32),
                                     sparse_sizes=(2, 2),
                                     build_plans=False).validate()
        return
    rowptr, col = (np.asarray(a, np.int32) for a in BAD_CSR[case])
    m = len(rowptr) - 1
    with pytest.raises(ValueError, match="rowptr|col"):
        pt.SparseTensor.from_csr(rowptr, col, torch.ones(len(col)),
                                 sparse_sizes=(m, 2))
    with pytest.raises(ValueError, match="rowptr|col"):
        pt.Storage(rowptr=torch.from_numpy(rowptr),
                   col=torch.from_numpy(col))


def test_import_pulls_in_no_jax():
    code = ("import sys, dgsparse_tpu_torch, dgsparse_tpu_torch.entry, "
            "dgsparse_tpu_torch.nn, dgsparse_tpu_torch.utils.bench, "
            "dgsparse_tpu_torch.kernels.spmm_csr, "
            "dgsparse_tpu_torch.kernels.spmm_maxmin, "
            "dgsparse_tpu_torch.ops.gspmm, dgsparse_tpu_torch.ops.segment, "
            "dgsparse_tpu_torch.ops.spmm_coo, dgsparse_tpu_torch.nn.gin, "
            "dgsparse_tpu_torch.nn.sage, dgsparse_tpu_torch.nn.edgeconv, "
            "dgsparse_tpu_torch.utils.testing, "
            "dgsparse_tpu_torch.core.planner, dgsparse_tpu_torch.ops.hybrid, "
            "dgsparse_tpu_torch.kernels.spmm_cells, "
            "dgsparse_tpu_torch.kernels.spmm_bell, "
            "dgsparse_tpu_torch.kernels.spconv, "
            "dgsparse_tpu_torch.ops.spconv, "
            "dgsparse_tpu_torch.nn.sparse_conv, dgsparse_tpu_torch.nn.unet, "
            "dgsparse_tpu_torch.kernels._build, "
            "dgsparse_tpu_torch.native, dgsparse_tpu_torch.core.reorder, "
            "dgsparse_tpu_torch.utils.debug, "
            "dgsparse_tpu_torch.utils.metrics, "
            "dgsparse_tpu_torch.utils.stats, dgsparse_tpu_torch.utils.tune, "
            "dgsparse_tpu_torch.utils.checkpoint, "
            "dgsparse_tpu_torch.dist, dgsparse_tpu_torch.dist.gcn, "
            "dgsparse_tpu_torch.dist.gat, dgsparse_tpu_torch.dist.launch, "
            "dgsparse_tpu_torch.dist.cases; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'dgsparse_tpu.', 'flax'))"
            " or m == 'dgsparse_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_to_moves_every_tensor():
    rowptr, col, values = random_csr(30, 20, avg_degree=3.0, seed=9)
    p = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                 sparse_sizes=(30, 20))
    moved = p.to("meta")
    assert moved.device.type == "meta" and p.device.type == "cpu"
    assert moved.sparse_sizes() == p.sparse_sizes() and moved.has_value
    for name in _ARRAYS + ("values",):
        assert getattr(moved.storage, name)().device.type == "meta", name


@pytest.mark.parametrize("transposed", [False, True])
def test_csc_slot_inverts_csr2csc(transposed):
    # the max/min backward writes its winner masks at csc_slot[e], the CSC
    # slot of CSR edge e; a transpose's slots are the original's CSR ids
    rowptr, col, _ = random_csr(40, 30, avg_degree=4.0, seed=3)
    p = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(40, 30))
    st = (p.t() if transposed else p).storage
    perm, slot = st.csr2csc().long(), st.csc_slot().long()
    nnz = torch.arange(st.nnz)
    assert st.csc_slot().dtype == torch.int32
    assert torch.equal(perm[slot], nnz) and torch.equal(slot[perm], nnz)
    # CSR edge e sits at its CSC slot: same row, same column
    assert torch.equal(st.row().long()[slot], st.coo_row().long())
    assert torch.equal(st.csc_col().long()[slot], st.col().long())
