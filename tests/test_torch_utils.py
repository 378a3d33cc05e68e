"""The port's validation, dispatch counters, degree statistics, MatrixMarket
reader and checkpoints against the JAX package's, on the same seeded
inputs.

- `SparseTensor.validate()`, `.shape` and `Storage.degrees()`: the same
  corruptions raise the same messages, and the same graphs give the same
  shapes and degrees.
- `utils/debug.py`: with validation on, `spmm`, `sddmm` and `gspmm` raise
  JAX's message on JAX's corruption case (`tests/test_utils_cov.py:108`)
  before any kernel runs; the environment switch turns it on.
- `utils/metrics.py`: the same calls record the same op names, tag keys,
  counts and routes (`alg`) in both packages.
- `utils/stats.py::degree_stats` gives JAX's dict; `load_mtx` JAX's arrays.
- `utils/checkpoint.py`: the round trip of `tests/test_misc.py:46`, and a
  trainer resumed from a checkpoint equal to one that never stopped.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.utils import debug as jx_debug
from dgsparse_tpu.utils import metrics as jx_metrics
from dgsparse_tpu.utils import stats as jx_stats
from dgsparse_tpu.utils import testing as jx_testing
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch import entry
from dgsparse_tpu_torch.kernels import spmm_csr
from dgsparse_tpu_torch.utils import checkpoint, debug, metrics, stats
from dgsparse_tpu_torch.utils.testing import load_mtx, random_csr

REPO = Path(__file__).resolve().parents[1]


def _pair(m=60, n=50, seed=1, values=True):
    rowptr, col, vals = random_csr(m, n, avg_degree=6.0, seed=seed)
    v = vals if values else None
    j = jx.SparseTensor.from_csr(
        jnp.asarray(rowptr), jnp.asarray(col),
        None if v is None else jnp.asarray(v), sparse_sizes=(m, n))
    p = pt.SparseTensor.from_csr(
        rowptr, col, None if v is None else torch.from_numpy(v),
        sparse_sizes=(m, n), build_plans=False)
    return j, p


# each corruption after construction, as (field, JAX array) of the storage
CORRUPTIONS = {
    "rowptr_start": ("_rowptr", lambda rp, c: np.r_[1, rp[1:]]),
    "rowptr_end": ("_rowptr", lambda rp, c: np.r_[rp[:-1], rp[-1] - 1]),
    "rowptr_decreasing": ("_rowptr",
                          lambda rp, c: np.r_[rp[:1], rp[-1], rp[2:]]),
    "col_too_big": ("_col", lambda rp, c: np.r_[c[:-1], 50]),
    "col_negative": ("_col", lambda rp, c: np.r_[-1, c[1:]]),
    "values_length": ("_values", None),
}


def _corrupt(j, p, case):
    field, fn = CORRUPTIONS[case]
    if fn is None:
        j.storage._values = j.storage._values[:-1]
        p.storage._values = p.storage._values[:-1]
        return
    rp = np.asarray(j.storage.rowptr())
    c = np.asarray(j.storage.col())
    bad = fn(rp, c).astype(np.int32)
    setattr(j.storage, field, jnp.asarray(bad))
    setattr(p.storage, field, torch.from_numpy(bad))


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_validate_raises_jax_messages(case):
    j, p = _pair()
    assert p.validate() is p and j.validate() is j
    _corrupt(j, p, case)
    assert _message(p.validate) == _message(j.validate)


@pytest.mark.parametrize("shape", [(60, 50), (30, 80)])
def test_shape_and_degrees_match_jax(shape):
    j, p = _pair(*shape, seed=shape[1])
    assert p.shape == j.shape == shape
    deg = p.storage.degrees()
    assert deg.dtype == torch.int32
    np.testing.assert_array_equal(deg.numpy(), np.asarray(j.storage.degrees()))


@pytest.fixture
def validating():
    debug.set_validate(True)
    jx_debug.set_validate(True)
    yield
    debug.set_validate(False)
    jx_debug.set_validate(False)


@pytest.mark.parametrize("op", ["spmm", "sddmm", "gspmm"])
def test_validate_mode_raises_before_any_launch(validating, op):
    """JAX's corruption case: col indices corrupted after construction."""
    rowptr, col = np.array([0, 1, 2], np.int32), np.array([1, 0], np.int32)
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col), None,
                                 sparse_sizes=(2, 2))
    p = pt.SparseTensor.from_csr(rowptr, col, None, sparse_sizes=(2, 2))
    bad = np.array([5, 0], np.int32)
    j.storage._col = jnp.asarray(bad)
    p.storage._col = torch.from_numpy(bad)
    run = {"spmm": lambda m, s, x: m.spmm(s, x, "sum"),
           "sddmm": lambda m, s, x: m.sddmm(s, x, x),
           "gspmm": lambda m, s, x: m.gspmm(s, x, "sum", "mul")}[op]
    want = _message(lambda: run(jx, j, jnp.ones((2, 4), jnp.float32)))
    assert want.startswith("col indices out of range")
    spmm_csr.reset_launch_counts()
    assert _message(lambda: run(pt, p, torch.ones(2, 4))) == want
    assert spmm_csr.LAUNCHES["csr_spmm"] == 0


def test_validate_env_switch():
    code = ("from dgsparse_tpu_torch.utils import debug; "
            "assert debug.validate_enabled()")
    env = {**os.environ, "DGSPARSE_TPU_VALIDATE": "1"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    assert not debug.validate_enabled()


def _run_ops(mod, sp, x, d1):
    mod.spmm(sp, x, "sum")
    mod.spmm(sp, x, "sum")
    mod.spmm(sp, x, "max")
    mod.spmm(sp, x, "mean", mod.Algorithm.XLA_SEGMENT)
    mod.sddmm(sp, d1, x)
    mod.sddmm(sp, d1, x, "mean", "xla")
    mod.gspmm(sp, x, "sum", "add")
    mod.gspmm(sp, x, "max", "mul")


def _recorded(mod_metrics, run):
    mod_metrics.reset()
    mod_metrics.enable()
    try:
        run()
    finally:
        mod_metrics.disable()
    got = mod_metrics.counters()
    mod_metrics.reset()
    # cached_values says whether JAX's slot caches or the port's hybrid
    # tier values were used: two different things
    return {tuple(t for t in k if t[0] != "cached_values"): n
            for k, n in got.items()}


def test_metrics_match_jax():
    j, p = _pair()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    d1 = rng.standard_normal((60, 8)).astype(np.float32)
    want = _recorded(jx_metrics, lambda: _run_ops(
        jx, j, jnp.asarray(x), jnp.asarray(d1)))
    got = _recorded(metrics, lambda: _run_ops(
        pt, p, torch.from_numpy(x), torch.from_numpy(d1)))
    assert got == want
    assert sum(got.values()) == 8
    assert metrics.counters() == {}
    assert metrics.summary().startswith("(no dispatches")


def test_metrics_off_records_nothing():
    _, p = _pair()
    metrics.reset()
    pt.spmm(p, torch.ones(50, 4))
    assert metrics.counters() == {}


def test_metrics_show_the_hybrid_route():
    from dgsparse_tpu_torch.utils.testing import hybrid_csr

    rowptr, col, values = hybrid_csr()
    sp = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                  sparse_sizes=(len(rowptr) - 1,) * 2)
    assert sp.storage.ell_plan() is not None
    x = torch.ones(sp.shape[1], 4)
    got = _recorded(metrics, lambda: (
        pt.spmm(sp, x), pt.spmm(sp, x, algorithm=pt.Algorithm.XLA_SEGMENT)))
    algs = {dict(k[1:])["alg"]: n for k, n in got.items()}
    assert algs == {"PALLAS_ROW_TILE": 1, "XLA_SEGMENT": 1}


@pytest.mark.parametrize("empty_rows", [True, False])
def test_degree_stats_match_jax(empty_rows):
    rowptr, _, _ = random_csr(200, 150, avg_degree=7.0, seed=3,
                              with_empty_rows=empty_rows)
    want = jx_stats.degree_stats(jnp.asarray(rowptr))
    assert stats.degree_stats(rowptr) == want
    assert stats.degree_stats(torch.from_numpy(rowptr)) == want


def test_load_mtx_matches_jax(tmp_path):
    path = tmp_path / "tiny.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    "% a tiny matrix, entries out of order\n"
                    "4 5 6\n"
                    "3 2 1.5\n1 4 -2.0\n1 1 3.25\n4 5 0.5\n2 3 7.0\n"
                    "3 1 -1.0\n")
    got, want = load_mtx(str(path)), jx_testing.load_mtx(str(path))
    assert got[3] == want[3] == (4, 5)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    sp = pt.SparseTensor.from_csr(got[0], got[1], torch.from_numpy(got[2]),
                                  sparse_sizes=got[3])
    assert sp.to_dense()[0, 3].item() == -2.0


def test_checkpoint_roundtrip(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "step": torch.tensor(7), "nested": {"b": torch.ones(2)}}
    p = str(tmp_path / "ckpt.pt")
    checkpoint.save(p, state)
    restored = checkpoint.restore(p, template=state)
    torch.testing.assert_close(restored["w"], state["w"], rtol=0, atol=0)
    assert int(restored["step"]) == 7
    template = {"w": torch.zeros(3, 4, dtype=torch.float64),
                "step": torch.tensor(0), "nested": {"b": torch.zeros(2)}}
    cast = checkpoint.restore(p, template=template)
    assert cast["w"].dtype == torch.float64
    np.testing.assert_array_equal(cast["w"].numpy(), state["w"].numpy())


def test_resumed_trainer_equals_uninterrupted(tmp_path):
    """2 steps, save model and Adam state, restore into a fresh trainer,
    then one more step in both: equal parameters, bitwise."""
    model, opt, (adj, x, y) = entry.build_trainer("gcn-cora", seed=0,
                                                  device="cpu")
    for _ in range(2):
        entry.train_step(model, opt, x, adj, y)
    path = str(tmp_path / "trainer.pt")
    checkpoint.save(path, {"model": model.state_dict(),
                           "opt": opt.state_dict()})
    fresh, fresh_opt, _ = entry.build_trainer("gcn-cora", seed=1,
                                              device="cpu",
                                              data=(adj, x, y))
    state = checkpoint.restore(path, template={
        "model": fresh.state_dict(), "opt": fresh_opt.state_dict()})
    fresh.load_state_dict(state["model"])
    fresh_opt.load_state_dict(state["opt"])
    losses = [float(entry.train_step(m, o, x, adj, y))
              for m, o in ((model, opt), (fresh, fresh_opt))]
    assert losses[0] == losses[1]
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), name
