"""The port's route tuner (`utils/tune.py`) and its use by `spmm`'s AUTO.

- The structure hash equals JAX's `Storage._tune_key` for the same graph
  (both hash the int32 arrays), and a transpose has none, as in JAX.
- `tune_spmm` on `utils/testing.py::hybrid_csr()` times the port's two
  routes, forward and with the backward, persists the winner, and a fresh
  load returns it.
- AUTO follows a cached entry: a cached XLA_SEGMENT on a hybrid storage
  runs the CSR kernel (the metrics show it); an entry of another backend
  is not matched; with nothing tuned the lookup builds no key.
- `chip_smoke.run` tunes into a temporary cache of its own.
Every test keeps the cache in its own `tmp_path`.
"""

import importlib.util
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgsparse_tpu as jx
from dgsparse_tpu.utils import tune as jx_tune
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.ops.types import Algorithm
from dgsparse_tpu_torch.utils import metrics, tune
from dgsparse_tpu_torch.utils.testing import hybrid_csr, random_csr

ITERS = (1, 2)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("DGSPARSE_TUNE_CACHE", str(path))
    monkeypatch.setattr(tune, "_CACHE", None)
    return path


def _hybrid():
    rowptr, col, values = hybrid_csr()
    n = len(rowptr) - 1
    sp = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                  sparse_sizes=(n, n))
    assert sp.storage.ell_plan() is not None
    return sp


@pytest.mark.parametrize("shape", [(200, 150), (90, 300)])
def test_structure_key_matches_jax(shape):
    rowptr, col, values = random_csr(*shape, avg_degree=5.0, seed=shape[0])
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 jnp.asarray(values), sparse_sizes=shape)
    p = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                 sparse_sizes=shape)
    assert tune.structure_key(p) == p.storage._tune_key \
        == j.storage._tune_key
    assert p.t().storage._tune_key is None
    assert tune.structure_key(p.t()) == jx_tune.structure_key(j.t())
    assert p.set_values(None).storage._tune_key == p.storage._tune_key


def test_structure_key_samples_large_arrays():
    """Past 65,536 entries the hash samples at a stride, as JAX's does."""
    rowptr, col, values = random_csr(70000, 300, avg_degree=2.0, seed=1)
    j = jx.SparseTensor.from_csr(jnp.asarray(rowptr), jnp.asarray(col),
                                 None, sparse_sizes=(70000, 300))
    p = pt.SparseTensor.from_csr(rowptr, col, None,
                                 sparse_sizes=(70000, 300), build_plans=False)
    assert p.storage._tune_key == j.storage._tune_key


@pytest.mark.parametrize("with_grad", [False, True])
def test_tune_spmm_times_both_routes_and_persists(cache, with_grad):
    sp = _hybrid()
    best, times = tune.tune_spmm(sp, 8, with_grad=with_grad, iters=ITERS)
    assert set(times) == {Algorithm.XLA_SEGMENT, Algorithm.PALLAS_ROW_TILE}
    assert best == min(times, key=times.get)
    saved = json.loads(cache.read_text())
    (key, entry), = saved.items()
    assert key.endswith(f"|f8|sum|cpu|{'trained' if with_grad else 'fwd'}")
    assert entry["alg"] == best.name
    tune._CACHE = None                      # a fresh process's first load
    assert tune.cached_algorithm(sp, 8, with_grad=with_grad) == best
    again, t2 = tune.tune_spmm(sp, 8, with_grad=with_grad, iters=ITERS)
    assert again == best and set(t2) == set(times)


def test_single_route_cases(cache):
    sp = _hybrid()
    _, times = tune.tune_spmm(sp, 4, "max", iters=ITERS)
    assert set(times) == {Algorithm.XLA_SEGMENT}
    rowptr, col, values = random_csr(100, 100, seed=2)
    plain = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                     sparse_sizes=(100, 100))
    report = tune.tune_report(plain, feats=(4, 8))
    assert report.count("best=XLA_SEGMENT") == 2


def _spmm_route(sp, x):
    metrics.reset()
    metrics.enable()
    try:
        out = pt.spmm(sp, x)
    finally:
        metrics.disable()
    (key,), = [list(metrics.counters())]
    metrics.reset()
    return out, dict(key[1:])["alg"]


def _write_entry(cache, sp, feat, alg, backend="cpu"):
    key = f"{tune.structure_key(sp)}|f{feat}|sum|{backend}|fwd"
    cache.write_text(json.dumps({key: {"alg": alg, "times_us": {}}}))
    tune._CACHE = None


def test_auto_follows_a_cached_route(cache):
    sp = _hybrid()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (sp.shape[1], 8)).astype(np.float32))
    hybrid, alg = _spmm_route(sp, x)
    assert alg == "PALLAS_ROW_TILE"             # the gate, no entry
    _write_entry(cache, sp, 8, "XLA_SEGMENT")
    csr, alg = _spmm_route(sp, x)
    assert alg == "XLA_SEGMENT"
    torch.testing.assert_close(csr, hybrid, rtol=1e-5, atol=1e-4)
    assert _spmm_route(sp, x[:, :4])[1] == "PALLAS_ROW_TILE"   # other width
    # an explicit algorithm is never overridden
    assert pt.spmm(sp, x, algorithm=Algorithm.PALLAS_ROW_TILE).shape == \
        hybrid.shape
    _write_entry(cache, sp, 8, "XLA_SEGMENT", backend="NVIDIA H100 80GB HBM3")
    assert _spmm_route(sp, x)[1] == "PALLAS_ROW_TILE"


def test_tuned_winner_drives_auto(cache):
    sp = _hybrid()
    best, _ = tune.tune_spmm(sp, 8, iters=ITERS)
    x = torch.ones(sp.shape[1], 8)
    assert _spmm_route(sp, x)[1] == best.name


def test_lookup_on_an_empty_cache_builds_no_key(cache, monkeypatch):
    """With nothing tuned, AUTO's lookup ends at the empty cache: it never
    resolves the backend or formats an entry key."""
    sp = _hybrid()
    x = torch.ones(sp.shape[1], 8)

    def no_backend(device):
        raise AssertionError("the backend was resolved")

    monkeypatch.setattr(tune, "backend", no_backend)
    assert tune.lookup_key(tune.structure_key(sp), 8, "sum") is None
    assert _spmm_route(sp, x)[1] == "PALLAS_ROW_TILE"
    _write_entry(cache, sp, 8, "XLA_SEGMENT")
    with pytest.raises(AssertionError, match="backend was resolved"):
        tune.lookup_key(tune.structure_key(sp), 8, "sum")


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_tunes_into_its_own_temporary_cache(tmp_path,
                                                       monkeypatch):
    """`chip_smoke.run` points the tuner at a fresh temporary file for the
    run's length and restores the caller's setting after; its tune phase
    refuses any other cache file, so a rehearsal never touches a user's
    cache."""
    smoke = _chip_smoke()
    user = tmp_path / "user.json"
    user.write_text("{}")
    monkeypatch.setenv("DGSPARSE_TUNE_CACHE", str(user))
    seen = {}

    def phases(torch_, cuda, tune_dir):
        seen["dir"], seen["path"] = tune_dir, tune.cache_path()
        with pytest.raises(AssertionError, match="not the run's"):
            smoke.phase_tune(torch_, cuda, {}, str(tmp_path))
        return 0

    monkeypatch.setattr(smoke, "_run", phases)
    assert smoke.run(torch, torch.device("cpu")) == 0
    assert seen["path"] == os.path.join(seen["dir"], "tune.json")
    assert tune.cache_path() == str(user) and user.read_text() == "{}"
    assert not os.path.exists(seen["dir"])
    monkeypatch.delenv("DGSPARSE_TUNE_CACHE")
    assert smoke.run(torch, torch.device("cpu")) == 0
    assert "DGSPARSE_TUNE_CACHE" not in os.environ
