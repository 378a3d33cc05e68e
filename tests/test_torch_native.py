"""The port's native host library (`native.py`) against numpy and against
the JAX package's.

- Built by g++ into the port's build root, never under `native/`.
- `csr2csc` equals the port's numpy transpose.
- On a 3,000-voxel cloud (past the 2,048 voxels from which both packages
  take the native builder), the native and numpy rulebooks give identical
  plans, the kernels' layouts included, submanifold and strided, and
  equal the JAX package's native plans.
Skipped, with the reason, only where no g++ is installed.
"""

import shutil

import numpy as np
import pytest
import torch

from dgsparse_tpu import native as jx_native
from dgsparse_tpu.ops import spconv as S
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch import native
from dgsparse_tpu_torch.core import transform as T
from dgsparse_tpu_torch.ops import spconv as P
from dgsparse_tpu_torch.utils.testing import random_cloud, random_csr

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native library")

SHAPE = (24, 20, 16)


def test_library_builds_into_the_port_build_root():
    assert native.available()
    path = native.library_path()
    assert path.exists() and "dgsparse_tpu_torch" in path.parts
    assert path.parent.parent.name == "dgsparse_tpu_torch"
    assert native.version() == pt.version()["native"] == 11


@pytest.mark.parametrize("shape", [(300, 200), (150, 400)])
def test_csr2csc_matches_numpy(shape):
    rowptr, col, _ = random_csr(*shape, avg_degree=6.0, seed=shape[0])
    got = native.csr2csc(rowptr, col, *shape)
    want = T.csr2csc_np(rowptr, col, shape[1])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def assert_same_plans(a, b):
    for f in ("knnz", "kpos", "qkpos", "num_out", "num_in", "k_vol",
              "separate_mid", "quant"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("imap", "omap", "widx", "o2i", "i2o"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)
    for f in ("by_out", "by_in", "by_offset"):
        x, y = getattr(a, f), getattr(b, f)
        for k, v in vars(x).items():
            w = getattr(y, k)
            if isinstance(v, torch.Tensor):
                np.testing.assert_array_equal(v.numpy(), w.numpy(),
                                              err_msg=f"{f}.{k}")
            else:
                assert v == w, f"{f}.{k}"


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("batch", [1, 2])
def test_native_and_numpy_rulebooks_give_one_plan(stride, batch,
                                                  monkeypatch):
    coords = random_cloud(3000, SHAPE, batch, seed=7 + batch)
    args = (coords, 3, stride, 1)
    nat, nat_out = P.build_rulebook(*args, spatial_shape=SHAPE)
    monkeypatch.setattr(P, "_native_rulebook", lambda *a: None)
    ref, ref_out = P.build_rulebook(*args, spatial_shape=SHAPE)
    np.testing.assert_array_equal(nat_out, ref_out)
    assert nat_out.dtype == np.int32
    assert_same_plans(nat, ref)
    assert_same_plans(P.inverse_plan(nat), P.inverse_plan(ref))


@pytest.mark.parametrize("stride", [1, 2])
def test_native_plans_match_jax_native(stride):
    assert jx_native.available()
    coords = random_cloud(3000, SHAPE, 2, seed=11)
    jp, jo = S.build_rulebook(coords, 3, stride, 1, spatial_shape=SHAPE)
    pp, po = P.build_rulebook(coords, 3, stride, 1, spatial_shape=SHAPE)
    np.testing.assert_array_equal(po, jo)
    for f in ("knnz", "kpos", "qkpos", "num_out", "num_in", "separate_mid"):
        assert getattr(pp, f) == getattr(jp, f), f
    for f in ("imap", "omap", "widx", "o2i", "i2o"):
        np.testing.assert_array_equal(getattr(pp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


def test_small_and_off_centre_clouds_stay_on_numpy(monkeypatch):
    calls = []
    monkeypatch.setattr(native, "rulebook_subm",
                        lambda *a: calls.append("subm"))
    monkeypatch.setattr(native, "rulebook_strided",
                        lambda *a: calls.append("strided"))
    small = random_cloud(500, SHAPE, 1, seed=3)
    P.build_rulebook(small, 3, 1, 1, spatial_shape=SHAPE)
    P.build_rulebook(small, 3, 2, 1, spatial_shape=SHAPE)
    big = random_cloud(3000, SHAPE, 1, seed=3)
    P.build_rulebook(big, 3, 1, 0, spatial_shape=SHAPE)     # not centred
    P.build_rulebook(big, 2, 1, 1, spatial_shape=SHAPE)     # even kernel
    assert calls == []
    P.build_rulebook(big, 3, 1, 1, spatial_shape=SHAPE)
    P.build_rulebook(big, 3, 2, 1, spatial_shape=SHAPE)
    assert calls == ["subm", "strided"]
