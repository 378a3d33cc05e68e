"""The port's sparse 3-D convolution against the JAX package's.

- The host rulebook (`ops/spconv.py::build_rulebook`, `inverse_plan`,
  `plan_from_reference_rulebook`) field by field: knnz, kpos, qkpos, the
  Q-padded imap/omap/widx stream, o2i/i2o, out_coords and separate_mid. At
  >= 2048 voxels both packages build with the native C++ builder
  (`tests/test_torch_native.py` holds it to the port's numpy path); every
  builder gives the pairs of each offset in the same order (by output id),
  so those clouds are compared exactly too.
- `spconv` and both gradients against JAX's dense masked-gather path and
  against its fused Pallas kernels (`fused_pair_matmul`, `fused_pair_dw`)
  in interpret mode, at 1e-4: sums of up to 27 * c_in terms in another
  order on each side.
- The kernels' plain versions (`kernels/spconv.py`) against the dense
  formulation of `kernels/reference.py`, and dX skipped when the features
  need no gradient.
- With metrics on, a spconv records the fused route and its pairs, and
  opens the route's forward span with its backward span inside; a plan
  without pairs runs the center tap alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgsparse_tpu.kernels import pallas_spconv as kf
from dgsparse_tpu.ops import spconv as S
from dgsparse_tpu_torch.kernels import reference
from dgsparse_tpu_torch.kernels import spconv as K
from dgsparse_tpu_torch.ops import spconv as P
from dgsparse_tpu_torch.utils import metrics
from dgsparse_tpu_torch.utils.testing import random_cloud
from tests.test_spconv import random_cloud as jx_random_cloud

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def force_fused():
    """JAX's fused Pallas spconv kernels, in interpret mode."""
    prev = kf._INTERPRET
    kf.set_interpret(True)
    S._FORCE_FUSED[0] = True
    yield
    S._FORCE_FUSED[0] = None
    kf.set_interpret(prev)


def _plans(coords, shape, stride, padding=1, kernel_size=3):
    args = (coords, kernel_size, stride, padding)
    jp, jo = S.build_rulebook(*args, spatial_shape=shape)
    pp, po = P.build_rulebook(*args, spatial_shape=shape, device="cpu")
    return jp, jo, pp, po


def _assert_same_plan(jp, pp):
    for name in ("knnz", "kpos", "qkpos", "num_out", "num_in", "k_vol",
                 "separate_mid", "quant"):
        assert getattr(pp, name) == getattr(jp, name), name
    for name in ("imap", "omap", "widx", "o2i", "i2o"):
        got, want = getattr(pp, name).numpy(), np.asarray(getattr(jp, name))
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype, name


def _assert_layouts(pp):
    """The kernels' layouts hold the rulebook's pairs: a CSR over outputs
    and one over inputs sorted by (row, offset), and the kpos runs."""
    real = pp.imap.numpy() >= 0
    pin, pout = pp.imap.numpy()[real], pp.omap.numpy()[real]
    pw = pp.widx.numpy()[real]
    for csr, dst, src, rows in ((pp.by_out, pout, pin, pp.num_out),
                                (pp.by_in, pin, pout, pp.num_in)):
        order = np.lexsort((pw, dst))
        np.testing.assert_array_equal(csr.dst.numpy(), dst[order])
        np.testing.assert_array_equal(csr.src.numpy(), src[order])
        np.testing.assert_array_equal(csr.widx.numpy(), pw[order])
        np.testing.assert_array_equal(
            csr.ptr.numpy(), np.searchsorted(dst[order], np.arange(rows + 1)))
    off = pp.by_offset
    np.testing.assert_array_equal(off.widx.numpy(), pw)
    np.testing.assert_array_equal(off.in_ids.numpy(), pin)
    bounds, chunk_ptr = off.bounds.numpy(), off.chunk_ptr.numpy()
    assert bounds[-1] == len(pw) and np.all(np.diff(bounds) > 0)
    for k in range(pp.k_vol):
        if pp.knnz[k]:
            assert (bounds[chunk_ptr[k]], bounds[chunk_ptr[k + 1]]) == (
                pp.kpos[k], pp.kpos[k + 1])
        else:
            assert chunk_ptr[k] == chunk_ptr[k + 1]


def test_random_cloud_is_the_jax_tests_cloud():
    np.testing.assert_array_equal(random_cloud(300, (9, 8, 7), 2, seed=4),
                                  jx_random_cloud(300, (9, 8, 7), 2, seed=4))


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("num_points,shape", [(200, (13, 11, 9)),
                                              (3000, (24, 20, 16))])
def test_rulebook_matches_jax(num_points, shape, stride, batch):
    coords = random_cloud(num_points, shape, batch, seed=num_points + stride)
    jp, jo, pp, po = _plans(coords, shape, stride)
    _assert_same_plan(jp, pp)
    np.testing.assert_array_equal(po, jo)
    assert po.dtype == np.int32
    assert pp.separate_mid == (stride == 1)
    _assert_layouts(pp)
    # and the inverse of the same plan
    _assert_same_plan(S.inverse_plan(jp), P.inverse_plan(pp))


def test_rulebook_with_a_kernel_of_two_and_no_padding():
    coords = random_cloud(150, (10, 9, 8), 1, seed=3)
    jp, jo, pp, po = _plans(coords, (10, 9, 8), 2, padding=0, kernel_size=2)
    _assert_same_plan(jp, pp)
    np.testing.assert_array_equal(po, jo)


def _reference_dict(plan, center):
    """A dgSPARSE sample-data rulebook dict of a submanifold plan, its
    center offset carrying the map `center` (input ids by output)."""
    mid = (plan.k_vol - 1) // 2
    knnz = list(plan.knnz)
    imaps = [plan.imap.numpy()[plan.qkpos[k]:plan.qkpos[k] + knnz[k]]
             for k in range(plan.k_vol)]
    omaps = [plan.omap.numpy()[plan.qkpos[k]:plan.qkpos[k] + knnz[k]]
             for k in range(plan.k_vol)]
    imaps[mid] = center
    omaps[mid] = np.arange(plan.num_out, dtype=np.int32)
    knnz[mid] = plan.num_out
    return {"knnz": np.asarray(knnz), "kpos": np.concatenate(
        [[0], np.cumsum(knnz)]), "imap": np.concatenate(imaps),
        "omap": np.concatenate(omaps), "k_vol": plan.k_vol,
        "in_nnz": plan.num_in, "out_nnz": plan.num_out}


@pytest.mark.parametrize("identity", [True, False])
def test_plan_from_reference_rulebook_matches_jax(identity):
    coords = random_cloud(250, (12, 10, 8), 2, seed=9)
    _, _, pp, _ = _plans(coords, (12, 10, 8), 1)
    n = pp.num_in
    center = (np.arange(n) if identity
              else np.roll(np.arange(n), 1)).astype(np.int32)
    data = _reference_dict(pp, center)
    jq = S.plan_from_reference_rulebook(data)
    pq = P.plan_from_reference_rulebook(data)
    _assert_same_plan(jq, pq)
    # an identity center is stripped for the dense center-tap product
    assert pq.separate_mid == identity
    assert pq.knnz[(pq.k_vol - 1) // 2] == (0 if identity else n)
    _assert_layouts(pq)


def test_plan_from_reference_rulebook_refuses_a_bad_kpos():
    coords = random_cloud(100, (8, 8, 8), 1, seed=1)
    _, _, pp, _ = _plans(coords, (8, 8, 8), 1)
    data = _reference_dict(pp, np.arange(pp.num_in, dtype=np.int32))
    data["kpos"] = data["kpos"][:-1]
    with pytest.raises(ValueError):
        P.plan_from_reference_rulebook(data)


def _op_case(kind, c_in, c_out, seed, num_points=160, shape=(12, 10, 8),
             batch=2):
    """(JAX plan, port plan, features, kernel, cotangent) of a seeded cloud:
    a submanifold, strided or inverse (of the strided) conv."""
    coords = random_cloud(num_points, shape, batch, seed=seed)
    jp, _, pp, _ = _plans(coords, shape, 1 if kind == "subm" else 2)
    if kind == "inverse":
        jp, pp = S.inverse_plan(jp), P.inverse_plan(pp)
    rng = np.random.default_rng(seed + 1)
    feats = rng.standard_normal((pp.num_in, c_in)).astype(np.float32)
    kernel = (rng.standard_normal((pp.k_vol, c_in, c_out)) * 0.1).astype(
        np.float32)
    ct = rng.standard_normal((pp.num_out, c_out)).astype(np.float32)
    return jp, pp, feats, kernel, ct


def _jax_out_and_grads(plan, feats, kernel, ct):
    f, w = jnp.asarray(feats), jnp.asarray(kernel)
    out = S.spconv(f, w, plan)

    def loss(f, w):
        return jnp.vdot(S.spconv(f, w, plan), jnp.asarray(ct))

    return [np.asarray(a) for a in (out, *jax.grad(loss, (0, 1))(f, w))]


def _port_out_and_grads(plan, feats, kernel, ct):
    f = torch.from_numpy(feats).requires_grad_()
    w = torch.from_numpy(kernel).requires_grad_()
    out = P.spconv(f, w, plan)
    out.backward(torch.from_numpy(ct))
    return [a.detach().numpy() for a in (out, f.grad, w.grad)]


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
@pytest.mark.parametrize("c_in,c_out", [(16, 32), (7, 33)])
def test_spconv_and_grads_match_jax_dense_path(kind, c_in, c_out):
    jp, pp, feats, kernel, ct = _op_case(kind, c_in, c_out, seed=21)
    assert not jp.use_fused(c_in, c_out)
    for got, want, name in zip(_port_out_and_grads(pp, feats, kernel, ct),
                               _jax_out_and_grads(jp, feats, kernel, ct),
                               ("out", "dX", "dW")):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_spconv_and_grads_match_jax_fused_kernels(force_fused, kind):
    # shapes inside JAX's gate: k_vol * max(c_in, c_out) <= 2048 and a
    # sparse cloud
    jp, pp, feats, kernel, ct = _op_case(kind, 8, 16, seed=31,
                                         num_points=140, shape=(12, 10, 8),
                                         batch=1)
    assert jp.use_fused(8, 16)
    for got, want, name in zip(_port_out_and_grads(pp, feats, kernel, ct),
                               _jax_out_and_grads(jp, feats, kernel, ct),
                               ("out", "dX", "dW")):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_spconv_bf16_features_match_jax():
    jp, pp, feats, kernel, _ = _op_case("subm", 16, 16, seed=41)
    want = np.asarray(S.spconv(jnp.asarray(feats, jnp.bfloat16),
                               jnp.asarray(kernel, jnp.bfloat16), jp),
                      np.float32)
    got = P.spconv(torch.from_numpy(feats).bfloat16(),
                   torch.from_numpy(kernel).bfloat16(), pp)
    assert got.dtype == torch.bfloat16
    # both round each offset's product to bf16 at other places
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
def test_plain_pairs_and_dw_match_the_dense_formulation(kind):
    _, pp, feats, kernel, ct = _op_case(kind, 8, 12, seed=51)
    x, w, g = (torch.from_numpy(a) for a in (feats, kernel, ct))
    mid = (pp.k_vol - 1) // 2
    center = pp.separate_mid
    out = K.spconv_pairs(pp.by_out, x, w)
    if center:
        out = out + x @ w[mid]
    torch.testing.assert_close(out, reference.spconv_dense(
        x, w, pp.o2i, center), rtol=1e-5, atol=1e-5)
    rdx, rdw = reference.spconv_dense_bwd(x, w, g, pp.i2o, center)
    dx = K.spconv_pairs(pp.by_in, g, w.transpose(1, 2).contiguous())
    dw = K.spconv_dw(pp.by_offset, x, g)
    if center:
        dx = dx + g @ w[mid].T
        assert not dw[mid].any()
        dw[mid] = x.T @ g
    torch.testing.assert_close(dx, rdx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, rdw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_spconv_records_the_fused_route(kind):
    _, pp, feats, kernel, ct = _op_case(kind, 8, 16, seed=81)
    metrics.reset()
    metrics.enable()
    try:
        _port_out_and_grads(pp, feats, kernel, ct)
        (key,), = [list(metrics.counters())]
        spans = {s["name"]: s for s in metrics.spans()}
    finally:
        metrics.disable()
        metrics.reset()
    assert key[0] == "spconv"
    assert dict(key[1:]) == {"path": "fused", "pairs": pp.total_pairs,
                             "c_in": 8, "c_out": 16}
    fwd = spans.pop("dgsparse.op.spconv.fused.fwd")
    bwd = spans.pop("dgsparse.op.spconv.fused.bwd")
    assert not spans and bwd["parent"] == fwd["id"]
    assert fwd["tags"]["pairs"] == pp.total_pairs > 0
    assert bwd["tags"]["d_features"] and bwd["tags"]["d_kernel"]


def test_spconv_of_a_plan_without_pairs_matches_jax():
    """A lone voxel's submanifold plan has no pairs: out and both
    gradients come from the center tap alone."""
    coords = np.array([[0, 1, 2, 3]], np.int32)
    jp, _, pp, _ = _plans(coords, (4, 4, 4), 1)
    assert pp.total_pairs == 0 and pp.separate_mid
    rng = np.random.default_rng(91)
    feats = rng.standard_normal((1, 5)).astype(np.float32)
    kernel = rng.standard_normal((27, 5, 6)).astype(np.float32)
    ct = rng.standard_normal((1, 6)).astype(np.float32)
    for got, want, name in zip(_port_out_and_grads(pp, feats, kernel, ct),
                               _jax_out_and_grads(jp, feats, kernel, ct),
                               ("out", "dX", "dW")):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_pair_csr_refuses_a_repeated_row_and_offset():
    with pytest.raises(ValueError):
        K.pair_csr(np.array([0, 1, 1]), np.array([2, 0, 3]),
                   np.array([4, 4, 4]), 2)
    with pytest.raises(ValueError):
        K.offset_pairs(np.array([0, 1]), np.array([1, 0]), np.array([2, 1]),
                       3)


def test_offset_chunks_stay_inside_an_offset():
    widx = np.repeat(np.arange(5), [0, 700, 3, 0, 300])
    ids = np.arange(len(widx))
    off = K.offset_pairs(ids, ids, widx, 5)
    bounds, chunk_ptr = off.bounds.numpy(), off.chunk_ptr.numpy()
    assert list(chunk_ptr) == [0, 0, 3, 4, 4, 6]
    assert list(bounds) == [0, 256, 512, 700, 703, 959, 1003]


def test_dx_runs_only_when_the_features_need_it(monkeypatch):
    _, pp, feats, kernel, ct = _op_case("subm", 8, 8, seed=61)
    calls = []

    def counting(pairs, x, w):
        calls.append(pairs)
        return K.spconv_pairs(pairs, x, w)

    monkeypatch.setattr(P, "spconv_pairs", counting)
    w = torch.from_numpy(kernel).requires_grad_()
    P.spconv(torch.from_numpy(feats), w, pp).backward(torch.from_numpy(ct))
    assert calls == [pp.by_out] and w.grad is not None
    calls.clear()
    f = torch.from_numpy(feats).requires_grad_()
    P.spconv(f, torch.from_numpy(kernel), pp).backward(torch.from_numpy(ct))
    assert calls == [pp.by_out, pp.by_in] and f.grad is not None


def test_sparse_conv_tensor_shares_its_plans():
    coords = random_cloud(120, (9, 9, 9), 1, seed=71)
    st = P.SparseConvTensor(torch.zeros(len(coords), 4), coords, (9, 9, 9))
    plan, _ = st.plan_for(3, 1, 1)
    same = st.replace(features=torch.ones(len(coords), 4))
    assert same.plan_for(3, 1, 1)[0] is plan
    other = st.replace(features=torch.ones(len(coords), 4),
                       spatial_shape=(10, 9, 9))
    assert other.plan_for(3, 1, 1)[0] is not plan
