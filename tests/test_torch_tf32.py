"""Why the tensor-core kernels take three TF32 passes for fp32.

`csrc/spconv.cu` (spconv_pairs, spconv_dw) and `csrc/spmm_cells.cu`
(spmm_dense_cells, sddmm_cells) multiply fp32 operands on TF32 tensor
cores as 3xTF32 (`csrc/common.cuh`):
a = big + small with big = tf32(a), rounded to nearest as
`cvt.rna.tf32.f32` rounds, and small = a - big, which the tensor core cuts
to TF32 (it reads an operand's top 19 bits), and a·b summed as small·big +
big·small + big·big in fp32. Here that arithmetic is emulated on the CPU
with `utils.testing.tf32_round` (TF32 products are exact in fp32) and held
to the port's fp32 rule, 1e-5 of the terms' absolute sum, against a
float64 product, at the shapes of one spconv_pairs step (128 gathered rows
of 64 channels times a 64 x 64 weight slice), of an enc2 row block's 26
offsets, and of one spconv_dw chunk at enc2 (4,064 pairs of 64 x 64
channels, summed 8 pairs a product). One TF32 pass breaks the rule.
"""

import numpy as np
import pytest
import torch

from dgsparse_tpu_torch.utils.testing import assert_sum_close, tf32_round

TOL = 1e-5


def test_tf32_round_is_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                       # TF32's ulp at 1
    x = np.array([1 + one_ulp / 2, 1 + one_ulp / 4, 1 + 3 * one_ulp / 4,
                  -(1 + one_ulp / 2), 3.0, 0.0], np.float32)
    want = np.array([1 + one_ulp, 1, 1 + one_ulp, -(1 + one_ulp), 3.0, 0.0],
                    np.float32)
    np.testing.assert_array_equal(tf32_round(x), want)
    r = tf32_round(np.random.default_rng(0).standard_normal(1000))
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()


def _terms(offsets):
    rng = np.random.default_rng(offsets)
    a = rng.standard_normal((offsets, 128, 64)).astype(np.float32)
    b = (0.1 * rng.standard_normal((offsets, 64, 64))).astype(np.float32)
    return a, b


def _split(a):
    """(big, small) as the tensor core takes them: big rounded to TF32,
    small = a - big with its low 13 bits dropped."""
    big = tf32_round(a)
    small = (a - big).astype(np.float32).view(np.uint32) & np.uint32(
        0xFFFFE000)
    return big, small.view(np.float32)


def _sum_products(a, b, passes):
    """Σ_k a[k] @ b[k] in fp32, each product in `passes` TF32 passes (1:
    big·big; 3: small·big + big·small + big·big), as the kernels order
    their tensor-core products into one fp32 accumulator."""
    acc = np.zeros((a.shape[1], b.shape[2]), np.float32)
    for ak, bk in zip(a, b):
        (ab, asm), (bb, bsm) = _split(ak), _split(bk)
        if passes == 3:
            acc = acc + asm @ bb
            acc = acc + ab @ bsm
        acc = acc + ab @ bb
    return acc


@pytest.mark.parametrize("offsets", [1, 26])
def test_3xtf32_keeps_the_fp32_rule_and_one_pass_does_not(offsets):
    a, b = _terms(offsets)
    exact = np.einsum("kij,kjl->il", a.astype(np.float64),
                      b.astype(np.float64))
    abs_sum = np.einsum("kij,kjl->il", np.abs(a).astype(np.float64),
                        np.abs(b).astype(np.float64))
    t = torch.from_numpy
    three = _sum_products(a, b, 3)
    assert_sum_close(t(three), t(exact), t(abs_sum), TOL)
    # well inside the rule: within 1e-6 of the absolute sum
    assert (np.abs(three - exact) <= 1e-6 * abs_sum).all()
    with pytest.raises(AssertionError):
        assert_sum_close(t(_sum_products(a, b, 1)), t(exact), t(abs_sum),
                         TOL)


@pytest.mark.parametrize("feat", [41, 64])
def test_3xtf32_sddmm_block_keeps_the_fp32_rule(feat):
    # d1[rb] @ d2[cw]ᵀ for one cell, F zero-padded to a multiple of 8 (the
    # kernel's 16-feature slices add zeros only) and summed 8 features a
    # product, in order, into one fp32 accumulator
    rng = np.random.default_rng(feat)
    padded = -(-feat // 8) * 8
    d1, d2 = (np.zeros((128, padded), np.float32) for _ in range(2))
    d1[:, :feat] = rng.standard_normal((128, feat))
    d2[:, :feat] = rng.standard_normal((128, feat))
    a = d1.reshape(128, -1, 8).transpose(1, 0, 2)        # [steps, 128, 8]
    b = d2.reshape(128, -1, 8).transpose(1, 2, 0)        # [steps, 8, 128]
    exact = d1.astype(np.float64) @ d2.T.astype(np.float64)
    abs_sum = np.abs(d1).astype(np.float64) @ np.abs(d2).T.astype(np.float64)
    t = torch.from_numpy
    assert_sum_close(t(_sum_products(a, b, 3)), t(exact), t(abs_sum), TOL)
    with pytest.raises(AssertionError):
        assert_sum_close(t(_sum_products(a, b, 1)), t(exact), t(abs_sum),
                         TOL)


def test_3xtf32_dw_chunk_keeps_the_fp32_rule_and_one_pass_does_not():
    # x[in]ᵀ g[out] over one enc2 chunk of 4,064 pairs (kernels/spconv.py
    # cuts enc2's 2,078,556 pairs into chunks of about this many): K = the
    # pairs, 8 a product, in pair order into one fp32 accumulator, as
    # dw_partial_kernel walks a chunk (A = xᵀ read k-major)
    rng = np.random.default_rng(4064)
    x = rng.standard_normal((4064, 64)).astype(np.float32)
    g = rng.standard_normal((4064, 64)).astype(np.float32)
    a = x.reshape(-1, 8, 64).transpose(0, 2, 1)          # [508, 64, 8]
    b = g.reshape(-1, 8, 64)                             # [508, 8, 64]
    exact = x.T.astype(np.float64) @ g.astype(np.float64)
    abs_sum = np.abs(x).T.astype(np.float64) @ np.abs(g).astype(np.float64)
    t = torch.from_numpy
    assert_sum_close(t(_sum_products(a, b, 3)), t(exact), t(abs_sum), TOL)
    with pytest.raises(AssertionError):
        assert_sum_close(t(_sum_products(a, b, 1)), t(exact), t(abs_sum),
                         TOL)
