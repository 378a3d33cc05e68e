"""`sddmm_cells` and `sddmm_hybrid` in the bf16 compute mode, by both of
the mode's entry routes, against the JAX package.

On the card both routes run `csrc/spmm_cells.cu::sddmm_cells_bf16_kernel`:
`compute_dtype=torch.bfloat16` on float32 operands (the wrapper rounds d1
and d2 to bf16), and the public `sddmm` of bf16 d1 and d2 on a storage
with a hybrid plan (float32 mode; the operands are bf16 already). Here the
kernel's plain version runs in its place, and the widths are the ragged
ones the kernel's staging has to get right: F = 5 and 41 (rows that do
not start on 16-byte boundaries, k padded to 16 and 48) and F = 72 (two
64-feature slices a cell, the second 8 wide).

JAX's `pallas_sddmm.py::sddmm_cells(compute_dtype=bfloat16)` and
`sddmm_hybrid` run in interpret mode (`tests/conftest.py`), jitted. JAX's
public `sddmm` takes `sddmm_hybrid` with the storage's plan only on the TPU
(`dgsparse_tpu/ops/sddmm.py:55-62`), so the public route is held to
`sddmm_hybrid` on the same bf16 operands.

Tolerance: 1e-5 of the terms' absolute sum (`assert_sum_close`): bf16
products are exact in float32 and both sides sum in float32, in different
orders. The public route returns bf16 (the operands' dtype), so it is held
bitwise to the port's float32 sums rounded to bf16, and those sums to JAX.

Graph: `tests/test_torch_hybrid.py::_pair(seed=41)`, 1500 rows (the last
row block holds 92), every tier non-empty, row block 5 without a dense
cell.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgsparse_tpu.kernels.pallas_sddmm import sddmm_cells as jx_sddmm_cells
from dgsparse_tpu.kernels.pallas_sddmm import sddmm_hybrid as jx_sddmm_hybrid
import dgsparse_tpu as jx
import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.kernels import launch_counts, spmm_cells
from dgsparse_tpu_torch.ops import hybrid as pt_hybrid
from dgsparse_tpu_torch.ops.types import ReduceOp
from dgsparse_tpu_torch.utils.testing import assert_sum_close
from tests.test_torch_hybrid import N, _dense, _pair

BF16 = torch.bfloat16
SEED = 41
FEATS = [5, 41, 72]
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    p, j, (rowptr, _, _) = _pair(seed=SEED)
    degrees = jnp.asarray(np.diff(rowptr))
    coo_row = jnp.asarray(np.repeat(np.arange(N), np.diff(rowptr)))
    return p, j, degrees, coo_row


def _operands(feat):
    """float32 d1, d2 [N, F] from a numpy seed, and the same rounded to
    bf16."""
    d1, d2 = (torch.from_numpy(a) for a in _dense(feat + 80, (N, feat),
                                                  (N, feat)))
    return d1, d2, d1.to(BF16), d2.to(BF16)


def _jax_hybrid(j, degrees, coo_row, d1, d2, reduce, compute_dtype):
    hp = j.storage.ell_plan()
    fn = jax.jit(lambda a, b: jx_sddmm_hybrid(
        hp, a, b, jx.ReduceOp(reduce), degrees, coo_row,
        compute_dtype=compute_dtype))
    return torch.from_numpy(np.array(fn(jnp.asarray(d1), jnp.asarray(d2))))


@pytest.mark.parametrize("feat", FEATS)
def test_sddmm_cells_bf16_matches_jax_at_ragged_widths(pair, feat):
    p, j, _, _ = pair
    plan = p.storage.ell_plan().cells
    d1, d2, d1b, d2b = _operands(feat)
    out = spmm_cells.sddmm_cells(plan, d1, d2, BF16)
    # the other entry: bf16 operands in float32 mode, the same products
    assert torch.equal(out, spmm_cells.sddmm_cells(plan, d1b, d2b))
    jplan = j.storage.ell_plan().cells
    ref = jax.jit(lambda a, b: jx_sddmm_cells(
        jplan, a, b, compute_dtype=jnp.bfloat16))(jnp.asarray(d1.numpy()),
                                                  jnp.asarray(d2.numpy()))
    abs_sum = spmm_cells.sddmm_cells(plan, d1b.float().abs(),
                                     d2b.float().abs())
    assert out.dtype == torch.float32 and out.shape == (plan.cell_slots,)
    assert_sum_close(out, torch.from_numpy(np.array(ref)), abs_sum, TOL)
    assert launch_counts()["sddmm_cells_bf16"] == 0     # the CPU: no kernel


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("feat", FEATS)
def test_sddmm_hybrid_bf16_mode_matches_jax(pair, feat, reduce):
    # compute_dtype=bf16 on float32 operands: the cells on bf16-rounded
    # d1, d2, the other tiers in float32, as JAX's
    p, j, degrees, coo_row = pair
    d1, d2, _, _ = _operands(feat)
    st = p.storage
    out = pt_hybrid.sddmm_hybrid(st, d1, d2, ReduceOp(reduce), BF16)
    ref = _jax_hybrid(j, degrees, coo_row, d1.numpy(), d2.numpy(), reduce,
                      jnp.bfloat16)
    abs_sum = pt_hybrid.sddmm_hybrid(st, d1.abs(), d2.abs(),
                                     ReduceOp(reduce))
    assert out.dtype == torch.float32 and out.shape == (p.nnz,)
    assert_sum_close(out, ref, abs_sum, TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("feat", FEATS)
def test_public_sddmm_of_bf16_operands_matches_jax(pair, feat, reduce,
                                                   monkeypatch):
    p, j, degrees, coo_row = pair
    _, _, d1b, d2b = _operands(feat)
    seen = []
    plain = spmm_cells.sddmm_cells_plain

    def recorded(plan, d1, d2, compute_dtype=torch.float32):
        seen.append((d1.dtype, d2.dtype))
        return plain(plan, d1, d2, compute_dtype)

    monkeypatch.setattr(spmm_cells, "sddmm_cells_plain", recorded)
    out = pt.sddmm(p, d1b, d2b, reduce)
    assert seen == [(BF16, BF16)]       # the cells got the bf16 operands
    assert out.dtype == BF16 and out.shape == (p.nnz,)
    st = p.storage
    sums = pt_hybrid.sddmm_hybrid(st, d1b, d2b, ReduceOp(reduce))
    assert torch.equal(out, sums.to(BF16))
    # JAX's hybrid SDDMM (its public route on the TPU) of the same bf16
    # operands
    ref = _jax_hybrid(j, degrees, coo_row,
                      jnp.asarray(d1b.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(d2b.float().numpy()).astype(jnp.bfloat16),
                      reduce, jnp.float32)
    abs_sum = pt_hybrid.sddmm_hybrid(st, d1b.float().abs(),
                                     d2b.float().abs(), ReduceOp(reduce))
    assert_sum_close(sums, ref, abs_sum, TOL)
