"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs a CUDA device and nvcc; without a card every test skips. This file
imports only torch, numpy and the port (the card's machine has no JAX), so
it runs there without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: float32 at 1e-5 and bfloat16 at 1e-2 (both accumulate in
float32; bf16 adds one output rounding), scaled by the sum of the terms'
absolute values (`assert_sum_close`): the kernel sums each row in edge
order while the plain `index_add_` sums with atomics in varying order, so
the two differ by the rounding of the summation, not of the result.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch.kernels import spmm_csr
from dgsparse_tpu_torch.nn import gcn as pt_gcn
from dgsparse_tpu_torch.utils.testing import assert_sum_close, random_csr

pytestmark = pytest.mark.gpu

FIXTURE = Path(__file__).parent / "fixtures" / "torch_port" / "gcn_small.npz"
TOLS = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(cuda, seed, has_value, m=3000, n=2500):
    rowptr, col, values = random_csr(m, n, avg_degree=6.0, seed=seed)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    return t(rowptr), t(col), (t(np.abs(values)) if has_value else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("has_value", [True, False])
@pytest.mark.parametrize("feat", [1, 7, 32, 64, 128, 256])
def test_csr_spmm_matches_plain(cuda, feat, has_value, reduce, dtype):
    rowptr, col, values = _graph(cuda, feat, has_value)
    g = torch.Generator(device=cuda).manual_seed(feat)
    x = torch.randn(2500, feat, generator=g, device=cuda).to(
        getattr(torch, dtype))
    out = spmm_csr.csr_spmm_cuda(rowptr, col, values, x, reduce)
    ref = spmm_csr.csr_spmm_plain(rowptr, col, values, x, reduce)
    abs_sum = spmm_csr.csr_spmm_plain(
        rowptr, col, None if values is None else values.abs(),
        x.float().abs(), reduce)
    torch.cuda.synchronize()
    assert out.dtype == x.dtype and out.shape == (3000, feat)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat", [1, 7, 32, 64, 128, 256])
def test_segment_sum_csr_matches_plain(cuda, feat, dtype):
    rowptr, col, _ = _graph(cuda, feat + 100, False)
    g = torch.Generator(device=cuda).manual_seed(feat)
    contrib = torch.randn(col.numel(), feat, generator=g, device=cuda).to(
        getattr(torch, dtype))
    out = spmm_csr.segment_sum_csr_cuda(rowptr, contrib)
    ref = spmm_csr.segment_sum_csr_plain(rowptr, contrib)
    abs_sum = spmm_csr.segment_sum_csr_plain(rowptr, contrib.float().abs())
    torch.cuda.synchronize()
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])


def test_unaligned_rows_take_the_scalar_path(cuda):
    # an offset view of X: 16-byte loads would be misaligned
    rowptr, col, values = _graph(cuda, 1, True)
    base = torch.randn(2500 * 128 + 1, device=cuda)
    x = base[1:].view(2500, 128)
    out = spmm_csr.csr_spmm_cuda(rowptr, col, values, x)
    ref = spmm_csr.csr_spmm_plain(rowptr, col, values, x)
    abs_sum = spmm_csr.csr_spmm_plain(rowptr, col, values.abs(), x.abs())
    torch.cuda.synchronize()
    assert_sum_close(out, ref, abs_sum, TOLS["float32"])


def test_launch_counts_and_empty_inputs(cuda):
    spmm_csr.reset_launch_counts()
    rowptr, col, values = _graph(cuda, 2, True)
    spmm_csr.csr_spmm(rowptr, col, values, torch.ones(2500, 8, device=cuda))
    spmm_csr.segment_sum_csr(rowptr, torch.ones(col.numel(), 8, device=cuda))
    assert spmm_csr.LAUNCHES == {"csr_spmm": 1, "segment_sum_csr": 1}
    empty = torch.zeros(4, dtype=torch.int32, device=cuda)
    out = spmm_csr.csr_spmm(empty, empty[:0], None,
                            torch.ones(5, 8, device=cuda))
    assert out.shape == (3, 8) and not out.any()
    assert spmm_csr.LAUNCHES["csr_spmm"] == 1     # no launch for nnz == 0


def test_kernel_refuses_bad_inputs(cuda):
    rowptr, col, values = _graph(cuda, 3, True)
    x = torch.ones(2500, 8, device=cuda)
    with pytest.raises(TypeError):
        spmm_csr.csr_spmm_cuda(rowptr.long(), col, values, x)
    with pytest.raises(TypeError):
        spmm_csr.csr_spmm_cuda(rowptr, col, values, x.double())
    with pytest.raises(ValueError):
        spmm_csr.csr_spmm_cuda(rowptr, col, values, x.t())
    with pytest.raises(ValueError):
        spmm_csr.csr_spmm_cuda(rowptr.cpu(), col, values, x)


def test_gcn_matches_frozen_jax_output(cuda):
    with np.load(FIXTURE) as fx:
        fx = dict(fx)
    n = fx["x"].shape[0]
    for a, b in zip(pt_gcn.gcn_norm_from_edge_index(fx["edge_index"], n),
                    (fx["rowptr"], fx["col"], fx["vals"])):
        np.testing.assert_array_equal(a, b)
    adj = pt.SparseTensor.from_csr(fx["rowptr"], fx["col"],
                                   torch.from_numpy(fx["vals"]),
                                   sparse_sizes=(n, n), device=cuda)
    model = pt_gcn.GCN(32, 16, 4).to(cuda)
    params = {f"conv{i}": {"linear": {"kernel": fx[f"conv{i}_kernel"],
                                      "bias": fx[f"conv{i}_bias"]}}
              for i in (1, 2)}
    pt_gcn.load_flax_params(model, params).eval()
    spmm_csr.reset_launch_counts()
    with torch.inference_mode():
        out = model(torch.from_numpy(fx["x"]).to(cuda), adj)
    assert spmm_csr.LAUNCHES["csr_spmm"] == 2
    np.testing.assert_allclose(out.cpu().numpy(), fx["out"], rtol=1e-4,
                               atol=1e-4)


def test_self_check_on_card(cuda):
    pt.self_check(cuda)


def test_sparse_tensor_moved_to_card_matches_cpu(cuda):
    rowptr, col, values = random_csr(500, 400, avg_degree=5.0, seed=4)
    adj = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                   sparse_sizes=(500, 400))
    x = torch.randn(400, 48, generator=torch.Generator().manual_seed(5))
    spmm_csr.reset_launch_counts()
    for reduce in ("sum", "mean"):
        on_card = pt.spmm(adj.to(cuda), x.to(cuda), reduce)
        torch.testing.assert_close(on_card.cpu(), pt.spmm(adj, x, reduce),
                                   rtol=1e-5, atol=1e-5)
    assert spmm_csr.LAUNCHES["csr_spmm"] == 2
