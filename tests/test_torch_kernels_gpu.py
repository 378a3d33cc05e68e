"""The port's CUDA kernels against their plain PyTorch versions, and its
training steps against the frozen JAX fixtures, on a card.

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
from dgsparse_tpu_torch import entry
from dgsparse_tpu_torch.kernels import edge_softmax as ES
from dgsparse_tpu_torch.kernels import (launch_counts, reset_launch_counts,
                                        sddmm_csr, spmm_csr)
from dgsparse_tpu_torch.nn import gcn as pt_gcn
from dgsparse_tpu_torch.utils.testing import (assert_sum_close,
                                              assert_train_close, random_csr,
                                              run_train_fixture)

pytestmark = pytest.mark.gpu

FIXTURES = Path(__file__).parent / "fixtures" / "torch_port"
FIXTURE = FIXTURES / "gcn_small.npz"
TOLS = {"float32": 1e-5, "bfloat16": 1e-2}
# kernel launches per training step: forward, d_dense of both layers, and
# d_values of both layers where the edge values are attention weights
STEP_LAUNCHES = {"gcn": (4, 0), "gat": (4, 2)}


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
@pytest.mark.parametrize("feat", [1, 7, 32, 40, 41, 64, 96, 128, 256])
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
    again = spmm_csr.csr_spmm_cuda(rowptr, col, values, x, reduce)
    assert torch.equal(out, again)             # no atomics: repeatable


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat", [1, 7, 32, 40, 41, 64, 96, 128, 256])
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
    assert spmm_csr.LAUNCHES == {"csr_spmm": 1, "csr_spmm_split": 0,
                                 "segment_sum_csr": 1}
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("feat", [1, 7, 16, 32, 64, 128, 300])
def test_sddmm_csr_matches_plain(cuda, feat, heads, reduce, dtype):
    rowptr, col, _ = _graph(cuda, feat + 200, False)
    g = torch.Generator(device=cuda).manual_seed(feat)
    dt = getattr(torch, dtype)
    d1 = torch.randn(3000, heads * feat, generator=g, device=cuda).to(dt)
    d2 = torch.randn(2500, heads * feat, generator=g, device=cuda).to(dt)
    out = sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2, heads, reduce)
    ref = sddmm_csr.sddmm_csr_plain(rowptr, col, d1, d2, heads, reduce)
    abs_sum = sddmm_csr.sddmm_csr_plain(rowptr, col, d1.float().abs(),
                                        d2.float().abs(), heads, reduce)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (col.numel(), heads)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("feat", [1, 7, 16, 40, 64])
def test_csr_spmm_heads_matches_plain(cuda, feat, reduce, dtype):
    rowptr, col, _ = _graph(cuda, feat + 300, False)
    g = torch.Generator(device=cuda).manual_seed(feat)
    values = torch.randn(col.numel(), 4, generator=g, device=cuda)
    x = torch.randn(2500, 4 * feat, generator=g, device=cuda).to(
        getattr(torch, dtype))
    out = spmm_csr.csr_spmm_cuda(rowptr, col, values, x, reduce)
    ref = spmm_csr.csr_spmm_plain(rowptr, col, values, x, reduce)
    abs_sum = spmm_csr.csr_spmm_plain(rowptr, col, values.abs(),
                                      x.float().abs(), reduce)
    torch.cuda.synchronize()
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])


@pytest.mark.parametrize("heads", [1, 4])
def test_csr_spmm_over_csc_is_the_transpose(cuda, heads):
    from dgsparse_tpu_torch.kernels import reference
    from dgsparse_tpu_torch.ops.types import ReduceOp

    rowptr, col, _ = random_csr(3000, 2500, avg_degree=6.0, seed=heads)
    adj = pt.SparseTensor.from_csr(rowptr, col, sparse_sizes=(3000, 2500),
                                   device=cuda)
    st = adj.storage
    g = torch.Generator(device=cuda).manual_seed(heads)
    values = torch.randn(st.nnz, heads, generator=g, device=cuda)
    grad = torch.randn(3000, heads * 16, generator=g, device=cuda)
    out = spmm_csr.csr_spmm_cuda(st.colptr(), st.row(),
                                 values[st.csr2csc().long()], grad)
    # the plain transpose: CSR edges summed into their columns
    ref = reference.spmm_mh(st.col(), st.coo_row(), values,
                            grad.view(3000, heads, 16), 2500, ReduceOp.SUM)
    abs_sum = reference.spmm_mh(st.col(), st.coo_row(), values.abs(),
                                grad.abs().view(3000, heads, 16), 2500,
                                ReduceOp.SUM)
    torch.cuda.synchronize()
    assert_sum_close(out, ref.view(2500, -1), abs_sum.view(2500, -1),
                     TOLS["float32"])


def _hub_graph(cuda, kind, has_value):
    """A CSR of 3000 rows over 2500 columns with rows longer than the split
    chunk: "star", row 7 joined to every column beside ~6 entries a row;
    "zipf", lognormal degrees up to all 2500 columns."""
    if kind == "star":
        rowptr, col, _ = random_csr(3000, 2500, avg_degree=6.0, seed=11,
                                    skew=0.5)
        rows = np.split(col, rowptr[1:-1])
        rows[7] = np.arange(2500, dtype=np.int32)
        col = np.concatenate(rows)
        rowptr = np.concatenate(
            [[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
        values = np.random.default_rng(11).standard_normal(
            len(col)).astype(np.float32)
    else:
        rowptr, col, values = random_csr(3000, 2500, avg_degree=12.0,
                                         seed=12, skew=1.8)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    return (rowptr, t(rowptr), t(col),
            t(np.abs(values)) if has_value else None)


# (graph, chunk): the storages' chunk, and a small one that cuts the star's
# hub into 40 chunks
SPLITS = [("star", spmm_csr.SPLIT_CHUNK), ("zipf", spmm_csr.SPLIT_CHUNK),
          ("star", 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("has_value", [True, False])
@pytest.mark.parametrize("feat", [1, 7, 40, 41, 64, 256, 300])
@pytest.mark.parametrize("graph,chunk", SPLITS)
def test_split_csr_spmm_matches_plain(cuda, graph, chunk, feat, has_value,
                                      reduce, dtype):
    rp, rowptr, col, values = _hub_graph(cuda, graph, has_value)
    split = spmm_csr.split_plan(rp, chunk, cuda)
    assert split.num_chunks > 0
    g = torch.Generator(device=cuda).manual_seed(feat)
    x = torch.randn(2500, feat, generator=g, device=cuda).to(
        getattr(torch, dtype))
    spmm_csr.reset_launch_counts()
    out = spmm_csr.csr_spmm_cuda(rowptr, col, values, x, reduce, split=split)
    ref = spmm_csr.csr_spmm_plain(rowptr, col, values, x, reduce)
    abs_sum = spmm_csr.csr_spmm_plain(
        rowptr, col, None if values is None else values.abs(),
        x.float().abs(), reduce)
    torch.cuda.synchronize()
    assert out.dtype == x.dtype and out.shape == (3000, feat)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    again = spmm_csr.csr_spmm_cuda(rowptr, col, values, x, reduce,
                                   split=split)
    assert torch.equal(out, again)             # no atomics: repeatable
    # rows of at most C entries are summed as without the plan, bit for bit
    whole = spmm_csr.csr_spmm_cuda(rowptr, col, values, x, reduce)
    short = torch.from_numpy(np.diff(rp) <= chunk).to(cuda)
    assert torch.equal(out[short], whole[short])
    assert (spmm_csr.LAUNCHES["csr_spmm"],
            spmm_csr.LAUNCHES["csr_spmm_split"]) == (3, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("graph,chunk", SPLITS)
def test_split_csr_spmm_heads_matches_plain(cuda, graph, chunk, reduce,
                                            dtype):
    rp, rowptr, col, _ = _hub_graph(cuda, graph, False)
    split = spmm_csr.split_plan(rp, chunk, cuda)
    g = torch.Generator(device=cuda).manual_seed(8)
    values = torch.randn(col.numel(), 8, generator=g, device=cuda)
    x = torch.randn(2500, 64, generator=g, device=cuda).to(
        getattr(torch, dtype))
    out = spmm_csr.csr_spmm_cuda(rowptr, col, values, x, reduce, split=split)
    ref = spmm_csr.csr_spmm_plain(rowptr, col, values, x, reduce)
    abs_sum = spmm_csr.csr_spmm_plain(rowptr, col, values.abs(),
                                      x.float().abs(), reduce)
    torch.cuda.synchronize()
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    assert torch.equal(out, spmm_csr.csr_spmm_cuda(rowptr, col, values, x,
                                                   reduce, split=split))


def _flat_graph(cuda, seed):
    """A CSR like `_graph`'s with no row longer than the split chunk."""
    rowptr, col, values = random_csr(3000, 2500, avg_degree=6.0, seed=seed,
                                     skew=0.5)
    assert np.diff(rowptr).max() <= spmm_csr.SPLIT_CHUNK
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    return t(rowptr), t(col), t(np.abs(values))


@pytest.mark.parametrize("feat", [40, 256])
def test_split_plan_without_long_rows_changes_nothing(cuda, feat):
    rowptr, col, values = _flat_graph(cuda, feat)
    split = spmm_csr.split_plan(rowptr.cpu(), device=cuda)
    assert split.num_chunks == 0
    x = torch.randn(2500, feat, device=cuda)
    spmm_csr.reset_launch_counts()
    out = spmm_csr.csr_spmm_cuda(rowptr, col, values, x, split=split)
    assert torch.equal(out, spmm_csr.csr_spmm_cuda(rowptr, col, values, x))
    assert (spmm_csr.LAUNCHES["csr_spmm"],
            spmm_csr.LAUNCHES["csr_spmm_split"]) == (2, 0)


def test_storage_ops_pass_the_split_plans(cuda):
    from dgsparse_tpu_torch.utils import metrics

    rp, _, col, values = _hub_graph(cuda, "star", True)
    hub = pt.SparseTensor.from_csr(rp, col.cpu(), values.cpu(),
                                   sparse_sizes=(3000, 2500), device=cuda)
    flat = pt.SparseTensor.from_csr(*_flat_graph(cuda, 5),
                                    sparse_sizes=(3000, 2500))
    rows = hub.storage.row_split().num_split_rows
    assert rows == 1 and flat.storage.row_split().num_chunks == 0
    x = torch.randn(2500, 32, device=cuda, requires_grad=True)
    reset_launch_counts()
    metrics.enable()
    try:
        metrics.reset()
        pt.spmm_sum(flat, x).sum().backward()
        assert launch_counts()["csr_spmm_split"] == 0
        out = pt.spmm_sum(hub, x)
        assert launch_counts()["csr_spmm_split"] == 1
        out.sum().backward()       # the CSC view: its columns of ~7 entries
        counts = metrics.cache_counters()
    finally:
        metrics.disable()
    assert launch_counts()["csr_spmm"] == 4
    split_launches = launch_counts()["csr_spmm_split"]
    assert split_launches == 1 + (hub.storage.col_split().num_chunks > 0)
    assert counts["csr_spmm.split_rows"] == rows + \
        hub.storage.col_split().num_split_rows
    assert counts["csr_spmm.split_chunks"] == \
        hub.storage.row_split().num_chunks + \
        hub.storage.col_split().num_chunks


def _sddmm_hub_graph(cuda):
    """A CSR of 3000 rows over 2500 columns, ~6 entries a row, with rows
    of 13,096 (ogbn-arxiv's longest is 13,161), 129, 128, 1 and 0 entries
    spread through it."""
    rng = np.random.default_rng(21)
    lengths = rng.poisson(6.0, 3000)
    lengths[[0, 700, 1400, 2100, 2800]] = [13096, 129, 128, 1, 0]
    rowptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = rng.integers(0, 2500, rowptr[-1]).astype(np.int32)
    return rowptr, torch.from_numpy(rowptr).to(cuda), \
        torch.from_numpy(col).to(cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("feat,heads", [(8, 8), (40, 1), (7, 1)])
@pytest.mark.parametrize("mapping", ["group", "warp_per_row"])
def test_split_sddmm_csr_is_bitwise_the_unsplit(cuda, mapping, feat, heads,
                                                 reduce, dtype):
    """The split launch on both mappings (GAT's two widths on the
    benchmark, 8 heads of 8 and one of 40, and an odd head): bitwise the
    launch without a plan, and close to the plain version."""
    rp, rowptr, col = _sddmm_hub_graph(cuda)
    split = spmm_csr.split_plan(rp, device=cuda)
    assert split.num_split_rows == 2           # 13,096 and 129 entries
    gen = torch.Generator(device=cuda).manual_seed(feat * heads)
    dt = getattr(torch, dtype)
    d1 = torch.randn(3000, heads * feat, generator=gen, device=cuda).to(dt)
    d2 = torch.randn(2500, heads * feat, generator=gen, device=cuda).to(dt)
    path = (sddmm_csr.sddmm_path(feat, heads, d1.element_size())
            if mapping == "group" else sddmm_csr.WARP_PER_ROW)
    sddmm_csr.reset_launch_counts()
    out = sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2, heads, reduce, path,
                                   split=split)
    whole = sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2, heads, reduce,
                                     path)
    ref = sddmm_csr.sddmm_csr_plain(rowptr, col, d1, d2, heads, reduce)
    abs_sum = sddmm_csr.sddmm_csr_plain(rowptr, col, d1.float().abs(),
                                        d2.float().abs(), heads, reduce)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (col.numel(), heads)
    assert torch.equal(out, whole)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    assert sddmm_csr.LAUNCHES == {"sddmm_csr": 2, "sddmm_csr_split": 1}


def test_split_sddmm_csr_refuses_another_csrs_plan(cuda):
    rp, rowptr, col = _sddmm_hub_graph(cuda)
    d1 = torch.ones(3000, 8, device=cuda)
    d2 = torch.ones(2500, 8, device=cuda)
    other = spmm_csr.split_plan(_hub_graph(cuda, "zipf", False)[0],
                                device=cuda)
    assert other.num_chunks > 0
    for plan in (other, spmm_csr.split_plan(rp)):    # another CSR; the host
        with pytest.raises(ValueError, match="split plan"):
            sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2, split=plan)
    # a plan without chunks is no plan, whatever CSR it was built for
    empty = spmm_csr.split_plan(np.zeros(4, np.int32), device=cuda)
    assert torch.equal(sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2,
                                                split=empty),
                       sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2))


def test_training_steps_pass_the_sddmm_split_plan(cuda):
    """A GAT step on a graph with a hub row runs both `d_values` launches
    on the storage's split plan; a GCN step runs no `sddmm_csr`; the CSR
    route of `sddmm` passes the plan too."""
    from dgsparse_tpu_torch.nn.gat import GAT
    from dgsparse_tpu_torch.nn.gcn import GCN
    from dgsparse_tpu_torch.utils import metrics

    rp, _, col, values = _hub_graph(cuda, "star", True)
    rows = np.split(col.cpu().numpy(), rp[1:-1])[:2500]   # square: 2500
    rp = np.concatenate([[0], np.cumsum([len(r) for r in rows])]
                        ).astype(np.int32)
    adj = pt.SparseTensor.from_csr(rp, np.concatenate(rows),
                                   np.ones(rp[-1], np.float32),
                                   sparse_sizes=(2500, 2500), device=cuda)
    plan = adj.storage.row_split()
    assert plan.num_split_rows == 1 and adj.storage.ell_plan() is None
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2500, 32, generator=gen, device=cuda)
    y = torch.randint(0, 7, (2500,), generator=gen, device=cuda)
    counts = {}
    metrics.enable()
    try:
        for name, model in (("gcn", GCN(32, 16, 7, dropout=0.0)),
                            ("gat", GAT(32, 8, 7, num_heads=4))):
            model = model.to(cuda)
            opt = entry.build_optimizer(model)
            metrics.reset()
            reset_launch_counts()
            entry.train_step(model, opt, x, adj, y)
            counts[name] = (launch_counts()["sddmm_csr"],
                            launch_counts()["sddmm_csr_split"],
                            metrics.cache_counters())
        reset_launch_counts()
        pt.sddmm(adj, x, x)
        assert (launch_counts()["sddmm_csr"],
                launch_counts()["sddmm_csr_split"]) == (1, 1)
    finally:
        metrics.disable()
    assert counts["gcn"][:2] == (0, 0)
    assert "sddmm_csr.split_rows" not in counts["gcn"][2]
    assert counts["gat"][:2] == (2, 2)
    assert counts["gat"][2]["sddmm_csr.split_rows"] == 2
    assert counts["gat"][2]["sddmm_csr.split_chunks"] == 2 * plan.num_chunks


# --- edge_softmax ------------------------------------------------------------
#
# The kernels sum a row's exps and dots in a fixed order. They are held to
# the plain versions run in float64 (index_add_'s atomics in float32 move a
# hub row's sum of 13,096 positive exps by ~1e-4 of itself from run to run,
# more than the kernels' own rounding): alpha at 1e-5 scaled by alpha,
# d_logits at 1e-5 scaled by |alpha| (|g| + the row's sum of |alpha g|).

@pytest.fixture(scope="module")
def citation():
    """The benchmark's citation graph at seed 0 (`portbench/graphs/
    citation.py`, the sizes of `gat-arxiv.json`), as the GAT cell builds
    its adjacency, on the card: 2,484,941 nnz."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import json

    from portbench.graphs import citation as generator

    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "portbench" / "configs" /
                      "gat-arxiv.json").read_text())["graph"]
    g = generator.make(cfg, 0)
    return pt_gcn.get_gcn_dcsr_from_edge_index(g["edge_index"],
                                               g["num_nodes"], device="cuda")


def _softmax_inputs(st, heads, layout, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = 3 * torch.randn(heads, st.nnz, generator=gen, device="cuda")
    x = x.t() if layout == "column_major" else x.t().contiguous()
    g = torch.randn(st.nnz, heads, generator=gen, device="cuda")
    return x, g


def _plain64(fn, rowptr, *tensors):
    """A plain version of the kernels run in float64, as float32."""
    return fn(rowptr, *(t.double() for t in tensors)).float()


def _softmax_bwd_scale(st, alpha, g):
    a, b = alpha.abs(), g.abs()
    row = st.coo_row().long()
    sums = torch.zeros(st.num_rows, a.shape[1], device=a.device)
    return a * (b + sums.index_add_(0, row, a * b)[row])


@pytest.mark.parametrize("layout", ["row_major", "column_major"])
@pytest.mark.parametrize("heads", [8, 1])
def test_edge_softmax_kernels_match_plain_on_citation(cuda, citation, heads,
                                                      layout):
    """GAT's two layers on the benchmark's graph, hub rows split: forward
    and backward against the plain versions, a second call bitwise the
    first, two launches of each kind a call."""
    st = citation.storage
    split = st.row_split()
    assert (split.num_split_rows, split.num_chunks) == (588, 2151)
    x, g = _softmax_inputs(st, heads, layout, heads)
    rowptr = st.rowptr()
    column_major = layout == "column_major"
    ES.reset_launch_counts()
    alpha = ES.edge_softmax_cuda(rowptr, x, split)
    dx = ES.edge_softmax_bwd_cuda(rowptr, alpha, g, split, column_major)
    ref = _plain64(ES.edge_softmax_plain, rowptr, x)
    dref = _plain64(ES.edge_softmax_bwd_plain, rowptr, alpha, g)
    torch.cuda.synchronize()
    assert alpha.is_contiguous() and alpha.shape == x.shape
    assert dx.stride() == x.stride() if column_major else dx.is_contiguous()
    assert_sum_close(alpha, ref, ref, TOLS["float32"])
    assert_sum_close(dx, dref, _softmax_bwd_scale(st, alpha, g),
                     TOLS["float32"])
    # no atomics: a second call is bitwise the first
    assert torch.equal(alpha, ES.edge_softmax_cuda(rowptr, x, split))
    assert torch.equal(dx, ES.edge_softmax_bwd_cuda(rowptr, alpha, g, split,
                                                    column_major))
    assert ES.LAUNCHES == {"edge_softmax": 2, "edge_softmax_bwd": 2,
                           "edge_softmax_split": 4}


def test_edge_softmax_kernels_give_zero_on_rows_of_minus_inf(cuda, citation):
    """A short row and the longest (split) row of -inf give alpha 0 and a
    zero gradient, nothing NaN; a chunk of -inf in a split row whose other
    logits lie near -100 adds nothing to its row's sum; a strided [nnz]
    takes the one-head path."""
    st = citation.storage
    rowptr, split = st.rowptr(), st.row_split()
    rp = rowptr.cpu().numpy()
    lengths = np.diff(rp)
    hub = int(np.argmax(lengths))
    short = int(np.flatnonzero((lengths > 1) & (lengths < 16))[0])
    other = int(np.flatnonzero(lengths > 2 * spmm_csr.SPLIT_CHUNK)[0])
    if other == hub:
        other = int(np.flatnonzero(lengths > 2 * spmm_csr.SPLIT_CHUNK)[1])
    x, g = _softmax_inputs(st, 8, "row_major", 7)
    for r in (hub, short):
        x[rp[r]:rp[r + 1]] = float("-inf")
    x[rp[other]:rp[other + 1]] -= 100.0
    x[rp[other]:rp[other] + spmm_csr.SPLIT_CHUNK] = float("-inf")
    for logits, grad in ((x, g), (x[:, 3], g[:, 3])):
        alpha = ES.edge_softmax_cuda(rowptr, logits, split)
        dx = ES.edge_softmax_bwd_cuda(rowptr, alpha, grad, split)
        ref = _plain64(ES.edge_softmax_plain, rowptr, logits)
        torch.cuda.synchronize()
        assert alpha.shape == logits.shape
        assert torch.isfinite(alpha).all() and torch.isfinite(dx).all()
        for r in (hub, short):
            assert not alpha[rp[r]:rp[r + 1]].any()
            assert not dx[rp[r]:rp[r + 1]].any()
        assert_sum_close(alpha, ref, ref, TOLS["float32"])
        a2 = alpha.reshape(st.nnz, -1)
        assert_sum_close(dx, _plain64(ES.edge_softmax_bwd_plain, rowptr,
                                      alpha, grad),
                         _softmax_bwd_scale(st, a2, grad.reshape(st.nnz, -1)
                                            ).reshape(dx.shape),
                         TOLS["float32"])


def test_edge_softmax_launches_only_its_kernels(cuda, citation):
    """A forward and backward of the op on GAT's layer-one logits launch
    the four kernels of csrc/edge_softmax.cu and nothing else: no
    scatter_reduce, gather or index_add of the op's own."""
    from torch.profiler import ProfilerActivity, profile

    x, g = _softmax_inputs(citation.storage, 8, "column_major", 5)
    x.requires_grad_()

    def step():
        torch.autograd.grad(pt.edge_softmax(citation, x), x, g)
        torch.cuda.synchronize()

    step()                                  # the kernels built and loaded
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert {n.split("<")[0].split("::")[-1] for n in names} == {
        "softmax_kernel", "softmax_split_kernel", "softmax_bwd_kernel",
        "softmax_bwd_split_kernel"}, names


def _square(rowptr, col, n):
    """The first n rows of a CSR as an [n, n] adjacency of unit values on
    the card (columns below n)."""
    rows = np.split(col, rowptr[1:-1])[:n]
    rp = np.concatenate([[0], np.cumsum([len(r) for r in rows])]
                        ).astype(np.int32)
    return pt.SparseTensor.from_csr(rp, np.concatenate(rows),
                                    np.ones(rp[-1], np.float32),
                                    sparse_sizes=(n, n), device="cuda")


def test_gat_step_launches_the_edge_softmax_kernels(cuda):
    """One GAT training step: each layer's softmax launches the forward and
    the backward kernel once; the split rows' second launch runs only where
    the storage's plan has chunks."""
    from dgsparse_tpu_torch.nn.gat import GAT
    from dgsparse_tpu_torch.utils import metrics

    rp, _, col, _ = _hub_graph(cuda, "star", False)
    hub = _square(rp, col.cpu().numpy(), 2500)
    flat = _square(*random_csr(2500, 2500, avg_degree=6.0, seed=5,
                               skew=0.5)[:2], 2500)
    assert hub.storage.row_split().num_split_rows == 1
    assert flat.storage.row_split().num_chunks == 0
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2500, 32, generator=gen, device=cuda)
    y = torch.randint(0, 7, (2500,), generator=gen, device=cuda)
    metrics.enable()
    try:
        for adj in (hub, flat):
            model = GAT(32, 8, 7, num_heads=4).to(cuda)
            opt = entry.build_optimizer(model)
            metrics.reset()
            reset_launch_counts()
            entry.train_step(model, opt, x, adj, y)
            plan = adj.storage.row_split()
            split = 4 if plan.num_chunks else 0
            assert {k: v for k, v in launch_counts().items()
                    if k.startswith("edge_softmax")} == {
                "edge_softmax": 2, "edge_softmax_bwd": 2,
                "edge_softmax_split": split}
            counts = metrics.cache_counters()
            assert counts.get("edge_softmax.split_rows", 0) == \
                split * plan.num_split_rows
            assert counts.get("edge_softmax.split_chunks", 0) == \
                split * plan.num_chunks
    finally:
        metrics.disable()


def test_edge_softmax_launches_nothing_off_the_kernel(cuda):
    """CPU logits and CUDA logits of another dtype take the plain versions,
    forward and backward, with no launch; the kernels refuse what they
    cannot run."""
    rp, col, _ = random_csr(2500, 2500, avg_degree=6.0, seed=5, skew=0.5)
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.float64),
                          ("cuda", torch.bfloat16)):
        sp = pt.SparseTensor.from_csr(rp, col, sparse_sizes=(2500, 2500),
                                      device=device)
        logits = torch.randn(sp.nnz, 4, device=device, dtype=dtype,
                             requires_grad=True)
        ES.reset_launch_counts()
        out = pt.edge_softmax(sp, logits)
        out.backward(torch.ones_like(out))
        assert out.dtype == dtype and logits.grad.dtype == dtype
        assert torch.isfinite(out).all() and torch.isfinite(logits.grad).all()
        if dtype != torch.bfloat16:    # bf16 row sums by atomics vary
            torch.testing.assert_close(out, ES.edge_softmax_plain(
                sp.storage.rowptr(), logits.detach(), sp.storage.coo_row()))
        assert sum(ES.LAUNCHES.values()) == 0
    st = pt.SparseTensor.from_csr(rp, col, sparse_sizes=(2500, 2500),
                                  device="cuda").storage
    x = torch.randn(st.nnz, 4, device=cuda)
    with pytest.raises(ValueError, match="at most 128"):
        ES.edge_softmax_cuda(st.rowptr(), x,
                             spmm_csr.split_plan(rp, 256, device=cuda))
    with pytest.raises(ValueError, match="split plan"):
        ES.edge_softmax_cuda(st.rowptr(), x[1:], st.row_split())
    with pytest.raises(ValueError):
        ES.edge_softmax_cuda(st.rowptr().cpu(), x)
    with pytest.raises(TypeError):
        ES.edge_softmax_cuda(st.rowptr(), x.double())


def test_sddmm_launch_counts_and_empty_inputs(cuda):
    reset_launch_counts()
    rowptr, col, _ = _graph(cuda, 4, False)
    sddmm_csr.sddmm_csr(rowptr, col, torch.ones(3000, 8, device=cuda),
                        torch.ones(2500, 8, device=cuda), 2)
    assert launch_counts() == {"csr_spmm": 0, "csr_spmm_split": 0,
                               "segment_sum_csr": 0, "sddmm_csr": 1,
                               "sddmm_csr_split": 0,
                               "spmm_maxmin": 0,
                               "spmm_maxmin_d_dense": 0,
                               "spmm_maxmin_d_values": 0,
                               "spmm_dense_cells": 0,
                               "spmm_dense_cells_bf16": 0, "sddmm_cells": 0,
                               "sddmm_cells_bf16": 0, "spmm_bell": 0,
                               "spconv_pairs": 0, "spconv_dw": 0,
                               "edge_softmax": 0, "edge_softmax_bwd": 0,
                               "edge_softmax_split": 0}
    empty = torch.zeros(4, dtype=torch.int32, device=cuda)
    out = sddmm_csr.sddmm_csr(empty, empty[:0], torch.ones(3, 8, device=cuda),
                              torch.ones(5, 8, device=cuda))
    assert out.shape == (0, 1)
    assert sddmm_csr.LAUNCHES["sddmm_csr"] == 1   # no launch for nnz == 0


def test_sddmm_kernel_refuses_bad_inputs(cuda):
    rowptr, col, _ = _graph(cuda, 5, False)
    d1 = torch.ones(3000, 8, device=cuda)
    d2 = torch.ones(2500, 8, device=cuda)
    with pytest.raises(TypeError):
        sddmm_csr.sddmm_csr_cuda(rowptr.long(), col, d1, d2)
    with pytest.raises(TypeError):
        sddmm_csr.sddmm_csr_cuda(rowptr, col, d1.double(), d2.double())
    with pytest.raises(TypeError):
        sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2.bfloat16())
    with pytest.raises(ValueError):
        sddmm_csr.sddmm_csr_cuda(rowptr, col, d1[:, :4], d2[:, :4])
    with pytest.raises(ValueError):
        sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2[:, :7])
    with pytest.raises(ValueError):
        sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2, heads=3)
    with pytest.raises(ValueError):
        sddmm_csr.sddmm_csr_cuda(rowptr, col.cpu(), d1, d2)
    with pytest.raises(RuntimeError):            # 64 lanes a row
        sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2, path=(4, 2, 1, 1, 64))
    with pytest.raises(ValueError):
        spmm_csr.csr_spmm_cuda(rowptr, col, torch.ones(col.numel(), 3,
                                                       device=cuda),
                               torch.ones(2500, 8, device=cuda))


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_training_matches_frozen_jax_fixture(cuda, name):
    with np.load(FIXTURES / "train_small.npz") as fx:
        fx = dict(fx)
    reset_launch_counts()
    losses, grads = run_train_fixture(fx, name, cuda, steps=3)
    per_step = STEP_LAUNCHES[name]
    counts = launch_counts()
    assert (counts["csr_spmm"], counts["sddmm_csr"]) == tuple(
        3 * n for n in per_step)
    prefix = f"{name}/grads/"
    assert_train_close(losses, grads, fx[f"{name}/losses"],
                       {k[len(prefix):]: v for k, v in fx.items()
                        if k.startswith(prefix)})


@pytest.mark.parametrize("config", ["gcn-cora", "gat-cora"])
def test_train_entry_on_card(cuda, config):
    reset_launch_counts()
    losses = entry.train(config, 3)
    csr, sddmm = STEP_LAUNCHES[entry.TRAIN_CONFIGS[config].model]
    counts = launch_counts()
    assert (counts["csr_spmm"], counts["sddmm_csr"]) == (3 * csr, 3 * sddmm)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# --- spmm_maxmin and its backward --------------------------------------------
#
# The forward's values and winning edges match the plain version exactly:
# both combine in float32 (IEEE division) and keep the earliest winner. The
# backward's sums (a column's winners, a row's features) are taken in
# another order, hence `assert_sum_close`.

def _maxmin_inputs(cuda, seed, heads, feat, compute, integer=False):
    rowptr, col, _ = _graph(cuda, seed, False)
    g = torch.Generator(device=cuda).manual_seed(seed)
    if integer:
        x = torch.randint(-2, 3, (2500, heads * feat), generator=g,
                          device=cuda).float()
    else:
        x = torch.randn(2500, heads * feat, generator=g, device=cuda)
    values = None
    if compute is not None:
        # |v| in [0.5, 2]: DIV and its gradient divide by the values
        values = (torch.rand(col.numel(), heads, generator=g, device=cuda)
                  * 1.5 + 0.5) * (torch.randint(0, 2, (col.numel(), heads),
                                                generator=g, device=cuda)
                                  * 2 - 1)
        if integer:
            values = values.sign()
    return rowptr, col, values, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("compute", [None, "add", "sub", "mul", "div"])
@pytest.mark.parametrize("heads,feat", [(1, 7), (1, 64), (1, 256), (4, 16)])
def test_spmm_maxmin_matches_plain(cuda, heads, feat, compute, reduce,
                                   dtype):
    from dgsparse_tpu_torch.kernels import spmm_maxmin

    rowptr, col, values, x = _maxmin_inputs(cuda, feat + heads, heads, feat,
                                            compute)
    x = x.to(getattr(torch, dtype))
    op = compute or "mul"
    out, arg = spmm_maxmin.spmm_maxmin_cuda(rowptr, col, values, x, reduce,
                                            op)
    ref, ref_arg = spmm_maxmin.spmm_maxmin_plain(rowptr, col, values, x,
                                                 reduce, op)
    torch.cuda.synchronize()
    assert out.dtype == x.dtype and arg.dtype == torch.int32
    assert torch.equal(arg, ref_arg)
    assert torch.equal(out, ref)
    empty = rowptr[1:] == rowptr[:-1]
    assert bool((arg[empty] == col.numel()).all())


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("compute", [None, "mul"])
def test_spmm_maxmin_ties_keep_the_earliest_edge(cuda, heads, compute):
    from dgsparse_tpu_torch.kernels import spmm_maxmin

    rowptr, col, values, x = _maxmin_inputs(cuda, 7, heads, 32, compute,
                                            integer=True)
    for reduce in ("max", "min"):
        out, arg = spmm_maxmin.spmm_maxmin_cuda(rowptr, col, values, x,
                                                reduce)
        ref, ref_arg = spmm_maxmin.spmm_maxmin_plain(rowptr, col, values, x,
                                                     reduce)
        torch.cuda.synchronize()
        assert torch.equal(arg, ref_arg) and torch.equal(out, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", [None, "one", "heads"])
def test_spmm_maxmin_d_dense_matches_plain(cuda, weights, dtype):
    from dgsparse_tpu_torch.kernels import spmm_maxmin

    heads = 4 if weights == "heads" else 1
    rowptr, col, values, x = _maxmin_inputs(cuda, 11, heads, 64 // heads,
                                            None if weights is None
                                            else "mul")
    adj = pt.SparseTensor.from_csr(rowptr.cpu(), col.cpu(),
                                   sparse_sizes=(3000, 2500), device=cuda)
    st = adj.storage
    _, arg = spmm_maxmin.spmm_maxmin_cuda(rowptr, col, values, x)
    g = torch.randn(3000, 64, device=cuda).to(getattr(torch, dtype))
    w = None if values is None else values[st.csr2csc().long()].contiguous()
    out = spmm_maxmin.spmm_maxmin_d_dense_cuda(st.colptr(), st.row(),
                                               st.csr2csc(), w, arg, g,
                                               st.rowptr(), st.csc_slot())
    ref = spmm_maxmin.spmm_maxmin_d_dense_plain(st.colptr(), st.row(),
                                                st.csr2csc(), w, arg, g)
    abs_sum = spmm_maxmin.spmm_maxmin_d_dense_plain(
        st.colptr(), st.row(), st.csr2csc(),
        None if w is None else w.abs(), arg, g.float().abs())
    torch.cuda.synchronize()
    assert out.dtype == g.dtype
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dot", [True, False])
@pytest.mark.parametrize("heads,feat", [(1, 7), (1, 300), (4, 16)])
def test_spmm_maxmin_d_values_matches_plain(cuda, heads, feat, dot, dtype):
    from dgsparse_tpu_torch.kernels import spmm_maxmin

    rowptr, col, values, x = _maxmin_inputs(cuda, feat + 20, heads, feat,
                                            "mul")
    x = x.to(getattr(torch, dtype))
    _, arg = spmm_maxmin.spmm_maxmin_cuda(rowptr, col, values, x)
    g = torch.randn(3000, heads * feat, device=cuda).to(x.dtype)
    dense = x if dot else None
    out = spmm_maxmin.spmm_maxmin_d_values_cuda(rowptr, col, arg, g, dense,
                                                heads)
    ref = spmm_maxmin.spmm_maxmin_d_values_plain(rowptr, col, arg, g, dense,
                                                 heads)
    abs_sum = spmm_maxmin.spmm_maxmin_d_values_plain(
        rowptr, col, arg, g.float().abs(),
        None if dense is None else dense.float().abs(), heads)
    torch.cuda.synchronize()
    assert out.shape == (col.numel(), heads) and out.dtype == torch.float32
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])


def _skewed_maxmin_inputs(cuda, seed, feat, integer):
    """A CSR whose degrees are lognormal (warps hold rows of very different
    lengths), with empty rows, rows of more than 4 x 32 edges and, in row
    0, one column repeated across several batches of 4 gathers; x
    integer-valued (ties everywhere, inside a batch of 4 gathers and across
    batches) or normal."""
    rng = np.random.default_rng(seed)
    m, n = 700, 500
    deg = np.minimum(rng.lognormal(1.5, 1.3, m).astype(np.int64), 600)
    deg[rng.choice(m, 40, replace=False)] = 0
    deg[[0, 1, 33, 64]] = [37, 129, 257, 517]
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col = rng.integers(0, n, rowptr[-1]).astype(np.int32)
    col[rowptr[0]:rowptr[1]] = col[0]          # row 0: one column, all ties
    x = (rng.integers(-2, 3, (n, feat)) if integer
         else rng.standard_normal((n, feat)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    return t(rowptr), t(col), t(x.astype(np.float32))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("feat", [41, 96, 128, 256])
def test_spmm_maxmin_skewed_rows_and_ties_match_plain(cuda, feat, reduce,
                                                      dtype, integer):
    from dgsparse_tpu_torch.kernels import spmm_maxmin

    rowptr, col, x = _skewed_maxmin_inputs(cuda, feat, feat, integer)
    x = x.to(getattr(torch, dtype))
    out, arg = spmm_maxmin.spmm_maxmin_cuda(rowptr, col, None, x, reduce)
    ref, ref_arg = spmm_maxmin.spmm_maxmin_plain(rowptr, col, None, x,
                                                 reduce)
    torch.cuda.synchronize()
    assert torch.equal(arg, ref_arg) and torch.equal(out, ref)
    assert bool((arg[0] == 0).all())           # row 0 ties: its first edge
    empty = rowptr[1:] == rowptr[:-1]
    assert bool((arg[empty] == col.numel()).all()) and not out[empty].any()


@pytest.mark.parametrize("path", ["slice 128", "slice 256", "slice 512"])
@pytest.mark.parametrize("feat", [41, 256])
def test_spmm_maxmin_every_slice_width_matches_plain(cuda, feat, path):
    from dgsparse_tpu_torch.kernels import spmm_maxmin as M

    rowptr, col, x = _skewed_maxmin_inputs(cuda, 5, feat, True)
    p = M.maxmin_path(feat, 1, 4, 16, int(path.split()[1]))
    for reduce in ("max", "min"):
        out, arg = M.spmm_maxmin_cuda(rowptr, col, None, x, reduce, path=p)
        ref, ref_arg = M.spmm_maxmin_plain(rowptr, col, None, x, reduce)
        torch.cuda.synchronize()
        assert torch.equal(arg, ref_arg) and torch.equal(out, ref), p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat,weights", [
    (f, w) for f in (7, 41, 64, 256, 300) for w in (None, "one", "heads")
    if w != "heads" or f % 4 == 0])
def test_spmm_maxmin_d_dense_skewed_rows_and_ties_match_plain(cuda, feat,
                                                              weights,
                                                              dtype):
    """d_dense on lognormal degrees, empty rows, rows of 129-517 edges
    and a column repeated in a row, with integer features so most winners
    tie onto the earliest edge: the mapping `pick_d_dense` picks against
    the plain version and bitwise equal to a second call, to the two-pass
    kernel (winner masks, then columns) and to the one-warp-a-column
    kernel (both add each element's terms in CSC order)."""
    from dgsparse_tpu_torch.kernels import spmm_maxmin as M

    heads = 4 if weights == "heads" else 1
    rowptr, col, x = _skewed_maxmin_inputs(cuda, feat + 3, feat, True)
    m, n, nnz = rowptr.numel() - 1, x.shape[0], col.numel()
    st = pt.SparseTensor.from_csr(rowptr.cpu(), col.cpu(),
                                  sparse_sizes=(m, n), device=cuda).storage
    gen = torch.Generator(device=cuda).manual_seed(feat)
    values = None
    if weights is not None:
        values = torch.rand(nnz, heads, generator=gen, device=cuda) + 0.5
    dt = getattr(torch, dtype)
    _, arg = M.spmm_maxmin_cuda(rowptr, col, values, x.to(dt))
    g = torch.randn(m, feat, generator=gen, device=cuda).to(dt)
    w = None if values is None else values[st.csr2csc().long()].contiguous()
    csc = (st.colptr(), st.row(), st.csr2csc(), w, arg, g)
    rows = (st.rowptr(), st.csc_slot())
    out = M.spmm_maxmin_d_dense_cuda(*csc, *rows)
    again = M.spmm_maxmin_d_dense_cuda(*csc, *rows)
    masks = M.spmm_maxmin_d_dense_cuda(
        *csc, *rows, path=M.d_dense_path(feat, heads, g.element_size()))
    column = M.spmm_maxmin_d_dense_cuda(*csc, *rows, path=M.WARP_PER_COLUMN)
    ref = M.spmm_maxmin_d_dense_plain(*csc)
    abs_sum = M.spmm_maxmin_d_dense_plain(
        *csc[:3], None if w is None else w.abs(), arg, g.float().abs())
    torch.cuda.synchronize()
    assert out.dtype == g.dtype and out.shape == (n, feat)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    assert torch.equal(out, again) and torch.equal(out, masks)
    assert torch.equal(out, column)


@pytest.mark.parametrize("path", ["picked", "group", "warp_per_row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("feat", [1, 7, 16, 64, 259, 300])
def test_sddmm_csr_skewed_rows_match_plain(cuda, feat, heads, reduce, dtype,
                                           path):
    """sddmm_csr on lognormal degrees, empty rows and rows of 37-517
    edges (several trips of a group, more than 32 and 128 edges), on the
    mapping `pick_sddmm` picks, on the group mapping's `sddmm_path` (259:
    an odd head in two chunks) and on one warp a row: against the plain
    version, and a second call bitwise equal."""
    rowptr, col, _ = _skewed_maxmin_inputs(cuda, feat + heads, 1, False)
    m, n = rowptr.numel() - 1, 500
    gen = torch.Generator(device=cuda).manual_seed(feat)
    dt = getattr(torch, dtype)
    d1 = torch.randn(m, heads * feat, generator=gen, device=cuda).to(dt)
    d2 = torch.randn(n, heads * feat, generator=gen, device=cuda).to(dt)
    p = {"picked": None, "warp_per_row": sddmm_csr.WARP_PER_ROW,
         "group": sddmm_csr.sddmm_path(feat, heads, d1.element_size())}[path]
    out = sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2, heads, reduce, p)
    again = sddmm_csr.sddmm_csr_cuda(rowptr, col, d1, d2, heads, reduce, p)
    ref = sddmm_csr.sddmm_csr_plain(rowptr, col, d1, d2, heads, reduce)
    abs_sum = sddmm_csr.sddmm_csr_plain(rowptr, col, d1.float().abs(),
                                        d2.float().abs(), heads, reduce)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (col.numel(), heads)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    assert torch.equal(out, again)


def test_spmm_maxmin_launch_counts_and_bad_inputs(cuda):
    from dgsparse_tpu_torch.kernels import spmm_maxmin

    reset_launch_counts()
    rowptr, col, values, x = _maxmin_inputs(cuda, 12, 1, 8, "mul")
    out, arg = spmm_maxmin.spmm_maxmin(rowptr, col, values, x, "min")
    assert spmm_maxmin.LAUNCHES["spmm_maxmin"] == 1
    empty = torch.zeros(4, dtype=torch.int32, device=cuda)
    out, arg = spmm_maxmin.spmm_maxmin(empty, empty[:0], None,
                                       torch.ones(5, 8, device=cuda))
    assert out.shape == (3, 8) and not out.any() and not arg.any()
    assert spmm_maxmin.LAUNCHES["spmm_maxmin"] == 1   # no launch, nnz == 0
    with pytest.raises(TypeError):
        spmm_maxmin.spmm_maxmin_cuda(rowptr.long(), col, values, x)
    with pytest.raises(TypeError):
        spmm_maxmin.spmm_maxmin_cuda(rowptr, col, values.double(), x)
    with pytest.raises(ValueError):
        spmm_maxmin.spmm_maxmin_cuda(rowptr, col, values, x.t())
    with pytest.raises(ValueError):
        spmm_maxmin.spmm_maxmin_cuda(rowptr, col, values, x, "sum")
    # d_dense: one launch counted a call on the picked mapping and on the
    # winner masks' (two CUDA launches: masks, then columns)
    st = pt.SparseTensor.from_csr(rowptr.cpu(), col.cpu(),
                                  sparse_sizes=(3000, 2500),
                                  device=cuda).storage
    _, arg = spmm_maxmin.spmm_maxmin(rowptr, col, values, x)
    g = torch.randn(3000, 8, device=cuda)
    csc = (st.colptr(), st.row(), st.csr2csc(), None, arg, g)
    spmm_maxmin.spmm_maxmin_d_dense(*csc, st.rowptr(), st.csc_slot())
    assert spmm_maxmin.LAUNCHES["spmm_maxmin_d_dense"] == 1
    spmm_maxmin.spmm_maxmin_d_dense_cuda(
        *csc, st.rowptr(), st.csc_slot(),
        path=spmm_maxmin.d_dense_path(8, 1, 4))
    assert spmm_maxmin.LAUNCHES["spmm_maxmin_d_dense"] == 2
    with pytest.raises(ValueError):             # rowptr of the CSC view
        spmm_maxmin.spmm_maxmin_d_dense_cuda(*csc, st.colptr(),
                                             st.csc_slot())
    with pytest.raises(RuntimeError):           # 64 lanes a column
        spmm_maxmin.spmm_maxmin_d_dense_cuda(*csc, st.rowptr(),
                                             st.csc_slot(), path=(1, 64, 1))


def test_gin_matches_frozen_jax_fixture(cuda):
    from dgsparse_tpu_torch.utils.testing import run_gin_fixture

    with np.load(FIXTURES / "gin_small.npz") as fx:
        fx = dict(fx)
    reset_launch_counts()
    out, losses, grads = run_gin_fixture(fx, cuda, steps=3)
    counts = launch_counts()
    # 2 forwards per step plus the eval forward; 1 d_dense per step
    assert (counts["spmm_maxmin"], counts["spmm_maxmin_d_dense"],
            counts["spmm_maxmin_d_values"]) == (2 + 3 * 2, 3, 0)
    np.testing.assert_allclose(out, fx["gin/out"], rtol=1e-4, atol=1e-4)
    prefix = "gin/grads/"
    assert_train_close(losses, grads, fx["gin/losses"],
                       {k[len(prefix):]: v for k, v in fx.items()
                        if k.startswith(prefix)})


def test_gin_max_entry_on_card(cuda):
    reset_launch_counts()
    losses = entry.train("gin-max-cora", 3)
    counts = launch_counts()
    assert (counts["spmm_maxmin"], counts["spmm_maxmin_d_dense"],
            counts["spmm_maxmin_d_values"]) == (6, 3, 0)
    assert np.isfinite(losses).all()


# --- the hybrid tiers: spmm_dense_cells, spmm_bell, sddmm_cells --------------
#
# On `utils.testing.hybrid_csr`: every tier non-empty, duplicate edges,
# empty rows, and row block 5 without a dense cell (written as zero).

def _hybrid(cuda, has_value=True, seed=0):
    from dgsparse_tpu_torch.utils.testing import hybrid_csr

    rowptr, col, vals = hybrid_csr(seed=seed)
    n = len(rowptr) - 1
    adj = pt.SparseTensor.from_csr(
        rowptr, col, torch.from_numpy(vals) if has_value else None,
        sparse_sizes=(n, n), device=cuda)
    assert adj.storage.ell_plan() is not None
    return adj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("feat", [1, 41, 64, 130])
def test_spmm_dense_cells_matches_plain(cuda, feat, transpose, dtype):
    from dgsparse_tpu_torch.kernels import spmm_cells

    st = _hybrid(cuda).storage
    plan, cells = st.ell_plan().cells, st.tier_values()["cells"]
    g = torch.Generator(device=cuda).manual_seed(feat)
    x = torch.randn(1500, feat, generator=g, device=cuda).to(
        getattr(torch, dtype))
    out = spmm_cells.spmm_dense_cells_cuda(plan, cells, x, transpose)
    ref = spmm_cells.spmm_dense_cells_plain(plan, cells, x, transpose)
    abs_sum = spmm_cells.spmm_dense_cells_plain(plan, cells.abs(),
                                                x.float().abs(), transpose)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (1500, feat)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    if not transpose:
        assert not out[640:768].any()          # the block without a cell
    again = spmm_cells.spmm_dense_cells_cuda(plan, cells, x, transpose)
    assert torch.equal(out, again)             # no atomics: repeatable


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("feat", [7, 41, 64])
def test_bf16_cells_variant_matches_plain(cuda, feat, transpose):
    # the bf16 compute mode: the storage's bf16 twin of the cells times a
    # bf16 B on the bf16-cell variant, against the plain version, which
    # rounds the same way (a bf16 product is exact in float32), at 1e-5 of
    # the terms' absolute sum
    from dgsparse_tpu_torch.kernels import spmm_cells

    bf16 = torch.bfloat16
    st = _hybrid(cuda).storage
    plan = st.ell_plan().cells
    tiers = st.tier_values(compute_dtype=bf16)
    twin = tiers["cells_bf16"]
    g = torch.Generator(device=cuda).manual_seed(feat)
    x = torch.randn(1500, feat, generator=g, device=cuda)
    reset_launch_counts()
    out = spmm_cells.spmm_dense_cells_cuda(plan, twin, x, transpose, bf16)
    counts = launch_counts()
    assert (counts["spmm_dense_cells_bf16"], counts["spmm_dense_cells"]) \
        == (1, 0)
    ref = spmm_cells.spmm_dense_cells_plain(plan, twin, x, transpose, bf16)
    abs_sum = spmm_cells.spmm_dense_cells_plain(
        plan, twin.float().abs(), x.to(bf16).float().abs(), transpose)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (1500, feat)
    assert_sum_close(out, ref, abs_sum, TOLS["float32"])
    if not transpose:
        assert not out[640:768].any()          # the block without a cell
    again = spmm_cells.spmm_dense_cells_cuda(plan, twin, x, transpose, bf16)
    assert torch.equal(out, again)             # no atomics: repeatable
    # the fp32 blocks rounded by the wrapper, a bf16 x: the same products
    same = spmm_cells.spmm_dense_cells_cuda(plan, tiers["cells"], x.to(bf16),
                                            transpose, bf16)
    assert torch.equal(out, same)


def test_bf16_cells_refuse_mismatched_dtypes(cuda):
    from dgsparse_tpu_torch.kernels import _launch, spmm_cells

    st = _hybrid(cuda).storage
    plan = st.ell_plan().cells
    twin = st.tier_values(compute_dtype=torch.bfloat16)["cells_bf16"]
    x = torch.ones(1500, 8, device=cuda)
    with pytest.raises(ValueError):        # bf16 cells in the float32 mode
        spmm_cells.spmm_dense_cells_cuda(plan, twin, x)
    with pytest.raises(ValueError):
        spmm_cells.spmm_dense_cells_cuda(plan, twin, x,
                                         compute_dtype=torch.float16)
    # the C entry itself refuses bf16 cells with an fp32 B
    out = torch.empty(1500, 8, device=cuda)
    err = spmm_cells._lib().dg_spmm_dense_cells(
        1, 0, x.device.index or 0, twin.data_ptr(), plan.fwd_ptr.data_ptr(),
        None, plan.cell_cw.data_ptr(), x.data_ptr(), out.data_ptr(),
        plan.fwd_ptr.shape[0] - 1, 1500, 1500, 8, 0,
        _launch.stream(x.device))
    assert err == 1                        # cudaErrorInvalidValue


@pytest.mark.parametrize("feat", [16, 41])
def test_gat_attention_bf16_mode_matches_plain(cuda, feat, monkeypatch):
    # gat_attention(compute_dtype=bfloat16) through the tier kernels
    # against the same call on their plain versions: the forward's cells
    # and d_x's run the bf16-cell variant, d_s_row's and d_s_col's the fp32
    # kernel; the residue's bf16 output rounding may round one sum of each
    # side to neighbouring bf16 values, so 1e-2 of the largest magnitude
    sp = _hybrid(cuda, has_value=False)
    g = torch.Generator(device=cuda).manual_seed(feat)
    inputs = [torch.randn(*s, generator=g, device=cuda).requires_grad_()
              for s in ((1500,), (1500,), (1500, feat))]
    ct = torch.randn(1500, feat, generator=g, device=cuda)

    def run():
        out = pt.gat_attention(sp, *inputs, compute_dtype=torch.bfloat16)
        return out.detach(), torch.autograd.grad(out, inputs, ct)

    reset_launch_counts()
    out, grads = run()
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"csr_spmm": 4, "spmm_dense_cells": 2,
                      "spmm_dense_cells_bf16": 2, "spmm_bell": 2,
                      "sddmm_cells": 1, "sddmm_csr": 1}
    _plain_kernels(monkeypatch)
    ref, ref_grads = run()
    assert torch.isfinite(out).all()
    for a, b in zip((out, *grads), (ref, *ref_grads)):
        torch.testing.assert_close(a, b, rtol=1e-2,
                                   atol=1e-2 * b.abs().max().item())


def _heavy_bell(cuda):
    """A BELL plan whose long rows (LONG_ROW_SLOTS slots or more) take the
    kernel's warp-a-row path: (plan, slot values, degrees)."""
    from dgsparse_tpu_torch.core import planner
    from dgsparse_tpu_torch.utils.testing import block_csr

    rowptr, col, vals, n = block_csr(heavy=True)
    plan = planner.build_bell_plan(rowptr, col, n, device=cuda)
    ep = plan.eperm
    slot_vals = np.where(ep >= 0, vals[np.maximum(ep, 0)], 0)
    return (plan, torch.from_numpy(slot_vals.astype(np.float32)).to(cuda),
            torch.from_numpy(np.diff(rowptr)).to(cuda))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("feat", [1, 41, 64, 130])
@pytest.mark.parametrize("mode", ["fresh", "into_out"])
@pytest.mark.parametrize("graph", ["hybrid", "long_rows"])
def test_spmm_bell_matches_plain(cuda, graph, mode, feat, reduce, dtype):
    # the row-run kernels, into fresh zeros or added into a given out,
    # against the plain version, and bitwise repeatable
    from dgsparse_tpu_torch.kernels import spmm_bell

    if graph == "hybrid":
        st = _hybrid(cuda).storage
        plan, vals = st.ell_plan().bell, st.tier_values()["bell"]
        deg = st.rowptr()[1:] - st.rowptr()[:-1]
        assert plan.num_long_rows == 0
    else:
        plan, vals, deg = _heavy_bell(cuda)
        assert plan.num_long_rows == 3
    m, n = plan.num_rows, plan.num_cols
    g = torch.Generator(device=cuda).manual_seed(feat)
    x = torch.randn(n, feat, generator=g, device=cuda).to(
        getattr(torch, dtype))
    o = (torch.randn(m, feat, generator=g, device=cuda)
         if mode == "into_out" else None)

    def run(fn):
        if o is None:
            return fn(plan, vals, x, reduce, deg)
        dst = o.clone()
        assert fn(plan, vals, x, reduce, deg, out=dst) is dst
        return dst

    out = run(spmm_bell.spmm_bell_cuda)
    ref = run(spmm_bell.spmm_bell_plain)
    abs_sum = spmm_bell.spmm_bell_plain(plan, vals.abs(), x.float().abs(),
                                        reduce, deg)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (m, feat)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    assert torch.equal(out, run(spmm_bell.spmm_bell_cuda))  # repeatable
    if o is not None:
        standalone = spmm_bell.spmm_bell_cuda(plan, vals, x, reduce, deg)
        assert torch.equal(out, o + standalone)
        off = torch.ones(m, dtype=torch.bool, device=cuda)
        off[plan.rows.long()] = False
        assert off.any() and torch.equal(out[off], o[off])   # bits kept


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat", [1, 41, 64, 130])
def test_sddmm_cells_matches_plain(cuda, feat, dtype):
    from dgsparse_tpu_torch.kernels import spmm_cells

    plan = _hybrid(cuda).storage.ell_plan().cells
    g = torch.Generator(device=cuda).manual_seed(feat)
    dt = getattr(torch, dtype)
    d1 = torch.randn(1500, feat, generator=g, device=cuda).to(dt)
    d2 = torch.randn(1500, feat, generator=g, device=cuda).to(dt)
    out = spmm_cells.sddmm_cells_cuda(plan, d1, d2)
    ref = spmm_cells.sddmm_cells_plain(plan, d1, d2)
    abs_sum = spmm_cells.sddmm_cells_plain(plan, d1.float().abs(),
                                           d2.float().abs())
    torch.cuda.synchronize()
    assert out.shape == (plan.cell_slots,)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    again = spmm_cells.sddmm_cells_cuda(plan, d1, d2)
    assert torch.equal(out, again)             # no atomics: repeatable


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [2, 5, 24])
def test_sddmm_cells_chunks_split_and_span_row_blocks(cuda, chunk, dtype,
                                                      monkeypatch):
    # 1500 rows (the last row block holds 92); row blocks of 1-3 cells: a
    # chunk of 2 splits a row block's run, 5 and 24 span several
    from dgsparse_tpu_torch.kernels import spmm_cells

    plan = _hybrid(cuda).storage.ell_plan().cells
    assert plan.num_rows % 128 and plan.num_cells == 24
    assert int(plan.fwd_ptr.diff().max()) > 2
    monkeypatch.setattr(spmm_cells, "cells_per_cta", lambda n, sms: chunk)
    g = torch.Generator(device=cuda).manual_seed(chunk)
    dt = getattr(torch, dtype)
    d1 = torch.randn(1500, 41, generator=g, device=cuda).to(dt)
    d2 = torch.randn(1500, 41, generator=g, device=cuda).to(dt)
    out = spmm_cells.sddmm_cells_cuda(plan, d1, d2)
    ref = spmm_cells.sddmm_cells_plain(plan, d1, d2)
    abs_sum = spmm_cells.sddmm_cells_plain(plan, d1.float().abs(),
                                           d2.float().abs())
    torch.cuda.synchronize()
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])


def _bf16_operand(cuda, g, rows, feat, offset):
    """A bf16 [rows, F] operand `offset` values into its storage (1: off
    16 and 4 bytes, the element copies; 2: off 16 bytes only, the 4-byte
    copies where F is even), the storage's values past it NaN: the kernel
    must read none of them."""
    base = torch.full((rows * feat + offset + 16,), float("nan"),
                      device=cuda)
    base[offset:offset + rows * feat] = torch.randn(rows * feat, generator=g,
                                                    device=cuda)
    return base.to(torch.bfloat16)[offset:offset + rows * feat].view(rows,
                                                                      feat)


@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("feat", [1, 5, 8, 16, 41, 48, 64, 72, 130])
def test_sddmm_cells_bf16_kernel_matches_plain(cuda, feat, offset):
    # sddmm_cells_bf16_kernel: every staging (16-byte rows at F % 8 == 0,
    # the flat 16-byte pieces otherwise, 4-byte and 2-byte element copies
    # off 16 bytes), one or three 64-feature slices a cell, 1500 rows (the
    # last row block holds 92); against its plain version at 1e-5 of the
    # terms' absolute sum, and bitwise repeatable
    from dgsparse_tpu_torch.kernels import spmm_cells

    plan = _hybrid(cuda).storage.ell_plan().cells
    g = torch.Generator(device=cuda).manual_seed(feat * 3 + offset)
    d1 = _bf16_operand(cuda, g, 1500, feat, offset)
    d2 = _bf16_operand(cuda, g, 1500, feat, offset)
    reset_launch_counts()
    out = spmm_cells.sddmm_cells_cuda(plan, d1, d2)
    counts = launch_counts()
    assert (counts["sddmm_cells_bf16"], counts["sddmm_cells"]) == (1, 0)
    ref = spmm_cells.sddmm_cells_plain(plan, d1, d2)
    abs_sum = spmm_cells.sddmm_cells_plain(plan, d1.float().abs(),
                                           d2.float().abs())
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (plan.cell_slots,)
    assert torch.isfinite(out).all()
    assert_sum_close(out, ref, abs_sum, TOLS["float32"])
    assert torch.equal(out, spmm_cells.sddmm_cells_cuda(plan, d1, d2))
    # the bf16 mode's cast from float32 operands: the same products
    assert torch.equal(out, spmm_cells.sddmm_cells_cuda(
        plan, d1.float(), d2.float(), torch.bfloat16))
    assert launch_counts()["sddmm_cells"] == 0


@pytest.mark.parametrize("chunk", [2, 5, 24])
@pytest.mark.parametrize("feat", [41, 72])
def test_sddmm_cells_bf16_chunks_split_and_span_row_blocks(cuda, feat, chunk,
                                                           monkeypatch):
    # as the float32 test below: a chunk of 2 splits a row block's run of
    # cells (d1 staged anew), 5 and 24 span several; F = 72 stages d1
    # every step (two slices a cell)
    from dgsparse_tpu_torch.kernels import spmm_cells

    plan = _hybrid(cuda).storage.ell_plan().cells
    monkeypatch.setattr(spmm_cells, "cells_per_cta", lambda n, sms: chunk)
    g = torch.Generator(device=cuda).manual_seed(chunk + feat)
    d1 = torch.randn(1500, feat, generator=g, device=cuda).bfloat16()
    d2 = torch.randn(1500, feat, generator=g, device=cuda).bfloat16()
    out = spmm_cells.sddmm_cells_cuda(plan, d1, d2)
    ref = spmm_cells.sddmm_cells_plain(plan, d1, d2)
    abs_sum = spmm_cells.sddmm_cells_plain(plan, d1.float().abs(),
                                           d2.float().abs())
    torch.cuda.synchronize()
    assert_sum_close(out, ref, abs_sum, TOLS["float32"])


def test_public_sddmm_of_bf16_operands_runs_the_bf16_kernel(cuda):
    # the public sddmm of bf16 d1, d2 on a hybrid storage: the cells on
    # sddmm_cells_bf16_kernel, the other edges on the CSR SDDMM; its bf16
    # result is the hybrid route's float32 sums rounded, and those agree
    # with the CSR kernel over every edge at 1e-5 scaled
    from dgsparse_tpu_torch.ops.hybrid import sddmm_hybrid

    adj = _hybrid(cuda, seed=3)
    st = adj.storage
    g = torch.Generator(device=cuda).manual_seed(5)
    d1 = torch.randn(1500, 41, generator=g, device=cuda).bfloat16()
    d2 = torch.randn(1500, 41, generator=g, device=cuda).bfloat16()
    reset_launch_counts()
    out = pt.sddmm(adj, d1, d2)
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"sddmm_cells_bf16": 1, "sddmm_csr": 1}
    sums = sddmm_hybrid(st, d1, d2)
    assert out.dtype == torch.bfloat16 and torch.equal(out,
                                                       sums.bfloat16())
    ref = sddmm_csr.sddmm_csr_cuda(st.rowptr(), st.col(), d1,
                                   d2).reshape(-1)
    abs_sum = sddmm_csr.sddmm_csr_cuda(st.rowptr(), st.col(), d1.abs(),
                                       d2.abs()).reshape(-1)
    torch.cuda.synchronize()
    assert_sum_close(sums, ref, abs_sum, TOLS["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("has_value", [True, False])
def test_hybrid_spmm_and_grads_match_the_csr_route(cuda, reduce, has_value,
                                                   dtype):
    adj = _hybrid(cuda, has_value, seed=1)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(1500, 48, generator=g, device=cuda).to(
        getattr(torch, dtype))
    ct = torch.randn(1500, 48, generator=g, device=cuda).to(x.dtype)
    grads = {}
    for alg in (pt.Algorithm.AUTO, pt.Algorithm.XLA_SEGMENT):
        xt = x.clone().requires_grad_()
        reset_launch_counts()
        out = pt.spmm(adj, xt, reduce, alg)
        (out * ct).sum().backward()
        torch.cuda.synchronize()
        grads[alg] = (out.detach(), xt.grad, launch_counts())
    (out, gx, hyb), (ref, gref, csr) = grads.values()
    # the sums of the terms' absolute values, through the CSR route
    plain = adj.set_values(None if not has_value
                           else adj.storage.values().abs())
    abs_out = pt.spmm(plain, x.float().abs(), reduce, 0)
    abs_grad = pt.spmm(plain.t(), ct.float().abs(), "sum", 0)
    if reduce == "mean":
        deg = torch.clamp(adj.storage.rowptr().diff(), min=1).float()
        abs_grad = pt.spmm(plain.t(), ct.float().abs() / deg[:, None],
                           "sum", 0)
    assert out.dtype == x.dtype and gx.dtype == x.dtype
    assert_sum_close(out, ref, abs_out, TOLS[dtype])
    assert_sum_close(gx, gref, abs_grad, TOLS[dtype])
    # a bf16 x runs the bf16 compute mode: its cells on the bf16 variant
    cells, other = "spmm_dense_cells_bf16", "spmm_dense_cells"
    if dtype == "float32":
        cells, other = other, cells
    assert (hyb[cells], hyb[other], hyb["spmm_bell"], hyb["csr_spmm"]) \
        == (2, 0, 1, 2)
    assert (csr[cells], csr[other], csr["spmm_bell"], csr["csr_spmm"]) \
        == (0, 0, 0, 2)


def test_hybrid_tier_counters_match_the_launches(cuda):
    from dgsparse_tpu_torch.utils import metrics

    adj = _hybrid(cuda, seed=5)
    x = torch.randn(1500, 40, device=cuda, requires_grad=True)
    reset_launch_counts()
    metrics.reset()
    metrics.enable()
    try:
        pt.spmm_sum(adj, x).sum().backward()
        torch.cuda.synchronize()
        counts = metrics.cache_counters()
        spans = metrics.span_totals()
    finally:
        metrics.disable()
        metrics.reset()
    got = launch_counts()
    tiers = ("residue", "cells", "bell", "nd_t")
    assert [spans[f"dgsparse.hybrid.{t}"]["count"] for t in tiers] == \
        [counts[f"hybrid.{t}"] for t in tiers] == [1, 2, 1, 1]
    assert (counts["hybrid.residue"] + counts["hybrid.nd_t"],
            counts["hybrid.cells"], counts["hybrid.bell"]) == \
        (got["csr_spmm"], got["spmm_dense_cells"], got["spmm_bell"])


def test_hybrid_sddmm_matches_the_csr_kernel(cuda):
    adj = _hybrid(cuda, seed=3)
    st = adj.storage
    g = torch.Generator(device=cuda).manual_seed(4)
    d1 = torch.randn(1500, 40, generator=g, device=cuda)
    d2 = torch.randn(1500, 40, generator=g, device=cuda)
    reset_launch_counts()
    out = pt.sddmm(adj, d1, d2)
    counts = launch_counts()
    assert (counts["sddmm_cells"], counts["sddmm_csr"]) == (1, 1)
    ref = sddmm_csr.sddmm_csr_cuda(st.rowptr(), st.col(), d1, d2).reshape(-1)
    abs_sum = sddmm_csr.sddmm_csr_cuda(st.rowptr(), st.col(), d1.abs(),
                                       d2.abs()).reshape(-1)
    torch.cuda.synchronize()
    assert_sum_close(out, ref, abs_sum, TOLS["float32"])


def test_set_values_on_the_card_rematerializes_the_cells(cuda):
    from dgsparse_tpu_torch.core.planner import materialize_cells_np

    adj = _hybrid(cuda, seed=5)
    w = torch.rand(adj.nnz, generator=torch.Generator().manual_seed(6))
    reset_launch_counts()
    cells = adj.set_values(w.to(cuda)).storage.tier_values()["cells"]
    assert launch_counts()["segment_sum_csr"] == 1
    ref = materialize_cells_np(adj.storage.ell_plan().cells, w.numpy())
    np.testing.assert_allclose(cells.cpu().numpy(), ref, rtol=1e-6,
                               atol=1e-6)


def test_hybrid_gcn_matches_frozen_jax_fixture(cuda):
    from dgsparse_tpu_torch.utils.testing import fixture_model

    with np.load(FIXTURES / "hybrid_small.npz") as fx:
        fx = dict(fx)
    model, adj, x, _ = fixture_model(fx, "gcn", cuda)
    assert adj.storage.ell_plan() is not None
    with torch.inference_mode():
        out = model(x, adj)
    np.testing.assert_allclose(out.cpu().numpy(), fx["gcn/out"], rtol=1e-4,
                               atol=1e-4)
    reset_launch_counts()
    losses, grads = run_train_fixture(fx, "gcn", cuda, steps=2)
    counts = launch_counts()
    assert (counts["spmm_dense_cells"], counts["spmm_bell"],
            counts["csr_spmm"]) == (8, 4, 8)
    prefix = "gcn/grads/"
    assert_train_close(losses, grads, fx["gcn/losses"],
                       {k[len(prefix):]: v for k, v in fx.items()
                        if k.startswith(prefix)})


def test_plan_sorted_on_the_card_equals_the_host_plan(cuda):
    # the card's stable sorts give numpy's permutations
    from dgsparse_tpu_torch.utils.testing import hybrid_csr

    rowptr, col, vals = hybrid_csr(seed=7)
    host, card = (pt.SparseTensor.from_csr(
        rowptr, col, torch.from_numpy(vals), sparse_sizes=(1500, 1500),
        device=d).storage for d in ("cpu", cuda))
    np.testing.assert_array_equal(host.csr2csc().numpy(),
                                  card.csr2csc().cpu().numpy())
    hp, cp = host.ell_plan(), card.ell_plan()
    pairs = [(hp.cells.slot, cp.cells.slot), (hp.cells.eperm, cp.cells.eperm),
             (hp.bell.eperm, cp.bell.eperm), (hp.res.ids, cp.res.ids),
             (hp.nd_t.ids, cp.nd_t.ids)]
    for name in ("cell_rb", "cell_cw", "t_order", "fwd_ptr", "t_ptr"):
        pairs.append((getattr(hp.cells, name), getattr(cp.cells, name)))
    for name in ("lcol", "lrow", "tile_ptr", "rows", "run_ptr", "run_slot",
                 "run_len"):
        pairs.append((getattr(hp.bell, name), getattr(cp.bell, name)))
    pairs += [(hp.nd_t.col, cp.nd_t.col), (hp.edge_src, cp.edge_src)]
    for a, b in pairs:
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_array_equal(a, b)
    for k, v in host.tier_values().items():
        if v is not None:
            assert torch.equal(v, card.tier_values()[k].cpu()), k


def test_hybrid_kernels_refuse_bad_inputs(cuda):
    from dgsparse_tpu_torch.kernels import spmm_bell, spmm_cells

    st = _hybrid(cuda).storage
    hp, tiers = st.ell_plan(), st.tier_values()
    x = torch.ones(1500, 8, device=cuda)
    with pytest.raises(ValueError):
        spmm_cells.spmm_dense_cells_cuda(hp.cells, tiers["cells"], x[:10])
    with pytest.raises(ValueError):
        spmm_cells.spmm_dense_cells_cuda(hp.cells, tiers["cells"].double(),
                                         x)
    with pytest.raises(TypeError):
        spmm_cells.sddmm_cells_cuda(hp.cells, x, x.bfloat16())
    with pytest.raises(ValueError):
        spmm_bell.spmm_bell_cuda(hp.bell, tiers["bell"][:5], x)
    with pytest.raises(ValueError):
        spmm_bell.spmm_bell_cuda(hp.bell, tiers["bell"], x.cpu())
    for bad in (torch.zeros(1500, 8, dtype=torch.bfloat16, device=cuda),
                torch.zeros(1500, 9, device=cuda),
                torch.zeros(1500, 8),
                torch.zeros(8, 1500, device=cuda).t()):
        with pytest.raises(ValueError, match="out"):
            spmm_bell.spmm_bell_cuda(hp.bell, tiers["bell"], x, out=bad)


# SUM/MEAN gspmm on a hybrid storage: one forward runs the three tiers, the
# backward adds d_dense's transpose (cells, non-cell CSC) and, for MUL and
# DIV, d_values' SDDMM over every edge; DIV gathers its 1/values tiers on
# every call (one segment sum for the cells)
GSPMM_FORWARD = {"spmm_dense_cells": 1, "spmm_bell": 1, "csr_spmm": 1}
GSPMM_BACKWARD = {"spmm_dense_cells": 1, "csr_spmm": 1}
GSPMM_COUNTED = ("spmm_dense_cells", "spmm_dense_cells_bf16", "spmm_bell",
                 "csr_spmm", "sddmm_csr", "sddmm_cells", "segment_sum_csr")


def _gspmm_launches(compute, backward, bf16=False):
    want = dict.fromkeys(GSPMM_COUNTED, 0)
    for part in (GSPMM_FORWARD, GSPMM_BACKWARD if backward else {}):
        for k, v in part.items():
            want[k] += v
    if backward and compute in ("mul", "div"):
        want["sddmm_csr"] = 1
    if compute == "div":
        want["segment_sum_csr"] = 1
    if bf16:
        want["spmm_dense_cells_bf16"] = want.pop("spmm_dense_cells")
        want["spmm_dense_cells"] = 0
    return want


def _gspmm_inputs(seed=7, feat=24):
    """The small hybrid graph with values |v| in [0.5, 2] (DIV divides by
    them), x [N, feat] and a cotangent, as numpy."""
    from dgsparse_tpu_torch.utils.testing import hybrid_csr

    rowptr, col, _ = hybrid_csr(seed=seed)
    n = len(rowptr) - 1
    rng = np.random.default_rng(seed)
    vals = (rng.uniform(0.5, 2.0, len(col))
            * rng.choice([-1.0, 1.0], len(col))).astype(np.float32)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    ct = rng.standard_normal((n, feat)).astype(np.float32)
    return rowptr, col, vals, x, ct


def _gspmm_grid_case(device, inputs, compute, reduce, dtype="float32",
                     build_plans=True):
    """out, d_dense, d_values (None for copy_u) of one grid op on `device`,
    and the launches of its forward alone and of its forward + backward."""
    from dgsparse_tpu_torch.ops import gspmm as G

    rowptr, col, vals, x, ct = inputs
    n = len(rowptr) - 1
    adj = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                                   sparse_sizes=(n, n), device=device,
                                   build_plans=build_plans)
    assert (adj.storage.ell_plan() is not None) == build_plans
    vt = torch.from_numpy(vals).to(device).requires_grad_()
    sp = adj.set_values(vt)
    sp.storage.tier_values(ones=True)       # both cached tiers, built
    sp.storage.tier_values()
    name = (f"copy_u_{reduce}" if compute == "copy_u"
            else f"u_{compute}_e_{reduce}")
    xt = torch.from_numpy(x).to(device).to(getattr(torch, dtype))
    reset_launch_counts()
    getattr(G, name)(sp, xt)
    forward = {k: launch_counts()[k] for k in GSPMM_COUNTED}
    xt.requires_grad_()
    reset_launch_counts()
    out = getattr(G, name)(sp, xt)
    (out.float() * torch.from_numpy(ct).to(device)).sum().backward()
    both = {k: launch_counts()[k] for k in GSPMM_COUNTED}
    return out.detach(), xt.grad, vt.grad, forward, both


def _gspmm_abs_sums(inputs, compute, reduce):
    """The terms' absolute sums of out, d_dense and d_values: the CPU's
    plain CSR route on |v|, |x| and |ct|, SUB taken as ADD."""
    rowptr, col, vals, x, ct = inputs
    out, dx, dv, *_ = _gspmm_grid_case(
        "cpu", (rowptr, col, np.abs(vals), np.abs(x), np.abs(ct)),
        "add" if compute == "sub" else compute, reduce, build_plans=False)
    return out, dx.abs(), None if dv is None else dv.abs()


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("compute", ["mul", "div", "add", "sub", "copy_u"])
def test_hybrid_gspmm_grid_matches_the_cpu(cuda, compute, reduce):
    inputs = _gspmm_inputs()
    out, dx, dv, forward, both = _gspmm_grid_case(cuda, inputs, compute,
                                                  reduce)
    torch.cuda.synchronize()
    assert forward == _gspmm_launches(compute, False)
    assert both == _gspmm_launches(compute, True)
    ref, rdx, rdv, *_ = _gspmm_grid_case("cpu", inputs, compute, reduce)
    a_out, a_dx, a_dv = _gspmm_abs_sums(inputs, compute, reduce)
    assert torch.isfinite(out).all() and torch.isfinite(dx).all()
    assert_sum_close(out.cpu(), ref, a_out, TOLS["float32"])
    assert_sum_close(dx.cpu(), rdx, a_dx, TOLS["float32"])
    if compute == "copy_u":
        assert dv is None and rdv is None
    else:
        assert_sum_close(dv.cpu(), rdv, a_dv, TOLS["float32"])


def test_hybrid_gspmm_mul_is_spmm_bitwise_and_bf16_runs_its_mode(cuda):
    adj = _hybrid(cuda, seed=8)
    x = torch.randn(1500, 41, generator=torch.Generator(
        device=cuda).manual_seed(9), device=cuda)
    for reduce in ("sum", "mean"):
        assert torch.equal(pt.gspmm(adj, x, reduce, "mul"),
                           pt.spmm(adj, x, reduce))
    inputs = _gspmm_inputs()
    out, dx, _, forward, both = _gspmm_grid_case(cuda, inputs, "mul", "sum",
                                                 "bfloat16")
    assert forward == _gspmm_launches("mul", False, bf16=True)
    assert both == _gspmm_launches("mul", True, bf16=True)
    ref, rdx, *_ = _gspmm_grid_case(cuda, inputs, "mul", "sum")
    a_out, a_dx, _ = _gspmm_abs_sums(inputs, "mul", "sum")
    assert out.dtype == dx.dtype == torch.bfloat16
    assert_sum_close(out.cpu(), ref.cpu(), a_out, TOLS["bfloat16"])
    assert_sum_close(dx.cpu(), rdx.cpu(), a_dx, TOLS["bfloat16"])


# --- spconv: spconv_pairs and spconv_dw --------------------------------------
#
# On seeded voxel clouds: a two-batch submanifold plan, a strided plan and
# the inverse of that strided plan; forward pairs (by output, W) and dX
# pairs (by input, Wᵀ). "subm-dense" fills its grids (2,000 rows, not a
# multiple of the kernel's 128-row block; most rows have a pair at most
# offsets), so spconv_pairs takes its padded variant; "subm-sparse" fills
# ~1 % of them and takes the compacting one.

SPCONV_CHANNELS = [(8, 32), (32, 64), (64, 64), (7, 33)]
SPCONV_CLOUDS = {"subm": (1500, (16, 14, 12)), "strided": (1500, (16, 14, 12)),
                 "inverse": (1500, (16, 14, 12)),
                 "subm-dense": (2000, (10, 10, 10)),
                 "subm-sparse": (1500, (40, 40, 40))}


def _spconv_plan(cuda, kind):
    from dgsparse_tpu_torch.ops.spconv import build_rulebook, inverse_plan
    from dgsparse_tpu_torch.utils.testing import random_cloud

    points, shape = SPCONV_CLOUDS[kind]
    coords = random_cloud(points, shape, 2, seed=11)
    stride = 1 if kind.startswith("subm") else 2
    plan, _ = build_rulebook(coords, 3, stride, 1, spatial_shape=shape,
                             device=cuda)
    return inverse_plan(plan) if kind == "inverse" else plan


def _randn(cuda, seed, *shape, dtype="float32"):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=cuda).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["by_out", "by_in"])
@pytest.mark.parametrize("kind", list(SPCONV_CLOUDS))
@pytest.mark.parametrize("c_in,c_out", SPCONV_CHANNELS)
def test_spconv_pairs_matches_plain(cuda, c_in, c_out, kind, direction,
                                    dtype):
    from dgsparse_tpu_torch.kernels import spconv

    plan = _spconv_plan(cuda, kind)
    pairs = getattr(plan, direction)
    if kind == "subm-dense":                    # either side of the rule
        assert pairs.density >= 64 and pairs.num_rows % spconv.ROW_BLOCK
    elif kind == "subm-sparse":
        assert pairs.density < 8
    n_src = plan.num_in if direction == "by_out" else plan.num_out
    x = _randn(cuda, c_in, n_src, c_in, dtype=dtype)
    w = _randn(cuda, c_out, plan.k_vol, c_in, c_out, dtype=dtype)
    out = spconv.spconv_pairs_cuda(pairs, x, w)
    ref = spconv.spconv_pairs_plain(pairs, x, w)
    abs_sum = spconv.spconv_pairs_plain(pairs, x.float().abs(),
                                        w.float().abs())
    again = spconv.spconv_pairs_cuda(pairs, x, w)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert out.shape == (pairs.num_rows, c_out)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    assert torch.equal(out, again)      # no atomics: bitwise repeatable


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
@pytest.mark.parametrize("c_in,c_out", SPCONV_CHANNELS)
def test_spconv_dw_matches_plain(cuda, c_in, c_out, kind, dtype):
    from dgsparse_tpu_torch.kernels import spconv

    plan = _spconv_plan(cuda, kind)
    x = _randn(cuda, c_in, plan.num_in, c_in, dtype=dtype)
    g = _randn(cuda, c_out + 1, plan.num_out, c_out, dtype=dtype)
    out = spconv.spconv_dw_cuda(plan.by_offset, x, g)
    ref = spconv.spconv_dw_plain(plan.by_offset, x, g)
    abs_sum = spconv.spconv_dw_plain(plan.by_offset, x.float().abs(),
                                     g.float().abs())
    again = spconv.spconv_dw_cuda(plan.by_offset, x, g)
    torch.cuda.synchronize()
    assert out.shape == (plan.k_vol, c_in, c_out)
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    assert torch.equal(out, again)
    if plan.separate_mid:
        assert not out[(plan.k_vol - 1) // 2].any()


@pytest.mark.parametrize("min_chunk", [100, None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out", [(64, 64), (8, 32), (7, 33)])
def test_spconv_dw_ragged_chunks_match_plain(cuda, c_in, c_out, dtype,
                                             min_chunk, monkeypatch):
    # offsets of 1000, 37, 0 and 4129 pairs; chunks of 100 pairs (min_chunk
    # 100) or the module's own, none a multiple of the 32-pair step
    from dgsparse_tpu_torch.kernels import spconv

    if min_chunk is not None:
        monkeypatch.setattr(spconv, "DW_MIN_CHUNK", min_chunk)
    rng = np.random.default_rng(c_in + c_out)
    widx = np.repeat(np.arange(4), [1000, 37, 0, 4129])
    n_in, n_out = 900, 1100
    pairs = spconv.offset_pairs(rng.integers(0, n_in, len(widx)),
                                rng.integers(0, n_out, len(widx)), widx, 4,
                                device=cuda)
    sizes = np.diff(pairs.bounds.cpu().numpy())
    assert (sizes % 32).any()
    x = _randn(cuda, 1, n_in, c_in, dtype=dtype)
    g = _randn(cuda, 2, n_out, c_out, dtype=dtype)
    out = spconv.spconv_dw_cuda(pairs, x, g)
    ref = spconv.spconv_dw_plain(pairs, x, g)
    abs_sum = spconv.spconv_dw_plain(pairs, x.float().abs(), g.float().abs())
    again = spconv.spconv_dw_cuda(pairs, x, g)
    torch.cuda.synchronize()
    assert out.shape == (4, c_in, c_out) and not out[2].any()
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])
    assert torch.equal(out, again)      # no atomics: bitwise repeatable


@pytest.mark.parametrize("nan_bits", [0x7FC00000, 0x7FFFFFFF])
def test_tensor_core_spconv_kernels_keep_a_nan(cuda, nan_bits):
    # a NaN in x reaches every sum it enters whatever its payload: the TF32
    # split (csrc/common.cuh::tf32) must not round it into a zero
    from dgsparse_tpu_torch.kernels import spconv

    plan = _spconv_plan(cuda, "subm")
    x = _randn(cuda, 5, plan.num_in, 64)
    x.view(torch.int32)[3, 5] = nan_bits
    assert torch.isnan(x[3, 5])
    g = _randn(cuda, 6, plan.num_out, 64)
    w = _randn(cuda, 7, plan.k_vol, 64, 64)
    for out, ref in ((spconv.spconv_dw_cuda(plan.by_offset, x, g),
                      spconv.spconv_dw_plain(plan.by_offset, x, g)),
                     (spconv.spconv_pairs_cuda(plan.by_out, x, w),
                      spconv.spconv_pairs_plain(plan.by_out, x, w))):
        torch.cuda.synchronize()
        assert torch.isnan(ref).any()
        assert torch.equal(torch.isnan(out), torch.isnan(ref))


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_spconv_op_and_grads_match_the_dense_formulation(cuda, kind):
    from dgsparse_tpu_torch.kernels import reference, spconv
    from dgsparse_tpu_torch.ops.spconv import spconv as op

    plan = _spconv_plan(cuda, kind)
    x = _randn(cuda, 1, plan.num_in, 32).requires_grad_()
    w = (_randn(cuda, 2, plan.k_vol, 32, 64) * 0.1).requires_grad_()
    ct = _randn(cuda, 3, plan.num_out, 64)
    spconv.reset_launch_counts()
    out = op(x, w, plan)
    dx, dw = torch.autograd.grad(out, (x, w), ct)
    assert spconv.LAUNCHES == {"spconv_pairs": 2, "spconv_dw": 1}
    with torch.no_grad():
        ref = reference.spconv_dense(x, w, plan.o2i, plan.separate_mid)
        rdx, rdw = reference.spconv_dense_bwd(x, w, ct, plan.i2o,
                                              plan.separate_mid)
    for got, want in ((out, ref), (dx, rdx), (dw, rdw)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # the features of a network's first layer need no gradient: no dX
    spconv.reset_launch_counts()
    torch.autograd.grad(op(x.detach(), w, plan), w, ct)
    assert spconv.LAUNCHES == {"spconv_pairs": 1, "spconv_dw": 1}


def test_spconv_kernels_refuse_bad_inputs(cuda):
    from dgsparse_tpu_torch.kernels import spconv

    plan = _spconv_plan(cuda, "subm")
    x = torch.ones(plan.num_in, 8, device=cuda)
    w = torch.ones(plan.k_vol, 8, 16, device=cuda)
    with pytest.raises(ValueError):
        spconv.spconv_pairs_cuda(plan.by_out, x, w.bfloat16())
    with pytest.raises(ValueError):
        spconv.spconv_pairs_cuda(plan.by_out, x, w[:, :4].contiguous())
    with pytest.raises(ValueError):
        spconv.spconv_pairs_cuda(plan.by_out, x.cpu(), w)
    with pytest.raises(ValueError):
        spconv.spconv_dw_cuda(plan.by_offset, x, x.bfloat16())
    with pytest.raises(ValueError):
        spconv.spconv_dw_cuda(plan.by_offset, x.t(), x)


def test_unet_entry_on_card(cuda):
    from dgsparse_tpu_torch.entry import (TRAIN_CONFIGS, build_trainer,
                                          train_step)

    reset_launch_counts()
    model, opt, (st, x, y) = build_trainer("unet", device=cuda)
    losses = [float(train_step(model, opt, x, st, y)) for _ in range(3)]
    counts = launch_counts()
    # per step: 4 forward and 3 dX spconv_pairs (the first layer's input
    # is data), 4 spconv_dw
    assert (counts["spconv_pairs"], counts["spconv_dw"]) == (21, 12)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert TRAIN_CONFIGS["unet"].lr == 1e-3


# --- the slot-space attention: widths F + 1 (the denominator column) ---------

_PLAIN = (("spmm_csr", "csr_spmm"), ("sddmm_csr", "sddmm_csr"),
          ("spmm_cells", "spmm_dense_cells"), ("spmm_cells", "sddmm_cells"),
          ("spmm_bell", "spmm_bell"))


def _plain_kernels(monkeypatch):
    """Every tier kernel's plain version in place of its launch."""
    import importlib

    for mod, name in _PLAIN:
        m = importlib.import_module(f"dgsparse_tpu_torch.kernels.{mod}")
        monkeypatch.setattr(m, f"{name}_cuda", getattr(m, f"{name}_plain"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat", [17, 42])
def test_tier_kernels_at_ragged_attention_widths(cuda, feat, dtype):
    # gat-reddit's heads of 16 and 41 features aggregate [x, 1]: the
    # residue's csr_spmm, spmm_dense_cells both ways and spmm_bell into out
    from dgsparse_tpu_torch.kernels import spmm_bell, spmm_cells

    st = _hybrid(cuda).storage
    hp, tiers = st.ell_plan(), st.tier_values()
    g = torch.Generator(device=cuda).manual_seed(feat)
    dt = getattr(torch, dtype)
    x = torch.randn(1500, feat, generator=g, device=cuda).to(dt)
    cases = [(spmm_csr.csr_spmm_cuda, spmm_csr.csr_spmm_plain,
              (hp.res.rowptr, hp.res.col, tiers["res"], x),
              (hp.res.rowptr, hp.res.col, tiers["res"].abs(),
               x.float().abs()))]
    for transpose in (False, True):
        cases.append((spmm_cells.spmm_dense_cells_cuda,
                      spmm_cells.spmm_dense_cells_plain,
                      (hp.cells, tiers["cells"], x, transpose),
                      (hp.cells, tiers["cells"].abs(), x.float().abs(),
                       transpose)))
    for kernel, plain, args, abs_args in cases:
        out = kernel(*args)
        assert_sum_close(out, plain(*args), plain(*abs_args), TOLS[dtype])
    o = torch.randn(1500, feat, generator=g, device=cuda)
    out = spmm_bell.spmm_bell_cuda(hp.bell, tiers["bell"], x, out=o.clone())
    ref = spmm_bell.spmm_bell_plain(hp.bell, tiers["bell"], x, out=o.clone())
    abs_sum = spmm_bell.spmm_bell_plain(hp.bell, tiers["bell"].abs(),
                                        x.float().abs(), out=o.abs())
    torch.cuda.synchronize()
    assert_sum_close(out, ref, abs_sum, TOLS[dtype])


@pytest.mark.parametrize("feat", [16, 41])
def test_gat_attention_matches_plain(cuda, feat, monkeypatch):
    # the fused attention through the tier kernels against the same call
    # on their plain versions, forward and the gradients of s_row, s_col
    # and x (rtol 1e-4, atol 1e-5 of each one's largest value, as the
    # training steps' gradients), with the launches of one call
    sp = _hybrid(cuda, has_value=False)
    g = torch.Generator(device=cuda).manual_seed(feat)
    inputs = [torch.randn(*s, generator=g, device=cuda).requires_grad_()
              for s in ((1500,), (1500,), (1500, feat))]
    ct = torch.randn(1500, feat, generator=g, device=cuda)

    def run():
        out = pt.gat_attention(sp, *inputs)
        return out.detach(), torch.autograd.grad(out, inputs, ct)

    reset_launch_counts()
    out, grads = run()
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"csr_spmm": 4, "spmm_dense_cells": 4, "spmm_bell": 2,
                      "sddmm_cells": 1, "sddmm_csr": 1}
    _plain_kernels(monkeypatch)
    ref, ref_grads = run()
    assert torch.isfinite(out).all()       # row block 5 has no dense cell
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item())


def test_attention_matches_frozen_jax_fixture(cuda):
    with np.load(FIXTURES / "attention_small.npz") as f:
        fx = dict(f)
    n = fx["x"].shape[0]
    sp = pt.SparseTensor.from_csr(fx["rowptr"], fx["col"], None,
                                  sparse_sizes=(n, n), device=cuda)
    inputs = [torch.from_numpy(fx[k]).to(cuda).requires_grad_()
              for k in ("s_row", "s_col", "x")]
    out = pt.gat_attention(sp, *inputs)
    grads = torch.autograd.grad(out, inputs,
                                torch.from_numpy(fx["ct"]).to(cuda))
    np.testing.assert_allclose(out.detach().cpu().numpy(), fx["attn/out"],
                               rtol=2e-4, atol=2e-4)
    for name, gr in zip(("s_row", "s_col", "x"), grads):
        np.testing.assert_allclose(gr.cpu().numpy(), fx[f"attn/grads/{name}"],
                                   rtol=2e-3, atol=2e-3, err_msg=name)


# --- native rulebooks, tuning, validation, bf16 -----------------------------

def test_native_rulebooks_on_card_equal_numpy(cuda, monkeypatch):
    from dgsparse_tpu_torch import native
    from dgsparse_tpu_torch.ops import spconv as ops
    from dgsparse_tpu_torch.utils.testing import random_cloud

    native.build()
    assert native.available()
    coords = random_cloud(3000, (24, 20, 16), 2, seed=5)
    native_path = ops._native_rulebook
    for stride in (1, 2):
        args = (coords, 3, stride, 1)
        monkeypatch.setattr(ops, "_native_rulebook", native_path)
        a, ao = ops.build_rulebook(*args, spatial_shape=(24, 20, 16),
                                   device=cuda)
        monkeypatch.setattr(ops, "_native_rulebook", lambda *_: None)
        b, bo = ops.build_rulebook(*args, spatial_shape=(24, 20, 16),
                                   device=cuda)
        np.testing.assert_array_equal(ao, bo)
        for f in ("imap", "omap", "widx", "o2i", "i2o"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for f in ("by_out", "by_in"):
            for t in ("ptr", "src", "widx"):
                assert torch.equal(getattr(getattr(a, f), t),
                                   getattr(getattr(b, f), t)), (f, t)


def test_tuner_on_card_times_both_routes(cuda, tmp_path, monkeypatch):
    from dgsparse_tpu_torch.utils import metrics, tune
    from dgsparse_tpu_torch.utils.testing import hybrid_csr

    monkeypatch.setenv("DGSPARSE_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setattr(tune, "_CACHE", None)
    rowptr, col, values = hybrid_csr()
    n = len(rowptr) - 1
    sp = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                  sparse_sizes=(n, n), device=cuda)
    for with_grad in (False, True):
        best, times = tune.tune_spmm(sp, 41, with_grad=with_grad,
                                     iters=(2, 5))
        assert set(times) == {pt.Algorithm.XLA_SEGMENT,
                              pt.Algorithm.PALLAS_ROW_TILE}
        assert all(t > 0 for t in times.values())
    assert torch.cuda.get_device_name(0) in (tmp_path / "tune.json"
                                             ).read_text()
    fwd_best = tune.cached_algorithm(sp, 41)
    metrics.reset()
    metrics.enable()
    try:
        pt.spmm(sp, torch.ones(n, 41, device=cuda))
    finally:
        metrics.disable()
    (key,), = [list(metrics.counters())]
    metrics.reset()
    assert dict(key[1:])["alg"] == fwd_best.name


def test_validation_on_card_raises_before_a_launch(cuda):
    from dgsparse_tpu_torch.utils import debug

    rowptr, col, values = random_csr(300, 200, avg_degree=6.0, seed=3)
    sp = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                  sparse_sizes=(300, 200), device=cuda)
    good = sp.storage.col().clone()
    sp.storage._col[5] = 10 ** 6
    x = torch.ones(200, 16, device=cuda)
    debug.set_validate(True)
    reset_launch_counts()
    try:
        with pytest.raises(ValueError, match="col indices out of range"):
            pt.spmm(sp, x)
    finally:
        debug.set_validate(False)
    assert launch_counts()["csr_spmm"] == 0
    sp.storage._col = good
    out = pt.spmm(sp, x)
    torch.cuda.synchronize()
    assert launch_counts()["csr_spmm"] == 1 and torch.isfinite(out).all()


def test_bf16_layer_on_card_matches_fp32(cuda):
    from dgsparse_tpu_torch.nn.sparse_conv import SubMConv3d
    from dgsparse_tpu_torch.ops.spconv import SparseConvTensor
    from dgsparse_tpu_torch.utils.testing import random_cloud

    coords = random_cloud(3000, (24, 20, 16), 2, seed=9)
    gen = torch.Generator().manual_seed(0)
    f32 = SubMConv3d(64, 64, generator=gen).to(cuda)
    bf16 = SubMConv3d(64, 64, compute_dtype=torch.bfloat16).to(cuda)
    bf16.load_state_dict(f32.state_dict())
    x = _randn(cuda, 4, len(coords), 64)
    st = SparseConvTensor(x, coords, (24, 20, 16))
    ct = _randn(cuda, 5, len(coords), 64)
    outs = []
    for layer in (bf16, f32):
        xi = x.clone().requires_grad_()
        out = layer(st.replace(features=xi)).features
        (out.float() * ct).sum().backward()
        outs.append((out, xi.grad, layer.kernel.grad))
    assert outs[0][0].dtype == torch.bfloat16
    with torch.no_grad():
        abs_sum = SubMConv3d(64, 64).to(cuda)
        abs_sum.kernel.copy_(f32.kernel.abs())
        scale = abs_sum(st.replace(features=x.abs())).features
    assert_sum_close(outs[0][0].float(), outs[1][0], scale, 1e-2)
    for got, want in zip(outs[0][1:], outs[1][1:]):
        assert (got - want).abs().max().item() <= \
            1e-2 * want.abs().max().item()
