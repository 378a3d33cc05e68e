"""The reduction of a profiler trace: device time attributed to the op
range open on the launching thread, busy time as a union, idle gaps named
by the host op innermost at their middle, and the readers over it."""

import types

import pytest
from pytest import approx

from portbench.lib import spec, trace
from portbench.tests.helpers import ROOT


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


EVENTS = [
    _x("user_annotation", trace.WINDOW, 0, 100),
    # the forward range on thread 1, launching kernel 1 (corr 1)
    _x("user_annotation", "portbench.op.spmm_sum.fwd", 10, 10),
    _x("cpu_op", "aten::mm", 30, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=2),
    # the backward range on thread 2, launching kernel 3 by cuLaunchKernel
    _x("user_annotation", "portbench.op.spmm_sum.bwd", 50, 20, tid=2),
    _x("cuda_driver", "cuLaunchKernel", 55, 1, tid=2, correlation=3),
    _x("kernel", "spmm_kernel", 14, 6, tid=7, correlation=1),
    _x("kernel", "gemm_kernel", 32, 8, tid=7, correlation=2),
    _x("kernel", "spmm_t_kernel", 60, 4, tid=7, correlation=3),
    _x("gpu_memset", "Memset", 62, 4, tid=7, correlation=99),
]


def test_parse_attributes_and_unions():
    out = trace.parse(EVENTS)
    assert out["window_s"] == approx(100e-6)
    # [14, 20] + [32, 40] + [60, 66], the memset inside the last
    assert out["busy_s"] == approx(20e-6)
    assert out["op_device_s"] == approx({"spmm_sum.fwd": 6e-6,
                                         "spmm_sum.bwd": 4e-6})
    assert out["unmatched"] == 1
    assert out["device_ops"][0] == ["gemm_kernel", approx(8e-6)]
    # gaps [0, 14], [20, 32], [66, 100] have no host op at their middle;
    # the backward range covers 50, the middle of [40, 60]
    assert dict(out["idle_gaps"]) == approx(
        {"(no host op)": 60e-6, "portbench.op.spmm_sum.bwd": 20e-6})


def _ctx(tr, train=True):
    return types.SimpleNamespace(
        trace=tr, peaks={"fp32_flops": 1e12, "hbm_bytes_per_s": 1e9},
        works={"spmm_sum": spec.named(ROOT, "work", "spmm_sum")},
        train=train, seconds_per_iter=0.5,
        storage_build_s=1.5,
        cfg={"in_features": 4, "hidden_features": 3, "num_classes": 2,
             "num_layers": 2}, num_nodes=10, nnz=30,
        reference=spec.named(ROOT, "reference", "gcn"))


def test_readers():
    shapes = dict(m=3, n=4, nnz=5, f=2, has_values=True, d_dense=True,
                  d_values=False)
    tr = {"calls": [("spmm_sum", shapes, True)], "unmatched": 0,
          "op_device_s": {"spmm_sum.fwd": 1e-6, "spmm_sum.bwd": 1e-6},
          "busy_s": 0.25, "window_s": 1.0}
    # least: forward 112 B / 1e9 B/s, backward the same; 224 ns of 2 us
    got = spec.reader(ROOT, "sparse_roofline.train").read(_ctx(tr))
    assert got == approx(100 * 224e-9 / 2e-6)
    tr["unmatched"] = 1
    assert spec.reader(ROOT, "sparse_roofline.train").read(_ctx(tr)) is None
    assert spec.reader(ROOT, "device_idle.train").read(_ctx(tr)) == 75.0
    assert spec.reader(ROOT, "storage_build_s").read(_ctx(tr)) == 1.5
    # 1440 model FLOPs a step over 0.5 s at 1e12
    mfu = spec.reader(ROOT, "mfu.train").read(_ctx(tr))
    assert mfu == approx(100 * 1440 / (0.5 * 1e12))
    assert spec.reader(ROOT, "mfu.serve").read(
        types.SimpleNamespace(**{**vars(_ctx(tr)), "peaks": {}})) is None


def test_ops_the_configuration_runs_must_show():
    called = {"calls": [("spmm_sum", {}, True), ("edge_softmax", {}, False)]}
    trace.require_ops(called, ["spmm_sum"], True)
    trace.require_ops(called, ["spmm_sum", "edge_softmax"], False)
    with pytest.raises(RuntimeError, match="edge_softmax"):
        trace.require_ops(called, ["edge_softmax"], True)
    with pytest.raises(RuntimeError, match="spmm_multihead"):
        trace.require_ops(called, ["spmm_multihead"], False)


def test_a_target_not_found_fails_and_restores():
    from dgsparse_tpu_torch.ops import spmm

    work = types.SimpleNamespace(TARGETS=(
        "dgsparse_tpu_torch.ops.spmm:spmm_sum",
        "dgsparse_tpu_torch.ops.spmm:no_such_op"))
    before = spmm.spmm_sum
    with pytest.raises(RuntimeError, match="no_such_op"):
        with trace.OpRanges({"spmm_sum": work}):
            pass
    assert spmm.spmm_sum is before
