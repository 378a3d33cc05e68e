"""The program's spans in a profiler trace (`lib/spans.py`) and the readers
over them, on synthetic Chrome events; and `program_trace.py` end to end
on the CPU at a small size."""

import types

import pytest
from pytest import approx

from portbench import program_trace
from portbench.lib import spans, spec, trace
from portbench.tests.helpers import ROOT, SMALL_GRAPH


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


SPMM = dict(m=3, n=4, nnz=5, f=2, heads=1, reduce="sum", has_values=True,
            d_dense=True, d_values=False)
RECORDS = [
    {"id": 1, "name": "dgsparse.model.GAT.forward", "parent": None,
     "tags": {}},
    {"id": 2, "name": "dgsparse.op.gat_attention.edge.fwd", "parent": 1,
     "tags": {}},
    {"id": 3, "name": "dgsparse.op.spmm.csr.fwd", "parent": 2, "tags": SPMM},
    {"id": 4, "name": "dgsparse.op.spmm.csr.fwd", "parent": 1, "tags": SPMM},
    {"id": 5, "name": "dgsparse.op.spmm.csr.bwd", "parent": 4, "tags": SPMM},
]
EVENTS = [
    _x("user_annotation", trace.WINDOW, 0, 100),
    _x("user_annotation", "dgsparse.model.GAT.forward#1", 2, 40),
    # an op inside another op: its kernel counts to the outer span
    _x("user_annotation", "dgsparse.op.gat_attention.edge.fwd#2", 4, 10),
    _x("user_annotation", "dgsparse.op.spmm.csr.fwd#3", 6, 4),
    _x("cuda_runtime", "cudaLaunchKernel", 7, 1, correlation=1),
    _x("user_annotation", "dgsparse.op.spmm.csr.fwd#4", 20, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=2),
    # the backward on the autograd thread
    _x("user_annotation", "dgsparse.op.spmm.csr.bwd#5", 60, 10, tid=2),
    _x("cuda_driver", "cuLaunchKernel", 61, 1, tid=2, correlation=3),
    _x("kernel", "spmm_kernel", 8, 6, tid=7, correlation=1),
    _x("kernel", "spmm_kernel", 30, 10, tid=7, correlation=2),
    _x("kernel", "spmm_t_kernel", 62, 8, tid=7, correlation=3),
]


def _ctx(prog, works=None, **extra):
    return types.SimpleNamespace(
        trace={"program": prog},
        peaks={"fp32_flops": 1e12, "hbm_bytes_per_s": 1e9},
        works=works or {n: spec.named(ROOT, "work", n)
                        for n in ("spmm_sum", "spmm_multihead",
                                  "edge_softmax")}, **extra)


def test_parse_counts_the_outermost_op_span():
    prog = spans.parse(EVENTS, RECORDS)
    assert [(o["name"], o["id"]) for o in prog["ops"]] == [
        ("dgsparse.op.gat_attention.edge.fwd", 2),
        ("dgsparse.op.spmm.csr.fwd", 4), ("dgsparse.op.spmm.csr.bwd", 5)]
    assert [o["device_s"] for o in prog["ops"]] == approx([6e-6, 10e-6, 8e-6])
    assert [o["host_s"] for o in prog["ops"]] == approx([10e-6, 5e-6, 10e-6])
    assert prog["unmatched"] == 0
    assert prog["ops"][1]["tags"] == SPMM


def test_op_roofline_prices_outer_spans_and_needs_a_work_count():
    prog = spans.parse(EVENTS, RECORDS)
    reader = spec.reader(ROOT, "op_roofline.train")
    # gat_attention has no work count: no reading
    assert reader.read(_ctx(prog)) is None
    prog["ops"] = prog["ops"][1:]
    # forward 112 B and backward 112 B at 1e9 B/s over 18 us of device
    assert reader.read(_ctx(prog)) == approx(100 * 224e-9 / 18e-6)
    prog["unmatched"] = 1
    assert reader.read(_ctx(prog)) is None
    assert reader.read(_ctx(None)) is None


def test_op_host_us_is_per_forward_call():
    prog = spans.parse(EVENTS, RECORDS)
    reader = spec.reader(ROOT, "op_host_us.serve")
    # (10 + 5 + 10) us over the two outer forward spans
    assert reader.read(_ctx(prog)) == approx(12.5)
    assert reader.read(_ctx(None)) is None


def test_idle_is_split_by_an_open_program_span():
    prog = spans.parse(EVENTS, RECORDS)
    # busy [8, 14], [30, 40], [62, 70]; the gaps' middles: 4 and 22 under
    # GAT.forward, 51 and 85 under no program span
    assert prog["idle_s"] == approx(76e-6)
    assert prog["idle_program_s"] == approx((8 + 16) * 1e-6)
    got = spec.reader(ROOT, "device_idle_program.train").read(_ctx(prog))
    assert got == approx(24.0)
    assert got <= 100 * (1 - trace.parse(EVENTS)["busy_s"] / 100e-6)


def test_program_setup_s_takes_outermost_setup_spans():
    def rec(i, name, parent, t0, t1):
        return {"id": i, "name": name, "parent": parent, "tags": {},
                "start_ns": t0, "end_ns": t1}

    records = [
        rec(1, "dgsparse.adjacency.gcn_norm", None, 0, 10**9),
        rec(2, "dgsparse.storage.build", None, 10**9, 3 * 10**9),
        rec(3, "dgsparse.storage.build.csc", 2, 10**9, 2 * 10**9),
        rec(4, "dgsparse.model.GCN.forward", None, 4 * 10**9, 6 * 10**9),
        rec(5, "dgsparse.kernels.load.spmm_csr", 4, 4 * 10**9, 5 * 10**9),
        rec(6, "dgsparse.setup.optimizer", None, 7 * 10**9, 7 * 10**9 + 5)]
    assert [r["id"] for r in spans.setup_spans(records)] == [1, 2, 5, 6]
    reader = spec.reader(ROOT, "program_setup_s")
    assert reader.read(types.SimpleNamespace(setup_spans=records)) == \
        approx(4.0 + 5e-9)
    assert reader.read(types.SimpleNamespace()) is None


@pytest.mark.parametrize("cell", ["gcn-arxiv.serve", "gat-arxiv.train"])
def test_program_trace_on_the_cpu(cell, cpu):
    out = program_trace.run(cell, 2**33 + 7, 0.1, 1, cpu, SMALL_GRAPH)
    m = out["metrics"]
    suffix = ".train" if cell.endswith("train") else ".serve"
    assert m["program_setup_s"] > 0
    assert m["op_host_us" + suffix] > 0
    assert m["device_idle_program" + suffix] is not None
    # no peaks on the CPU
    assert m["op_roofline" + suffix] is None
    assert out["op_spans"] >= 2 * out["iterations"]
    assert set(out["traced_ms"]) == {"off", "on"}
