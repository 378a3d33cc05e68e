"""The port's spans and cache counters (`utils/metrics.py`), on the CPU.

- Off (the default): `span` returns the shared null span, nothing is
  recorded, and a step's autograd graph holds no node of the tracing.
- On: a GCN and a GAT training step through `entry.train_step` give the
  span tree step > forward > model > op spans, each op's backward span a
  child of its forward span, every span under the step's root.
- Under `torch.profiler`, each span of the window is one host range
  named `<name>#<id>`, inside its parent's.
- The storage's construction phases fill `build_seconds` and are spans;
  the tier values count as built or reused.
- On a hybrid storage, each tier of the SpMM and of its transpose is a
  span inside the op's, tagged with what prices it, and counts one launch;
  the plan's shape tags its set-up span. Off, none of it is recorded.
"""

import json
from collections import Counter

import pytest
import torch
from torch.nn import functional as F

import dgsparse_tpu_torch as pt
from dgsparse_tpu_torch import entry
from dgsparse_tpu_torch.core import planner
from dgsparse_tpu_torch.utils import metrics
from dgsparse_tpu_torch.utils.testing import hybrid_csr

@pytest.fixture
def tracing():
    metrics.reset()
    metrics.enable()
    yield
    metrics.disable()
    metrics.reset()


@pytest.fixture(scope="module")
def trainers():
    return {cfg: entry.build_trainer(cfg, device="cpu")
            for cfg in ("gcn-cora", "gat-cora")}


def _graph_nodes(loss) -> Counter:
    """The names of the autograd nodes behind `loss`, counted."""
    seen, stack, names = set(), [loss.grad_fn], Counter()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names[fn.name()] += 1
        stack.extend(f for f, _ in fn.next_functions)
    return names


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_adds_no_node(trainers):
    model, opt, (adj, x, y) = trainers["gat-cora"]
    metrics.reset()
    assert not metrics.enabled()
    assert metrics.span("dgsparse.step", a=1) is metrics.NULL_SPAN
    assert metrics.current() is None
    off = _graph_nodes(F.cross_entropy(model(x, adj), y))
    entry.train_step(model, opt, x, adj, y)
    assert metrics.spans() == [] and metrics.span_totals() == {}
    assert metrics.cache_counters() == {}
    metrics.enable()
    try:
        on = _graph_nodes(F.cross_entropy(model(x, adj), y))
    finally:
        metrics.disable()
        metrics.reset()
    # tracing adds no autograd node: every op's backward span is opened by
    # the op's own Function
    assert on == off


def _step_tree(trainers, cfg):
    model, opt, (adj, x, y) = trainers[cfg]
    entry.train_step(model, opt, x, adj, y)
    spans = metrics.spans()
    names = _by_name(spans)
    (step,) = names["dgsparse.step"]
    assert step["parent"] is None and step["root"] == step["id"]
    assert {s["root"] for s in spans} == {step["id"]}
    for phase in ("forward", "loss", "backward", "optimizer"):
        (s,) = names[f"dgsparse.step.{phase}"]
        assert s["parent"] == step["id"]
    byid = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"].endswith(".bwd"):
            fwd = byid[s["parent"]]
            assert fwd["name"] == s["name"][:-4] + ".fwd"
            assert s["start_ns"] >= fwd["end_ns"]
    return names, adj


def test_gcn_step_tree(tracing, trainers):
    names, adj = _step_tree(trainers, "gcn-cora")
    (fwd,) = names["dgsparse.step.forward"]
    (model,) = names["dgsparse.model.GCN.forward"]
    assert model["parent"] == fwd["id"]
    assert model["tags"] == {"nodes": adj.shape[0], "nnz": adj.nnz}
    ops = names["dgsparse.op.spmm.csr.fwd"]
    assert [s["parent"] for s in ops] == [model["id"]] * 2
    assert [(s["tags"]["nnz"], s["tags"]["f"]) for s in ops] == \
        [(adj.nnz, 64), (adj.nnz, 7)]
    assert all(s["tags"]["has_values"] and not s["tags"]["d_values"]
               for s in ops)
    bwd = names["dgsparse.op.spmm.csr.bwd"]
    assert sorted(s["parent"] for s in bwd) == sorted(s["id"] for s in ops)
    assert all(s["tags"]["d_dense"] and not s["tags"]["d_values"]
               for s in bwd)
    totals = metrics.span_totals()
    assert totals["dgsparse.op.spmm.csr.fwd"]["count"] == 2
    assert totals["dgsparse.step"]["self_s"] < \
        totals["dgsparse.step"]["host_s"]
    assert "dgsparse.op.spmm.csr.fwd" in metrics.summary()


def test_gat_step_tree(tracing, trainers):
    names, adj = _step_tree(trainers, "gat-cora")
    (model,) = names["dgsparse.model.GAT.forward"]
    for op in ("edge_softmax.edge", "spmm_multihead.csr"):
        fwd = names[f"dgsparse.op.{op}.fwd"]
        bwd = names[f"dgsparse.op.{op}.bwd"]
        assert [s["parent"] for s in fwd] == [model["id"]] * 2
        assert sorted(s["parent"] for s in bwd) == \
            sorted(s["id"] for s in fwd)
    assert [s["tags"]["heads"] for s in
            names["dgsparse.op.spmm_multihead.csr.fwd"]] == [4, 1]
    got = Counter(k[0] for k in metrics.counters())
    assert got == Counter({"edge_softmax": 2, "spmm_multihead": 2})


def test_spans_join_the_profiler_trace(tracing, trainers, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    model, opt, (adj, x, y) = trainers["gat-cora"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        entry.train_step(model, opt, x, adj, y)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = Counter()
    at = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "cpu_op" and name.startswith("dgsparse."):
            base, _, sid = name.rpartition("#")
            ranges[int(sid)] += 1
            at[int(sid)] = (base, e["ts"], e["ts"] + e["dur"])
    spans = metrics.spans()
    assert len(spans) > 10
    assert ranges == Counter({s["id"]: 1 for s in spans})
    for s in spans:
        name, t0, t1 = at[s["id"]]
        assert name == s["name"]
        if s["parent"] is None:
            continue
        _, p0, p1 = at[s["parent"]]
        # a backward span starts after its forward span; every other span
        # lies inside its parent's
        assert p0 <= t0 and (s["name"].endswith(".bwd") or t1 <= p1)


def test_storage_phases_and_tier_counters(tracing):
    rowptr, col, values = hybrid_csr()
    vals = torch.from_numpy(values)
    sp = pt.SparseTensor.from_csr(rowptr, col, vals,
                                  sparse_sizes=(len(rowptr) - 1,) * 2)
    st = sp.storage
    assert set(st.build_seconds) == {"host_check", "csc", "upload",
                                     "split_plan", "hybrid_plan",
                                     "tier_values"}
    names = _by_name(metrics.spans())
    (build,) = names["dgsparse.storage.build"]
    for phase in st.build_seconds:
        (s,) = names[f"dgsparse.storage.build.{phase}"]
        assert s["parent"] == build["id"]
    assert metrics.cache_counters() == {"tier_values.built": 1}
    st.tier_values()
    assert metrics.cache_counters() == {"tier_values.built": 1,
                                        "tier_values.reused": 1}
    st.values().mul_(2.0)
    st.tier_values()
    st.tier_values()
    assert metrics.cache_counters() == {"tier_values.built": 2,
                                        "tier_values.reused": 2}
    assert len(_by_name(metrics.spans())["dgsparse.storage.tier_values"]) \
        == 1


def test_build_seconds_without_tracing():
    rowptr, col, values = hybrid_csr()
    st = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                  sparse_sizes=(len(rowptr) - 1,) * 2).storage
    assert set(st.build_seconds) == {"host_check", "csc", "upload",
                                     "split_plan", "hybrid_plan",
                                     "tier_values"}
    assert all(v >= 0 for v in st.build_seconds.values())
    assert metrics.spans() == []


def test_span_cap_keeps_the_newest(tracing, monkeypatch):
    import collections

    monkeypatch.setattr(metrics, "_spans", collections.deque(maxlen=3))
    for i in range(5):
        with metrics.span("dgsparse.test", i=i):
            pass
    assert [s["tags"]["i"] for s in metrics.spans()] == [2, 3, 4]
    assert metrics.span_totals()["dgsparse.test"]["count"] == 5


def _hybrid_step():
    """A hybrid storage of every tier and one SpMM forward and backward
    at F = 24 through `spmm_sum`."""
    rowptr, col, values = hybrid_csr()
    sp = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                  sparse_sizes=(len(rowptr) - 1,) * 2)
    hp = sp.storage.ell_plan()
    assert hp is not None and hp.cells is not None and hp.bell is not None
    x = torch.randn(sp.shape[1], 24, requires_grad=True,
                    generator=torch.Generator().manual_seed(3))
    pt.spmm_sum(sp, x).square().sum().backward()
    return sp, hp


def test_hybrid_tier_spans_and_counters(tracing):
    sp, hp = _hybrid_step()
    names = _by_name(metrics.spans())
    (fwd,) = names["dgsparse.op.spmm.hybrid.fwd"]
    (bwd,) = names["dgsparse.op.spmm.hybrid.bwd"]
    (res,) = names["dgsparse.hybrid.residue"]
    (bell,) = names["dgsparse.hybrid.bell"]
    (nd_t,) = names["dgsparse.hybrid.nd_t"]
    cells = names["dgsparse.hybrid.cells"]
    assert [s["parent"] for s in (res, bell, nd_t)] == \
        [fwd["id"], fwd["id"], bwd["id"]]
    assert [(s["parent"], s["tags"]["transpose"]) for s in cells] == \
        [(fwd["id"], False), (bwd["id"], True)]
    m, n = sp.shape
    assert res["tags"] == {"m": m, "nnz": hp.res.nnz, "f": 24}
    assert all(s["tags"] == {"cells": hp.cells.num_cells, "f": 24,
                             "transpose": s["tags"]["transpose"]}
               for s in cells)
    assert bell["tags"] == {"rows": hp.bell.num_bell_rows,
                            "long_rows": hp.bell.num_long_rows,
                            "slots": hp.bell.padded_edges, "f": 24}
    assert nd_t["tags"] == {"n": n, "nnz": hp.nd_t.nnz, "f": 24}
    # one count a tier launch: the forward's three, the transpose's two
    launches = {k: v for k, v in metrics.cache_counters().items()
                if k.startswith("hybrid.")}
    assert launches == {"hybrid.residue": 1, "hybrid.cells": 2,
                        "hybrid.bell": 1, "hybrid.nd_t": 1}
    assert launches == {f"hybrid.{k[len('dgsparse.hybrid.'):]}": len(v)
                        for k, v in names.items()
                        if k.startswith("dgsparse.hybrid.")}


def test_hybrid_plan_span_tags(tracing):
    rowptr, col, values = hybrid_csr()
    st = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                                  sparse_sizes=(len(rowptr) - 1,) * 2).storage
    hp = st.ell_plan()
    (span,) = _by_name(metrics.spans())["dgsparse.storage.build.hybrid_plan"]
    assert span["tags"] == planner.describe(hp)
    assert span["tags"] == {
        "cells": hp.cells.num_cells, "cell_edges": hp.cells.nnz,
        "dense_fraction": hp.dense_fraction,
        "bell_rows": hp.bell.num_bell_rows,
        "bell_slots": hp.bell.padded_edges, "residue_nnz": hp.res.nnz,
        "nd_t_nnz": hp.nd_t.nnz}
    assert hp.cells.nnz + hp.bell.nnz + hp.res.nnz == st.nnz
    assert hp.bell.nnz + hp.res.nnz == hp.nd_t.nnz


def test_hybrid_tiers_off_record_nothing():
    metrics.reset()
    assert not metrics.enabled()
    _hybrid_step()
    assert metrics.spans() == [] and metrics.span_totals() == {}
    assert metrics.cache_counters() == {}
