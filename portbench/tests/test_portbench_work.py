"""Each op's work count against a case counted by hand."""

from pathlib import Path

import pytest

from portbench.lib import spec

from portbench.tests.helpers import ROOT


def work(op):
    return spec.named(ROOT, "work", op)


def test_spmm_sum_counts():
    # m = 3 rows, n = 4 columns, nnz = 5, f = 2, with values:
    # FLOPs 2*5*2 = 20; bytes (4 offsets + 5 cols + 5 vals + 4*2 dense
    # + 3*2 out) * 4 = 28 * 4
    w = work("spmm_sum")
    assert w.forward(m=3, n=4, nnz=5, f=2, has_values=True) == (20.0, 112.0)
    assert w.forward(m=3, n=4, nnz=5, f=2, has_values=False) == (20.0, 92.0)
    # backward, d_dense only: 20 FLOPs; offsets 4 + cols 5 + g 3*2 +
    # values 5 + d_dense 4*2 = 28 elements
    assert w.backward(m=3, n=4, nnz=5, f=2, has_values=True, d_dense=True,
                      d_values=False) == (20.0, 112.0)
    # both: 40 FLOPs; + dense 4*2 read + 5 d_values written = 41 elements
    assert w.backward(m=3, n=4, nnz=5, f=2, has_values=True, d_dense=True,
                      d_values=True) == (40.0, 164.0)


def test_spmm_multihead_counts():
    # m = n = 2, nnz = 3, H = 2, f = 4: 2*3*8 = 48 FLOPs; elements 3 + 3
    # + values 6 + dense 16 + out 16 = 44
    w = work("spmm_multihead")
    assert w.forward(m=2, n=2, nnz=3, heads=2, f=4) == (48.0, 176.0)
    # both gradients: 96 FLOPs; 3 + 3 + g 16 + (6 + 16) + (16 + 6) = 66
    assert w.backward(m=2, n=2, nnz=3, heads=2, f=4, d_dense=True,
                      d_values=True) == (96.0, 264.0)


def test_edge_softmax_counts():
    # m = 2, nnz = 3, H = 2: 6 elements; forward 5*6 FLOPs, 3 offsets +
    # 6 in + 6 out; backward 4*6, 3 + 6 * 3
    w = work("edge_softmax")
    assert w.forward(m=2, nnz=3, heads=2) == (30.0, 60.0)
    assert w.backward(m=2, nnz=3, heads=2) == (24.0, 84.0)


def test_dense_counts():
    assert work("linear").flops(2, 3, 4) == 48.0
    assert work("sddmm").flops(5, 3) == 30.0


@pytest.mark.parametrize("model,train,expected", [
    # GCN 4 -> 3 -> 2 on 10 nodes, 30 nnz: forward 2*10*4*3 + 2*30*3 +
    # 2*10*3*2 + 2*30*2 = 240 + 180 + 120 + 120 = 660; a step adds
    # 240 + 180 + 2*120 + 120 = 780
    ("gcn", False, 660.0), ("gcn", True, 1440.0),
    # GAT 4 -> 2 heads x 3 -> 2 on 10 nodes, 30 nnz: forward
    # 2*10*4*6 + 2*30*6 + 2*10*6*2 + 2*30*2 = 480 + 360 + 240 + 120 =
    # 1200; a step adds 480 + 360 + 360 + 2*240 + 120 + 120 = 1920
    ("gat", False, 1200.0), ("gat", True, 3120.0)])
def test_model_flops(model, train, expected):
    ref = spec.named(ROOT, "reference", model)
    cfg = {"in_features": 4, "hidden_features": 3 if model == "gcn" else 3,
           "num_classes": 2, "num_layers": 2, "num_heads": 2}
    assert ref.model_flops(cfg, 10, 30, train) == expected
