"""The benchmark's `gcn-reddit` configuration on the CPU at a small size:
its graph generator, its blocked reference, and the port on the hybrid
route against that reference.

- `portbench/graphs/clustered.py` draws what the port's
  `utils/testing.py::clustered_graph` draws, bit for bit.
- `portbench/reference/gcn_blocked.py`, with blocks smaller than the edge
  count, gives `reference/gcn.py`'s logits, loss and gradients, at float32
  and at the TF32 control's precision: the same sums, in the same edge
  order, cut into blocks.
- The port's `nn.GCN` through the benchmark's model file, on a clustered
  graph that passes the hybrid gate, against the blocked reference on the
  same seeded weights: the logits, then the first Adam step's loss,
  gradients and update. Float32 sums in another order: 1e-5 of the
  largest value, and the update's norm within 1e-4 (Adam's first step is
  about lr times the gradient's sign, which round-off near zero flips).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dgsparse_tpu_torch import entry  # noqa: E402
from dgsparse_tpu_torch.core.transform import expand_rowptr_np  # noqa: E402
from dgsparse_tpu_torch.utils import metrics  # noqa: E402
from dgsparse_tpu_torch.utils.testing import clustered_graph  # noqa: E402
from portbench.lib import inputs, spec  # noqa: E402

CPU = torch.device("cpu")
# the configuration's graph cut to 2,000 nodes of degree 60: every tier
# of the hybrid plan, ~120,000 edges
SMALL = {"generator": "clustered", "num_nodes": 2000, "avg_degree": 60,
         "community": 194, "intra": 0.8}
BLOCK = 7_000                  # edges a block: 18 blocks at SMALL's size


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setattr(spec.named(ROOT, "reference", "gcn_blocked"),
                        "BLOCK_EDGES", BLOCK)


def _cfg() -> dict:
    cfg = spec.config(spec.load_benchmark(ROOT), ROOT, "gcn-reddit")
    cfg["graph"] = dict(SMALL)
    return cfg


def _inputs(cfg: dict, seed: int = 2**40 + 11):
    return inputs.make(cfg, spec.named(ROOT, "graphs", "clustered"),
                       spec.named(ROOT, "reference", "gcn_blocked"), seed,
                       CPU)


@pytest.mark.parametrize("n,deg,comm,intra,seed", [
    (500, 20.0, 194, 0.8, 0), (1000, 40.0, 150, 0.6, 7),
    (333, 12.5, 50, 0.9, 2**35 + 3)])
def test_clustered_equals_testing_clustered_graph(n, deg, comm, intra,
                                                  seed):
    gen = spec.named(ROOT, "graphs", "clustered")
    got = gen.make({"num_nodes": n, "avg_degree": deg, "community": comm,
                    "intra": intra}, seed)
    rowptr, col = clustered_graph(n, n, deg, seed=seed, intra=intra,
                                  comm=comm)
    assert got["num_nodes"] == n
    assert got["edge_index"].dtype == np.int64
    np.testing.assert_array_equal(got["edge_index"][0],
                                  expand_rowptr_np(rowptr))
    np.testing.assert_array_equal(got["edge_index"][1], col)


@pytest.mark.parametrize("prec", ["fp32", "tf32"])
def test_blocked_reference_equals_gcn_reference(prec):
    cfg = _cfg()
    inp = _inputs(cfg)
    blocked = spec.named(ROOT, "reference", "gcn_blocked")
    plain = spec.named(ROOT, "reference", "gcn")
    common = spec.named(ROOT, "reference", "common")
    ctx = blocked.prepare(cfg, inp.graph, CPU)
    assert ctx["block"] < ctx["edge_index"].shape[1] // 10
    assert blocked.param_specs(cfg) == plain.param_specs(cfg)
    assert blocked.model_flops(cfg, 100, 1000, True) == \
        plain.model_flops(cfg, 100, 1000, True)
    got = blocked.forward(cfg, ctx, inp.x, inp.weights, prec)
    want = plain.forward(cfg, plain.prepare(cfg, inp.graph, CPU), inp.x,
                         inp.weights, prec)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    runs = [common.train(ref, cfg, inp.graph, inp.x, inp.y, inp.weights, 2,
                         prec) for ref in (blocked, plain)]
    np.testing.assert_allclose(runs[0]["losses"], runs[1]["losses"],
                               rtol=1e-6)
    for k, g in runs[1]["grads"].items():
        torch.testing.assert_close(runs[0]["grads"][k], g, rtol=0,
                                   atol=1e-6 * float(g.abs().max()))


def test_tf32_control_departs_from_fp32():
    cfg = _cfg()
    inp = _inputs(cfg)
    blocked = spec.named(ROOT, "reference", "gcn_blocked")
    ctx = blocked.prepare(cfg, inp.graph, CPU)
    fp32, tf32 = (blocked.forward(cfg, ctx, inp.x, inp.weights, p)
                  for p in ("fp32", "tf32"))
    assert float((fp32 - tf32).abs().max()) > 1e-5 * float(fp32.abs().max())


def test_port_on_the_hybrid_route_matches_the_blocked_reference():
    cfg = _cfg()
    inp = _inputs(cfg)
    adapter = spec.named(ROOT, "models", "gcn_blocked")
    ref = spec.named(ROOT, "reference", "gcn_blocked")
    common = spec.named(ROOT, "reference", "common")
    adj = adapter.adjacency(cfg, inp.graph, CPU)
    hp = adj.storage.ell_plan()
    assert hp is not None and hp.cells is not None and hp.bell is not None
    assert adapter.nnz(adj) == inp.graph["edge_index"].shape[1] + \
        SMALL["num_nodes"]
    model = adapter.build(cfg, inp.weights, CPU)
    params = adapter.param_map(model)

    metrics.reset()
    metrics.enable()
    try:
        logits = model(inp.x, adj)
    finally:
        metrics.disable()
    routes = {k for k in metrics.span_totals() if k.startswith("dgsparse.op")}
    metrics.reset()
    assert routes == {"dgsparse.op.spmm.hybrid.fwd"}
    want = ref.forward(cfg, ref.prepare(cfg, inp.graph, CPU), inp.x,
                       inp.weights, "fp32")
    torch.testing.assert_close(logits.detach(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))

    start = {k: p.detach().clone() for k, (p, _) in params.items()}
    opt = entry.build_optimizer(model, cfg["optimizer"]["lr"])
    loss = entry.train_step(model, opt, inp.x, adj, inp.y)
    run = common.train(ref, cfg, inp.graph, inp.x, inp.y, inp.weights, 1,
                       "fp32")
    assert abs(float(loss) - run["losses"][0]) <= 1e-5 * run["losses"][0]
    for k, (p, transposed) in params.items():
        g = p.grad.t() if transposed else p.grad
        g_ref = run["grads"][k]
        torch.testing.assert_close(g, g_ref, rtol=0,
                                   atol=1e-5 * float(g_ref.abs().max()))
        step = p.detach() - start[k]
        step = step.t() if transposed else step
        step_ref = run["params"][k] - inp.weights[k]
        assert float((step - step_ref).norm()) <= \
            1e-4 * float(step_ref.norm()), k
