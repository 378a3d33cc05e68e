#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dgsparse_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:
  1. device: the card's name and power limit; TF32 off.
  2. build: csrc/spmm_csr.cu for sm_90a with nvcc, with ptxas's resource
     lines.
  3. kernels vs their plain PyTorch versions on the card: csr_spmm and
     segment_sum_csr on a p2p-Gnutella31-shaped synthetic graph at F=32
     and on a graph with empty rows at F in {1, 7, 32, 64, 128, 256},
     SUM and MEAN, with and without values, in float32 at 1e-5 and in
     bfloat16 at 1e-2 (both accumulate in float32; bf16 adds one output
     rounding). The tolerance scales with the sum of the terms' absolute
     values (`utils.testing.assert_sum_close`): the kernel sums each row in
     edge order and the plain index_add_ with atomics in varying order, and
     on rows of ~300 terms that order alone moves a float32 sum by more
     than 1e-5 of a result that cancels.
  4. the port's GCN against the JAX package's frozen output
     (tests/fixtures/torch_port/gcn_small.npz) at 1e-4.
  5. the main path: 5 GCN forward requests each at the Cora shape and at
     the arxiv scale, eval mode under inference_mode, through the kernel
     (2 launches per forward), checked finite and against the same model
     with the plain SpMM at 1e-4.
  6. CUDA-event times of the kernel, its plain version and torch.sparse
     CSR matmul (cuSPARSE, a comparator only) at the p2p shape and at
     each GCN layer's shape.
Then one JSON line of per-kernel results, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "torch_port",
                       "gcn_small.npz")
# bench.py:57-61 — the p2p-Gnutella31 shape; the .mtx is not in the repo
P2P_NODES, P2P_EDGES = 62586, 147892
FEATS = (1, 7, 32, 64, 128, 256)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
REQUESTS = 5


def log(*args):
    print(*args, flush=True)


def max_err(out, ref, tol):
    """Max |out - ref|; raises unless out matches ref at rtol = atol = tol."""
    import torch

    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    return (out.float() - ref.float()).abs().max().item() if out.numel() \
        else 0.0


def phase_device(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(card)
    return name, card


def phase_build():
    from dgsparse_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build("spmm_csr")
    wall = time.perf_counter() - t0
    log(f"[build] {built.path} nvcc {built.seconds:.2f} s "
        f"(wall {wall:.2f} s, cached={built.cached})")
    for line in built.log.splitlines():
        if any(k in line for k in ("registers", "spill", "smem",
                                   "Compiling entry")):
            log(f"[build]   {line.strip()}")


def _to(device, *arrays):
    import torch

    return [None if a is None else torch.from_numpy(a).to(device)
            for a in arrays]


def phase_kernels(torch, cuda):
    import numpy as np

    from dgsparse_tpu_torch.kernels import spmm_csr as K
    from dgsparse_tpu_torch.utils.testing import assert_sum_close, random_csr

    errs = {"csr_spmm": {"float32": 0.0, "bfloat16": 0.0},
            "segment_sum_csr": {"float32": 0.0, "bfloat16": 0.0}}
    gen = torch.Generator(device=cuda).manual_seed(0)

    def spmm_case(tag, rowptr, col, values, n, feat, reduce, dtype):
        x = torch.randn(n, feat, generator=gen, device=cuda).to(
            getattr(torch, dtype))
        out = K.csr_spmm_cuda(rowptr, col, values, x, reduce)
        ref = K.csr_spmm_plain(rowptr, col, values, x, reduce)
        abs_sum = K.csr_spmm_plain(
            rowptr, col, None if values is None else values.abs(),
            x.float().abs(), reduce)
        torch.cuda.synchronize()
        e = assert_sum_close(out, ref, abs_sum, TOL[dtype])
        errs["csr_spmm"][dtype] = max(errs["csr_spmm"][dtype], e)
        log(f"[kernels] csr_spmm {tag} F={feat} {reduce} "
            f"values={values is not None} {dtype}: max_abs_err {e:.3e}")

    def segsum_case(tag, rowptr, nnz, feat, dtype):
        c = torch.randn(nnz, feat, generator=gen, device=cuda).to(
            getattr(torch, dtype))
        out = K.segment_sum_csr_cuda(rowptr, c)
        ref = K.segment_sum_csr_plain(rowptr, c)
        abs_sum = K.segment_sum_csr_plain(rowptr, c.float().abs())
        torch.cuda.synchronize()
        e = assert_sum_close(out, ref, abs_sum, TOL[dtype])
        errs["segment_sum_csr"][dtype] = max(
            errs["segment_sum_csr"][dtype], e)
        log(f"[kernels] segment_sum_csr {tag} F={feat} {dtype}: "
            f"max_abs_err {e:.3e}")

    rp, col, vals = random_csr(P2P_NODES, P2P_NODES,
                               avg_degree=P2P_EDGES / P2P_NODES, seed=0,
                               skew=1.0)
    rowptr, col_t, vals_t = _to(cuda, rp, col, np.abs(vals))
    log(f"[kernels] p2p-shaped synthetic graph: {P2P_NODES} nodes, "
        f"{len(col)} edges")
    for reduce, dtype, v in (("sum", "float32", vals_t),
                             ("mean", "float32", vals_t),
                             ("sum", "float32", None),
                             ("sum", "bfloat16", vals_t)):
        spmm_case("p2p", rowptr, col_t, v, P2P_NODES, 32, reduce, dtype)
    segsum_case("p2p", rowptr, len(col), 32, "float32")

    rp, col, vals = random_csr(20000, 15000, avg_degree=6.0, seed=1)
    assert (np.diff(rp) == 0).any()
    rowptr, col_t, vals_t = _to(cuda, rp, col, vals)
    log(f"[kernels] graph with empty rows: 20000 x 15000, {len(col)} edges, "
        f"{int((np.diff(rp) == 0).sum())} empty rows")
    for feat in FEATS:
        for dtype in ("float32", "bfloat16"):
            for reduce in ("sum", "mean"):
                for v in (vals_t, None):
                    spmm_case("empty-rows", rowptr, col_t, v, 15000, feat,
                              reduce, dtype)
            segsum_case("empty-rows", rowptr, len(col), feat, dtype)
    return errs


def _fixture_params(fx):
    return {f"conv{i}": {"linear": {"kernel": fx[f"conv{i}_kernel"],
                                    "bias": fx[f"conv{i}_bias"]}}
            for i in (1, 2)}


def phase_fixture(torch, cuda):
    import numpy as np

    from dgsparse_tpu_torch import SparseTensor
    from dgsparse_tpu_torch.nn import GCN, load_flax_params

    with np.load(FIXTURE) as f:
        fx = dict(f)
    n, fin = fx["x"].shape
    hidden, classes = fx["conv1_kernel"].shape[1], fx["out"].shape[1]
    adj = SparseTensor.from_csr(fx["rowptr"], fx["col"],
                                torch.from_numpy(fx["vals"]),
                                sparse_sizes=(n, n), device=cuda)
    model = GCN(fin, hidden, classes).to(cuda)
    load_flax_params(model, _fixture_params(fx)).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(fx["x"]).to(cuda), adj)
    e = max_err(out, torch.from_numpy(fx["out"]).to(cuda), 1e-4)
    log(f"[fixture] GCN {fin}->{hidden}->{classes} on {n} nodes vs the JAX "
        f"package's PALLAS_EDGE_TILE output: max_abs_err {e:.3e}")


def plain_forward(model, x, adj):
    """The GCN forward with the plain SpMM in place of the kernel."""
    import torch

    from dgsparse_tpu_torch.kernels.spmm_csr import csr_spmm_plain

    st = adj.storage

    def aggregate(h):
        return csr_spmm_plain(st.rowptr(), st.col(), st.values(), h, "sum",
                              coo_row=st.coo_row())

    h = torch.relu(aggregate(model.conv1.linear(x)))
    return aggregate(model.conv2.linear(h))


def phase_slice(torch, cuda):
    from dgsparse_tpu_torch.entry import CONFIGS, build_model, synthetic_graph
    from dgsparse_tpu_torch.kernels import spmm_csr as K

    runs = {}
    for config in ("cora", "arxiv"):
        t0 = time.perf_counter()
        adj, x, _ = synthetic_graph(config, seed=0, device=cuda)
        model = build_model(config, seed=0, device=cuda)
        with torch.inference_mode():
            ref = plain_forward(model, x, adj)
        torch.cuda.synchronize()
        log(f"[slice] {config}: {adj.sparse_sizes()[0]} nodes, {adj.nnz} "
            f"nnz with self-loops, GCN {model.conv1.linear.in_features}->"
            f"{model.conv1.linear.out_features}->"
            f"{model.conv2.linear.out_features}; host graph build and "
            f"upload {time.perf_counter() - t0:.2f} s")
        runs[config] = (adj, x, model, ref)

    K.reset_launch_counts()
    per_config = {}
    for config, (adj, x, model, _) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        before = K.LAUNCHES["csr_spmm"]
        latencies = []
        with torch.inference_mode():
            for _ in range(REQUESTS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model(x, adj)
                torch.cuda.synchronize()
                latencies.append((time.perf_counter() - t0) * 1e3)
        per_config[config] = (out, latencies,
                              K.LAUNCHES["csr_spmm"] - before,
                              torch.cuda.max_memory_allocated())
    launches = dict(K.LAUNCHES)

    for config, (out, latencies, n_launch, peak) in per_config.items():
        adj, _, model, ref = runs[config]
        cfg = CONFIGS[config]
        if n_launch != 2 * REQUESTS:
            raise AssertionError(
                f"{config}: csr_spmm launched {n_launch} times in "
                f"{REQUESTS} forwards, expected {2 * REQUESTS}")
        if tuple(out.shape) != (cfg.num_nodes, cfg.num_classes):
            raise AssertionError(f"{config}: output shape {out.shape}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{config}: non-finite output")
        e = max_err(out, ref, 1e-4)
        log(f"[slice] {config}: {REQUESTS} requests, latency ms "
            f"{[round(t, 4) for t in latencies]}, csr_spmm launches "
            f"{n_launch}, max_memory_allocated {peak} B, vs plain SpMM "
            f"max_abs_err {e:.3e}")
    return runs, launches


def phase_numbers(torch, cuda, runs):
    import numpy as np

    from dgsparse_tpu_torch.core.transform import expand_rowptr
    from dgsparse_tpu_torch.kernels import spmm_csr as K
    from dgsparse_tpu_torch.utils.bench import cuda_time, spmm_gflops
    from dgsparse_tpu_torch.utils.testing import random_csr

    rp, col, vals = random_csr(P2P_NODES, P2P_NODES,
                               avg_degree=P2P_EDGES / P2P_NODES, seed=0,
                               skew=1.0)
    rowptr, col_t, vals_t = _to(cuda, rp, col, np.abs(vals))
    cases = [("p2p-synthetic F=32", rowptr, col_t, vals_t,
              expand_rowptr(rowptr, col_t.numel()), P2P_NODES, 32)]
    for config, (adj, _, model, _) in runs.items():
        st = adj.storage
        for layer in ("conv1", "conv2"):
            feat = getattr(model, layer).linear.out_features
            cases.append((f"{config} {layer} F={feat}", st.rowptr(),
                          st.col(), st.values(), st.coo_row(),
                          adj.sparse_sizes()[1], feat))

    gen = torch.Generator(device=cuda).manual_seed(1)
    results = {}
    for label, rowptr, col_t, vals_t, coo_row, n, feat in cases:
        m = rowptr.numel() - 1
        nnz = col_t.numel()
        x = torch.randn(n, feat, generator=gen, device=cuda)
        a = torch.sparse_csr_tensor(rowptr, col_t, vals_t, size=(m, n))
        t = {"plain": [], "kernel": [], "cusparse": []}
        # in turns, so drift in clocks hits every version alike
        for order in (("plain", "kernel", "cusparse"),
                      ("cusparse", "kernel", "plain")):
            for who in order:
                if who == "kernel":
                    s = cuda_time(K.csr_spmm_cuda, rowptr, col_t, vals_t, x)
                elif who == "plain":
                    s = cuda_time(K.csr_spmm_plain, rowptr, col_t, vals_t, x,
                                  "sum", coo_row)
                else:
                    s = cuda_time(torch.matmul, a, x)
                t[who].append(s)
        best = {k: min(v) for k, v in t.items()}
        results[label] = best
        log(f"[numbers] {label} ({m} rows, {nnz} nnz, fp32): " + ", ".join(
            f"{k} {best[k] * 1e6:.2f} us {spmm_gflops(nnz, feat, best[k]):.2f}"
            f" GF/s" for k in ("kernel", "plain", "cusparse")))
    return results


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a card",
              file=sys.stderr)
        return 1
    try:
        import dgsparse_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: dgsparse_tpu_torch not found beside this script",
              file=sys.stderr)
        return 1
    try:
        cuda = torch.device("cuda", 0)
        name, card = phase_device(torch)
        phase_build()
        errs = phase_kernels(torch, cuda)
        phase_fixture(torch, cuda)
        runs, launches = phase_slice(torch, cuda)
        times = phase_numbers(torch, cuda, runs)
        if "jax" in sys.modules:
            raise AssertionError("JAX was imported")
    except Exception:
        traceback.print_exc()
        return 1
    timed = "arxiv conv1 F=256"
    kernels = [{
        "name": "csr_spmm",
        "route": "cuda",
        "source": "dgsparse_tpu_torch/csrc/spmm_csr.cu",
        "replaces": "dgsparse_tpu/kernels/pallas_spmm.py:103",
        "launches": launches["csr_spmm"],
        "max_abs_err": errs["csr_spmm"]["float32"],
        "max_abs_err_bf16": errs["csr_spmm"]["bfloat16"],
        "ms": times[timed]["kernel"] * 1e3,
        "plain_ms": times[timed]["plain"] * 1e3,
        "timed_shape": timed,
        "card": card,
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
