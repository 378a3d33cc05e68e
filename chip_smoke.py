#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dgsparse_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:
  1. device: the card's name and power limit; TF32 off.
  2. build: csrc/spmm_csr.cu and csrc/sddmm_csr.cu for sm_90a, one nvcc
     each, started together, with ptxas's resource lines.
  3. kernels vs their plain PyTorch versions on the card, on a
     p2p-Gnutella31-shaped synthetic graph and on a graph with empty rows:
     - csr_spmm and segment_sum_csr at F=32 (p2p) and F in {1, 7, 32, 64,
       128, 256} (empty rows), SUM and MEAN, with and without values;
     - sddmm_csr at H in {1, 4} heads and F per head in {1, 7, 16, 32, 64,
       128}, SUM and MEAN;
     - csr_spmm with 4 heads (values [nnz, 4]) at F per head in {1, 7, 16,
       64}, SUM and MEAN, against the plain multi-head SpMM;
     - csr_spmm over the CSC view (the backward's transpose) with 1 and 4
       heads, against the plain transpose (CSR edges summed into columns);
     all in float32 at 1e-5 and bfloat16 at 1e-2 (the CSC case in float32),
     both accumulating in float32. The tolerance scales with the sum of the
     terms' absolute values (`utils.testing.assert_sum_close`): the kernels
     sum in their own order and the plain index_add_ with atomics in
     varying order, and on rows of ~300 terms that order alone moves a
     float32 sum by more than 1e-5 of a result that cancels.
  4. fixtures: the port's GCN forward against the JAX package's frozen
     output (tests/fixtures/torch_port/gcn_small.npz) at 1e-4; its GCN and
     GAT training against the frozen JAX training run (train_small.npz):
     3 Adam steps on the kernel path, losses at 1e-4, step-1 gradients at
     rtol 1e-4 and atol 1e-5 * max|g|.
  5. main path 1, serving: 5 GCN forward requests each at the Cora shape
     and at the arxiv scale, eval mode under inference_mode, through the
     kernel (2 launches per forward), checked finite and against the same
     model with the plain SpMM at 1e-4.
  6. main path 2, training: 5 Adam steps each of gcn-cora, gat-cora,
     gcn-arxiv and gat-arxiv (`entry.TRAIN_CONFIGS`) through the kernels,
     with exact launches per step (GCN: csr_spmm 4, sddmm_csr 0; GAT: 4
     and 2), finite and falling losses, per-step latency (host clock
     around synchronize) and max_memory_allocated. Before that run, the
     same step 1 against the plain versions on the card: logits at 1e-4,
     and the gradients of every parameter at rtol 1e-4, atol
     1e-5 * max|g|, from one shared forward (`_oracle` says why).
  7. numbers: CUDA-event times, in float32, of each kernel, its plain
     version and one PyTorch call computing the same function where there
     is one (torch.sparse CSR matmul, i.e. cuSPARSE, for the SpMM, over a
     block-diagonal CSR of H copies for H heads; torch.sparse.sampled_addmm
     over a batched CSR for the SDDMM; comparators only, never called by
     the port; the multi-head and SDDMM ones held to the kernel at 1e-4),
     at the p2p shape and at
     the shapes of both main paths, beside the bound: the larger of the
     compulsory bytes (each input read once, each output written once)
     over 3.35 TB/s and the flops over 67 TFLOP/s (H100 SXM data sheet).
  8. profile: the time of the per-edge gather of an [N, 4] fp32 table,
     contiguous and column-major; torch.profiler over 3 training steps
     each of gcn-arxiv and gat-arxiv after 2 warm-up steps, device time
     per step by kernel and the device's busy share of the wall time.
Then one JSON line of per-kernel results, the card's name and power
limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures", "torch_port")
FIXTURE = os.path.join(FIXTURES, "gcn_small.npz")
TRAIN_FIXTURE = os.path.join(FIXTURES, "train_small.npz")
# bench.py:57-61 — the p2p-Gnutella31 shape; the .mtx is not in the repo
P2P_NODES, P2P_EDGES = 62586, 147892
FEATS = (1, 7, 32, 64, 128, 256)
SDDMM_FEATS = (1, 7, 16, 32, 64, 128)
MH_FEATS = (1, 7, 16, 64)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
REQUESTS = 5
STEPS = 5
# kernel launches per training step: the forward and d_dense of both
# layers, plus d_values of both layers where the edge values are
# attention weights (a GCN's adjacency is constant)
STEP_LAUNCHES = {"gcn": {"csr_spmm": 4, "sddmm_csr": 0},
                 "gat": {"csr_spmm": 4, "sddmm_csr": 2}}
# H100 SXM data sheet: HBM and fp32 peaks
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
KERNELS = ("spmm_csr", "sddmm_csr")
# the wrappers each main path launches, as `kernels.launch_counts` names them
KERNEL_NAMES = ("csr_spmm", "sddmm_csr")


def log(*args):
    print(*args, flush=True)


def max_err(out, ref, tol):
    """Max |out - ref|; raises unless out matches ref at rtol = atol = tol."""
    import torch

    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    return (out.float() - ref.float()).abs().max().item() if out.numel() \
        else 0.0


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    built = _build.build_all(KERNELS)
    wall = time.perf_counter() - t0
    for name, b in built.items():
        log(f"[build] {b.path} nvcc {b.seconds:.2f} s (cached={b.cached})")
        for line in b.log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(built)} kernels in {wall:.2f} s wall")


def _to(device, *arrays):
    import torch

    return [None if a is None else torch.from_numpy(a).to(device)
            for a in arrays]


def phase_kernels(torch, cuda):
    import numpy as np

    from dgsparse_tpu_torch import SparseTensor
    from dgsparse_tpu_torch.kernels import reference
    from dgsparse_tpu_torch.kernels import sddmm_csr as S
    from dgsparse_tpu_torch.kernels import spmm_csr as K
    from dgsparse_tpu_torch.ops.types import ReduceOp
    from dgsparse_tpu_torch.utils.testing import assert_sum_close, random_csr

    errs = {k: {"float32": 0.0, "bfloat16": 0.0}
            for k in ("csr_spmm", "segment_sum_csr", "sddmm_csr")}
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, dtype="float32"):
        return torch.randn(*shape, generator=gen, device=cuda).to(
            getattr(torch, dtype))

    def record(kernel, dtype, e):
        errs[kernel][dtype] = max(errs[kernel][dtype], e)
        return e

    def spmm_case(tag, rowptr, col, values, n, feat, reduce, dtype):
        x = randn(n, feat, dtype=dtype)
        out = K.csr_spmm_cuda(rowptr, col, values, x, reduce)
        ref = K.csr_spmm_plain(rowptr, col, values, x, reduce)
        abs_sum = K.csr_spmm_plain(
            rowptr, col, None if values is None else values.abs(),
            x.float().abs(), reduce)
        torch.cuda.synchronize()
        e = record("csr_spmm", dtype,
                   assert_sum_close(out, ref, abs_sum, TOL[dtype]))
        heads = 1 if values is None or values.dim() == 1 else values.shape[1]
        log(f"[kernels] csr_spmm {tag} H={heads} F={feat // heads} {reduce} "
            f"values={values is not None} {dtype}: max_abs_err {e:.3e}")

    def segsum_case(tag, rowptr, nnz, feat, dtype):
        c = randn(nnz, feat, dtype=dtype)
        out = K.segment_sum_csr_cuda(rowptr, c)
        ref = K.segment_sum_csr_plain(rowptr, c)
        abs_sum = K.segment_sum_csr_plain(rowptr, c.float().abs())
        torch.cuda.synchronize()
        e = record("segment_sum_csr", dtype,
                   assert_sum_close(out, ref, abs_sum, TOL[dtype]))
        log(f"[kernels] segment_sum_csr {tag} F={feat} {dtype}: "
            f"max_abs_err {e:.3e}")

    def sddmm_cases(tag, rowptr, col, m, n):
        for heads in (1, 4):
            for feat in SDDMM_FEATS:
                worst = []
                for dtype in ("float32", "bfloat16"):
                    d1 = randn(m, heads * feat, dtype=dtype)
                    d2 = randn(n, heads * feat, dtype=dtype)
                    for reduce in ("sum", "mean"):
                        out = S.sddmm_csr_cuda(rowptr, col, d1, d2, heads,
                                               reduce)
                        ref = S.sddmm_csr_plain(rowptr, col, d1, d2, heads,
                                                reduce)
                        abs_sum = S.sddmm_csr_plain(
                            rowptr, col, d1.float().abs(), d2.float().abs(),
                            heads, reduce)
                        torch.cuda.synchronize()
                        worst.append(record("sddmm_csr", dtype,
                                            assert_sum_close(
                                                out, ref, abs_sum,
                                                TOL[dtype])))
                log(f"[kernels] sddmm_csr {tag} H={heads} F={feat} "
                    f"sum/mean fp32/bf16: max_abs_err {max(worst):.3e}")

    def heads_cases(tag, rowptr, col, n):
        for feat in MH_FEATS:
            for dtype in ("float32", "bfloat16"):
                values = randn(col.numel(), 4)
                for reduce in ("sum", "mean"):
                    spmm_case(tag, rowptr, col, values, n, 4 * feat, reduce,
                              dtype)

    def transpose_case(tag, rowptr_np, col_np, m, n):
        st = SparseTensor.from_csr(rowptr_np, col_np, sparse_sizes=(m, n),
                                   device=cuda).storage
        for heads in (1, 4):
            values = randn(st.nnz, heads)
            g = randn(m, heads * 16)
            out = K.csr_spmm_cuda(st.colptr(), st.row(),
                                  values[st.csr2csc().long()], g)
            # the plain transpose: CSR edges summed into their columns
            ref = reference.spmm_mh(st.col(), st.coo_row(), values,
                                    g.view(m, heads, 16), n, ReduceOp.SUM)
            abs_sum = reference.spmm_mh(st.col(), st.coo_row(), values.abs(),
                                        g.abs().view(m, heads, 16), n,
                                        ReduceOp.SUM)
            torch.cuda.synchronize()
            e = record("csr_spmm", "float32", assert_sum_close(
                out, ref.view(n, -1), abs_sum.view(n, -1), TOL["float32"]))
            log(f"[kernels] csr_spmm over CSC {tag} H={heads} F=16 vs the "
                f"plain transpose: max_abs_err {e:.3e}")

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
    sddmm_cases("p2p", rowptr, col_t, P2P_NODES, P2P_NODES)
    heads_cases("p2p", rowptr, col_t, P2P_NODES)
    transpose_case("p2p", rp, col, P2P_NODES, P2P_NODES)

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
    sddmm_cases("empty-rows", rowptr, col_t, 20000, 15000)
    heads_cases("empty-rows", rowptr, col_t, 15000)
    transpose_case("empty-rows", rp, col, 20000, 15000)
    return errs


def _fixture_params(fx):
    return {f"conv{i}": {"linear": {"kernel": fx[f"conv{i}_kernel"],
                                    "bias": fx[f"conv{i}_bias"]}}
            for i in (1, 2)}


def phase_fixture(torch, cuda):
    import numpy as np

    from dgsparse_tpu_torch import SparseTensor
    from dgsparse_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dgsparse_tpu_torch.nn import GCN, load_flax_params
    from dgsparse_tpu_torch.utils.testing import (assert_train_close,
                                                  run_train_fixture)

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

    with np.load(TRAIN_FIXTURE) as f:
        fx = dict(f)
    for name in ("gcn", "gat"):
        reset_launch_counts()
        losses, grads = run_train_fixture(fx, name, cuda, steps=3)
        counts = launch_counts()
        for kernel, per_step in STEP_LAUNCHES[name].items():
            if counts[kernel] != 3 * per_step:
                raise AssertionError(
                    f"{name} fixture: {kernel} launched {counts[kernel]} "
                    f"times in 3 steps, expected {3 * per_step}")
        prefix = f"{name}/grads/"
        loss_err, grad_err = assert_train_close(
            losses, grads, fx[f"{name}/losses"],
            {k[len(prefix):]: v for k, v in fx.items()
             if k.startswith(prefix)})
        log(f"[fixture] {name.upper()} training {fx[f'{name}/dims'].tolist()}, "
            f"3 Adam steps vs the JAX package's: losses "
            f"{[round(x, 6) for x in losses]}, max loss err {loss_err:.3e}, "
            f"step-1 grads max_abs_err {grad_err:.3e}, launches {counts}")


def phase_slice(torch, cuda):
    from dgsparse_tpu_torch.entry import CONFIGS, build_model, synthetic_graph
    from dgsparse_tpu_torch.kernels import launch_counts, reset_launch_counts

    runs, graphs = {}, {}
    for config in ("cora", "arxiv"):
        t0 = time.perf_counter()
        adj, x, y = synthetic_graph(config, seed=0, device=cuda)
        model = build_model(config, seed=0, device=cuda)
        with torch.inference_mode(), plain_kernels():
            ref = model(x, adj)
        torch.cuda.synchronize()
        log(f"[slice] {config}: {adj.sparse_sizes()[0]} nodes, {adj.nnz} "
            f"nnz with self-loops, GCN {model.conv1.linear.in_features}->"
            f"{model.conv1.linear.out_features}->"
            f"{model.conv2.linear.out_features}; host graph build and "
            f"upload {time.perf_counter() - t0:.2f} s")
        runs[config] = (adj, x, model, ref)
        graphs[config] = (adj, x, y)

    reset_launch_counts()
    per_config = {}
    for config, (adj, x, model, _) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        latencies = []
        with torch.inference_mode():
            for _ in range(REQUESTS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model(x, adj)
                torch.cuda.synchronize()
                latencies.append((time.perf_counter() - t0) * 1e3)
        after = launch_counts()
        per_config[config] = (out, latencies,
                              {k: after[k] - before[k] for k in KERNEL_NAMES},
                              torch.cuda.max_memory_allocated())
    launches = launch_counts()

    for config, (out, latencies, n_launch, peak) in per_config.items():
        adj, _, model, ref = runs[config]
        cfg = CONFIGS[config]
        expected = {"csr_spmm": 2 * REQUESTS, "sddmm_csr": 0}
        if n_launch != expected:
            raise AssertionError(
                f"{config}: launches {n_launch} in {REQUESTS} forwards, "
                f"expected {expected}")
        if tuple(out.shape) != (cfg.num_nodes, cfg.num_classes):
            raise AssertionError(f"{config}: output shape {out.shape}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{config}: non-finite output")
        e = max_err(out, ref, 1e-4)
        log(f"[slice] {config}: {REQUESTS} requests, latency ms "
            f"{[round(t, 4) for t in latencies]}, launches {n_launch}, "
            f"max_memory_allocated {peak} B, vs plain SpMM "
            f"max_abs_err {e:.3e}")
    return runs, launches, graphs


@contextlib.contextmanager
def plain_kernels():
    """The kernels' plain versions in place of their launches, on the
    card: the oracle of the training phase."""
    from dgsparse_tpu_torch.kernels import sddmm_csr as S
    from dgsparse_tpu_torch.kernels import spmm_csr as K

    saved = K.csr_spmm_cuda, S.sddmm_csr_cuda
    K.csr_spmm_cuda = (lambda rowptr, col, values, dense, reduce="sum":
                       K.csr_spmm_plain(rowptr, col, values, dense, reduce))
    S.sddmm_csr_cuda = (lambda rowptr, col, d1, d2, heads=1, reduce="sum":
                        S.sddmm_csr_plain(rowptr, col, d1, d2, heads,
                                          reduce))
    try:
        yield
    finally:
        K.csr_spmm_cuda, S.sddmm_csr_cuda = saved


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _oracle(torch, model, x, adj, y):
    """Step 1 of a fresh model with the plain versions, on the card.

    One forward through the kernels, held to a plain forward at 1e-4; its
    backward taken once with the plain versions (the reference gradients)
    and once through the kernels. Both backwards share that forward, so
    ReLU / LeakyReLU masks agree: a last-bit difference in a pre-activation
    next to 0 flips its mask and moves a whole gradient row.
    """
    from torch.nn import functional as F

    with torch.no_grad(), plain_kernels():
        plain_logits = model(x, adj)
    logits = model(x, adj)
    fwd_err = max_err(logits, plain_logits, 1e-4)
    loss = F.cross_entropy(logits, y)
    with plain_kernels():
        loss.backward(retain_graph=True)
    ref = _grads(model)
    model.zero_grad(set_to_none=True)
    loss.backward()
    return float(loss), fwd_err, ref, _grads(model)


def phase_training(torch, cuda, graphs):
    import numpy as np

    from dgsparse_tpu_torch.entry import (TRAIN_CONFIGS, build_trainer,
                                          train_step)
    from dgsparse_tpu_torch.kernels import launch_counts, reset_launch_counts

    prepared = {}
    for config, tc in TRAIN_CONFIGS.items():
        data = graphs[tc.graph]
        adj, x, y = data
        model, _, _ = build_trainer(config, seed=0, device=cuda, data=data)
        oracle = _oracle(torch, model, x, adj, y)
        model, opt, _ = build_trainer(config, seed=0, device=cuda, data=data)
        prepared[config] = (model, opt, data, oracle)
    torch.cuda.synchronize()

    reset_launch_counts()
    runs = {}
    for config, (model, opt, (adj, x, y), _) in prepared.items():
        torch.cuda.reset_peak_memory_stats()
        losses, latencies, per_step = [], [], []
        for _ in range(STEPS):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = train_step(model, opt, x, adj, y)
            torch.cuda.synchronize()
            latencies.append((time.perf_counter() - t0) * 1e3)
            after = launch_counts()
            per_step.append({k: after[k] - before[k]
                             for k in KERNEL_NAMES})
            losses.append(float(loss))
        runs[config] = (losses, latencies, per_step,
                        torch.cuda.max_memory_allocated())
    launches = launch_counts()

    step_ms = {}
    for config, (losses, latencies, per_step, peak) in runs.items():
        tc = TRAIN_CONFIGS[config]
        expected = STEP_LAUNCHES[tc.model]
        if any(p != expected for p in per_step):
            raise AssertionError(
                f"{config}: launches per step {per_step}, expected "
                f"{expected}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError(f"{config}: losses {losses}")
        oracle_loss, fwd_err, ref, got = prepared[config][3]
        if abs(oracle_loss - losses[0]) > 1e-5 * max(1.0, abs(losses[0])):
            raise AssertionError(
                f"{config}: step-1 loss {losses[0]} != {oracle_loss}")
        grad_err = 0.0
        for name, g in ref.items():
            atol = 1e-5 * g.abs().max().item()
            torch.testing.assert_close(got[name], g, rtol=1e-4, atol=atol,
                                       msg=lambda m: f"{config} {name}: {m}")
            grad_err = max(grad_err, (got[name] - g).abs().max().item())
        adj = graphs[tc.graph][0]
        log(f"[training] {config}: {adj.sparse_sizes()[0]} nodes, {adj.nnz} "
            f"nnz, {STEPS} Adam steps, losses "
            f"{[round(v, 6) for v in losses]}, step latency ms "
            f"{[round(t, 4) for t in latencies]}, launches per step "
            f"{per_step[0]}, max_memory_allocated {peak} B; step 1 vs the "
            f"plain versions: logits max_abs_err {fwd_err:.3e}, gradients "
            f"max_abs_err {grad_err:.3e}")
        step_ms[config] = latencies
    return launches, step_ms


def phase_profile(torch, cuda, graphs, steps=3):
    """Device time per training step by kernel name (torch.profiler), and
    the busy share: device time over host wall time of the steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dgsparse_tpu_torch.entry import (TRAIN_CONFIGS, build_trainer,
                                          train_step)

    from dgsparse_tpu_torch.utils.bench import cuda_time

    # the per-edge gather of a narrow [N, 4] fp32 table (edge softmax, GAT
    # logits): contiguous rows against the column-major copy gather_rows
    # takes
    st = graphs["arxiv"][0].storage
    table = torch.randn(st.num_rows, 4, device=cuda)
    column_major = table.t().contiguous().t()
    for label, t in (("contiguous", table), ("column-major", column_major)):
        us = cuda_time(torch.index_select, t, 0, st.coo_row()) * 1e6
        log(f"[profile] index_select of [{st.num_rows}, 4] fp32 rows by "
            f"{st.nnz} edges, {label}: {us:.1f} us")

    for config in ("gcn-arxiv", "gat-arxiv"):
        data = graphs[TRAIN_CONFIGS[config].graph]
        model, opt, (adj, x, y) = build_trainer(config, seed=0, device=cuda,
                                                data=data)
        for _ in range(2):
            train_step(model, opt, x, adj, y)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                train_step(model, opt, x, adj, y)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = []
        for ev in prof.key_averages():
            # kernels only: a CPU op's row repeats its kernels' device time
            if ev.device_type != DeviceType.CUDA:
                continue
            us = ev.self_device_time_total
            if us > 0:
                rows.append((us, ev.count, ev.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        log(f"[profile] {config}: {steps} steps, wall {wall_us / steps:.1f} "
            f"us per step under the profiler, device {busy / steps:.1f} us "
            f"per step, busy share {busy / wall_us:.3f}")
        for us, count, key in rows[:25]:
            log(f"[profile]   {us / steps:10.1f} us/step {count // steps:4d} "
                f"calls/step  {key[:110]}")


def _time_turns(fns):
    """Best of two turns of CUDA-event timings, the second turn in reverse
    order, so drift in clocks hits every version alike."""
    from dgsparse_tpu_torch.utils.bench import cuda_time

    t = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for who in order:
            fn, args = fns[who]
            t[who].append(cuda_time(fn, *args))
    return {k: min(v) * 1e3 for k, v in t.items()}


def _block_diagonal(torch, rowptr, col, values, x, n):
    """The H-head SpMM as one 2-D CSR product, for the library call: the
    structure repeated H times along the diagonal of an [H*M, H*N] CSR with
    head h's values in block h, and x [N, H*F] laid out as [H*N, F]. (On
    PyTorch 2.11 a batched CSR [H, M, N] times [H, N, F] raises on CUDA:
    "Support for batched CSR indices and values is not implemented".)"""
    heads, nnz, m = values.shape[1], col.numel(), rowptr.numel() - 1
    offsets = torch.arange(heads, device=col.device, dtype=torch.int32)
    crow = torch.cat([(rowptr[:-1] + nnz * offsets[:, None]).reshape(-1),
                      rowptr[-1:] * heads])
    cols = (col + n * offsets[:, None]).reshape(-1)
    a = torch.sparse_csr_tensor(crow, cols, values.t().reshape(-1),
                                size=(heads * m, heads * n))
    xh = x.view(n, heads, -1).transpose(0, 1).reshape(heads * n, -1)
    return a, xh


def phase_numbers(torch, cuda, runs, graphs):
    import numpy as np

    from dgsparse_tpu_torch.kernels import sddmm_csr as S
    from dgsparse_tpu_torch.kernels import spmm_csr as K
    from dgsparse_tpu_torch.utils.bench import spmm_gflops
    from dgsparse_tpu_torch.utils.testing import random_csr

    gen = torch.Generator(device=cuda).manual_seed(1)
    results = {"csr_spmm": {}, "sddmm_csr": {}}

    rp, col, vals = random_csr(P2P_NODES, P2P_NODES,
                               avg_degree=P2P_EDGES / P2P_NODES, seed=0,
                               skew=1.0)
    rowptr, col_t, vals_t = _to(cuda, rp, col, np.abs(vals))
    # SpMM cases: (label, rowptr, col, values [nnz] or [nnz, H], N, H*F)
    spmm_cases = [("p2p-synthetic F=32", rowptr, col_t, vals_t, P2P_NODES,
                   32)]
    for config, (adj, _, model, _) in runs.items():
        st = adj.storage
        for layer in ("conv1", "conv2"):
            feat = getattr(model, layer).linear.out_features
            spmm_cases.append((f"{config} {layer} F={feat}", st.rowptr(),
                               st.col(), st.values(), adj.sparse_sizes()[1],
                               feat))
    st = graphs["arxiv"][0].storage
    vals_csc = st.values()[st.csr2csc().long()]
    for layer, feat in (("conv1", 256), ("conv2", 40)):
        spmm_cases.append((f"arxiv {layer} backward d_dense (CSC) F={feat}",
                           st.colptr(), st.row(), vals_csc, st.num_rows,
                           feat))
    alpha = torch.rand(st.nnz, 4, generator=gen, device=cuda)
    spmm_cases.append(("arxiv gat1 forward H=4 F=16", st.rowptr(), st.col(),
                       alpha, st.num_cols, 64))
    spmm_cases.append(("arxiv gat2 forward H=1 F=7", st.rowptr(), st.col(),
                       alpha[:, :1].contiguous(), st.num_cols, 7))

    for label, rowptr, col_t, vals_t, n, width in spmm_cases:
        m, nnz = rowptr.numel() - 1, col_t.numel()
        heads = 1 if vals_t.dim() == 1 else vals_t.shape[1]
        x = torch.randn(n, width, generator=gen, device=cuda)
        fns = {"kernel": (K.csr_spmm_cuda, (rowptr, col_t, vals_t, x)),
               "plain": (K.csr_spmm_plain, (rowptr, col_t, vals_t, x))}
        if heads == 1:
            a = torch.sparse_csr_tensor(rowptr, col_t, vals_t.reshape(-1),
                                        size=(m, n))
            fns["library"] = (torch.matmul, (a, x))
            library_call = "torch.matmul(sparse_csr, dense) (cuSPARSE)"
        else:
            a, xh = _block_diagonal(torch, rowptr, col_t, vals_t, x, n)
            lib = torch.matmul(a, xh).view(heads, m, width // heads)
            max_err(lib.transpose(0, 1).reshape(m, width),
                    K.csr_spmm_cuda(rowptr, col_t, vals_t, x), 1e-4)
            fns["library"] = (torch.matmul, (a, xh))
            library_call = ("torch.matmul(block-diagonal sparse_csr "
                            "[H*M, H*N], dense [H*N, F]) (cuSPARSE)")
        ms = _time_turns(fns)
        nbytes = 4 * ((m + 1) + nnz + nnz * heads + n * width + m * width)
        ms["bound"], ms["bound_by"] = bound(nbytes, 2.0 * nnz * width)
        ms["library_call"] = library_call
        results["csr_spmm"][label] = ms
        log(f"[numbers] csr_spmm {label} ({m} rows, {nnz} nnz, fp32): "
            + ", ".join(f"{k} {ms[k] * 1e3:.2f} us "
                        f"{spmm_gflops(nnz, width, ms[k] / 1e3):.2f} GF/s"
                        for k in ("kernel", "plain", "library")
                        if k in ms)
            + f", bound {ms['bound'] * 1e3:.2f} us ({ms['bound_by']})")

    # SDDMM cases: d_values of the GAT layers, g [M, H*F] with h [N, H*F]
    for config in ("cora", "arxiv"):
        st = graphs[config][0].storage
        for layer, heads, feat in (("gat1", 4, 16), ("gat2", 1, 7)):
            label = f"{config} {layer} d_values H={heads} F={feat}"
            m, n, nnz = st.num_rows, st.num_cols, st.nnz
            d1 = torch.randn(m, heads * feat, generator=gen, device=cuda)
            d2 = torch.randn(n, heads * feat, generator=gen, device=cuda)
            args = (st.rowptr(), st.col(), d1, d2, heads)
            fns = {"kernel": (S.sddmm_csr_cuda, args),
                   "plain": (S.sddmm_csr_plain, args)}
            # one sampled_addmm over a CSR of ones; for H heads over H
            # copies of the structure (a batched CSR [H, M, N]) with d1 as
            # [H, M, F] and d2 as [H, F, N], views of the same inputs (a
            # batch of one is slower than the 2-D call on this build)
            if heads == 1:
                a = torch.sparse_csr_tensor(st.rowptr(), st.col(),
                                            torch.ones(nnz, device=cuda),
                                            size=(m, n))
                v1, v2 = d1, d2.T
            else:
                a = torch.sparse_csr_tensor(
                    st.rowptr().expand(heads, -1).contiguous(),
                    st.col().expand(heads, -1).contiguous(),
                    torch.ones(heads, nnz, device=cuda), size=(heads, m, n))
                v1 = d1.view(m, heads, feat).transpose(0, 1)
                v2 = d2.view(n, heads, feat).permute(1, 2, 0)
            lib = torch.sparse.sampled_addmm(a, v1, v2, beta=0.0)
            max_err(lib.values().reshape(heads, nnz).t(),
                    S.sddmm_csr_cuda(*args), 1e-4)
            fns["library"] = (
                lambda a, v1, v2: torch.sparse.sampled_addmm(
                    a, v1, v2, beta=0.0), (a, v1, v2))
            ms = _time_turns(fns)
            nbytes = 4 * ((m + 1) + nnz + (m + n) * heads * feat
                          + nnz * heads)
            ms["bound"], ms["bound_by"] = bound(nbytes,
                                                2.0 * nnz * heads * feat)
            ms["library_call"] = (
                "torch.sparse.sampled_addmm (cuSPARSE)" if heads == 1 else
                "torch.sparse.sampled_addmm over a batched CSR [H, M, N] "
                "(cuSPARSE)")
            results["sddmm_csr"][label] = ms
            log(f"[numbers] sddmm_csr {label} ({m} rows, {nnz} nnz, fp32): "
                + ", ".join(f"{k} {ms[k] * 1e3:.2f} us"
                            for k in ("kernel", "plain", "library")
                            if k in ms)
                + f", bound {ms['bound'] * 1e3:.2f} us ({ms['bound_by']})")
    return results


def _kernel_entry(name, source, replaces, launches, errs, shapes, timed,
                  card):
    t = shapes[timed]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches["training"],
        "launches_by_path": launches,
        "max_abs_err": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"],
        "ms": t["kernel"],
        "plain_ms": t["plain"],
        "bound_ms": t["bound"],
        "bound_by": t["bound_by"],
        "library_ms": t.get("library"),
        "library_call": t["library_call"],
        "timed_shape": timed,
        "shapes": shapes,
        "card": card,
    }


def run(torch, cuda) -> int:
    """Every phase on `cuda`, then the result lines; 1 on any failure."""
    try:
        t0 = time.perf_counter()
        name, card = phase_device(torch)
        phase_build()
        errs = phase_kernels(torch, cuda)
        phase_fixture(torch, cuda)
        runs, serving, graphs = phase_slice(torch, cuda)
        training, _ = phase_training(torch, cuda, graphs)
        times = phase_numbers(torch, cuda, runs, graphs)
        phase_profile(torch, cuda, graphs)
        if "jax" in sys.modules:
            raise AssertionError("JAX was imported")
        for kernel, count in (("csr_spmm", serving["csr_spmm"]),
                              ("csr_spmm", training["csr_spmm"]),
                              ("sddmm_csr", training["sddmm_csr"])):
            if count <= 0:
                raise AssertionError(f"{kernel} never launched on its path")
    except Exception:
        traceback.print_exc()
        return 1
    kernels = [
        _kernel_entry(
            "csr_spmm", "dgsparse_tpu_torch/csrc/spmm_csr.cu",
            "dgsparse_tpu/kernels/pallas_spmm.py:103",
            {"gcn_forward": serving["csr_spmm"],
             "training": training["csr_spmm"]},
            errs["csr_spmm"], times["csr_spmm"], "arxiv conv1 F=256", card),
        _kernel_entry(
            "sddmm_csr", "dgsparse_tpu_torch/csrc/sddmm_csr.cu",
            "dgsparse_tpu/kernels/pallas_sddmm.py:44",
            {"gcn_forward": serving["sddmm_csr"],
             "training": training["sddmm_csr"]},
            errs["sddmm_csr"], times["sddmm_csr"],
            "arxiv gat1 d_values H=4 F=16", card),
    ]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


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
    return run(torch, torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
