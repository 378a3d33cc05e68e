#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dgsparse_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:
  1. device: the card's name and power limit; TF32 off.
  2. build: csrc/spmm_csr.cu, csrc/sddmm_csr.cu, csrc/spmm_maxmin.cu,
     csrc/spmm_cells.cu, csrc/spmm_bell.cu and csrc/spconv.cu for sm_90a,
     one nvcc each, started together, with ptxas's resource lines.
  3. kernels vs their plain PyTorch versions on the card, on a
     p2p-Gnutella31-shaped synthetic graph and on a graph with empty rows:
     - csr_spmm and segment_sum_csr at F=32 (p2p) and F in {1, 7, 32, 40,
       41, 64, 128, 256} (empty rows), SUM and MEAN, with and without
       values;
     - sddmm_csr at H in {1, 4} heads and F per head in {1, 7, 16, 32, 64,
       128}, SUM and MEAN, on both mappings (`sddmm_path`'s group mapping
       and one warp a row; `pick_sddmm` picks one), a second call bitwise
       equal;
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
     Then spmm_maxmin and its backward, at the p2p shape (F=32) and on the
     arxiv-scale GIN graph at F=128 and F=256:
     - the forward, MAX and MIN, copy_u and the four compute ops, 1 and 4
       heads, float32 and bfloat16: values and winning edges equal to the
       plain version's exactly (both combine in float32 and keep the
       earliest winner), and on integer-valued features, where most
       elements tie, too;
     - d_dense (weights none, per edge, per head) and d_values ("dot" and
       "sum", 1 and 4 heads), both dtypes, at 1e-5 / 1e-2 scaled by the
       terms' absolute sum; d_dense (winner masks, then columns) bitwise
       equal to a second call, to the mapping `pick_d_dense` picks and to
       the one-warp-a-column kernel.
     Then the hybrid tiers' kernels, spmm_dense_cells (forward and
     transpose), spmm_bell (SUM and MEAN, into fresh zeros and added into
     a given out) and sddmm_cells, against their plain versions, fp32 and
     bf16, on a small clustered graph where every tier is non-empty and one
     row block has no dense cell (F in {1, 41, 64, 130}) and on the
     Reddit-scale storage (F = 64 and 41); spmm_bell also bitwise equal to
     a second call and, into out, to out + its standalone result, rows
     without BELL edges untouched.
     Then the spconv kernels: spconv_pairs forward (pairs by output, W)
     and dX (pairs by input, Wᵀ) and spconv_dw, against their plain
     versions on a two-batch cloud's submanifold, strided and inverse
     plans and on the "unet-60k" enc2 plan, at (c_in, c_out) in
     SPCONV_CHANNELS, fp32 and bf16 both at 1e-5 scaled by the terms'
     absolute sum (bf16 products are exact in the float32 sums both
     sides take); spconv_pairs and spconv_dw run twice equal themselves
     bitwise.
  4. fixtures: the port's GCN forward against the JAX package's frozen
     output (tests/fixtures/torch_port/gcn_small.npz) at 1e-4; its GCN and
     GAT training against the frozen JAX training run (train_small.npz),
     and its 3-layer GIN-max forward and training against gin_small.npz:
     3 Adam steps on the kernel path, losses at 1e-4, step-1 gradients at
     rtol 1e-4 and atol 1e-5 * max|g|; and a GCN on the hybrid route
     against the JAX package's PALLAS_ROW_TILE run (hybrid_small.npz): the
     forward and 2 Adam steps, with exact launches; the point-cloud UNet
     against unet_small.npz: the forward and 3 Adam steps, as the GIN.
     Then the slot-space attention on small graphs (`phase_attention`):
     gat_attention through the kernels against their plain versions and
     the frozen JAX forward and edge-space gradients
     (attention_small.npz), a GATConv on the slot route against the
     frozen JAX GATConv, the public slot chain against the edge-order
     chain, and hybrid values changed in place and by an optimizer step,
     the hybrid route against the CSR route.
  5. main path 1, serving: 5 forward requests each of the GCN at the Cora
     shape, at the arxiv scale and at the Reddit scale (232,965 nodes,
     ~114.8 M edges, 602 -> 64 -> 41, on its hybrid plan), of the 4-head
     GAT on the same Reddit-scale graph (602 -> 16 x 4 -> 41, the slot
     route), of the 3-layer GIN-max on Cora and arxiv, and of the
     point-cloud UNet on its 20,000- and 60,000-voxel clouds
     (`entry.SERVE_CONFIGS`), eval mode under inference_mode, through the
     kernels (per forward: GCN 2 csr_spmm, the Reddit GCN 2
     spmm_dense_cells, 2 spmm_bell and 2 csr_spmm for the residue, the
     Reddit GAT 5 of each (one gat_attention a head), GIN 2 spmm_maxmin,
     UNet 4 spconv_pairs, nothing else), checked
     finite and against the same model with the plain versions at 1e-4.
  6. main path 2, training: 5 Adam steps each of gcn-cora, gat-cora,
     gcn-arxiv, gat-arxiv, gin-max-cora, gin-max-arxiv, gcn-reddit,
     gat-reddit, unet and unet-60k (`entry.TRAIN_CONFIGS`) through the
     kernels, with exact launches per step (GCN: csr_spmm 4; GAT:
     csr_spmm 4, sddmm_csr 2; GIN-max: spmm_maxmin 2, its d_dense 1, its
     d_values 0; the Reddit GCN: spmm_dense_cells 4, spmm_bell 2,
     csr_spmm 4; the Reddit GAT: per head spmm_dense_cells 4, csr_spmm 4,
     spmm_bell 2, sddmm_cells 1, sddmm_csr 1; UNet: spconv_pairs
     7, spconv_dw 4), finite losses (falling over the 5 steps for GCN,
     GAT and UNet), per-step latency (host clock
     around synchronize) and max_memory_allocated. Before that run, the
     same step 1 against the plain versions on the card: logits at 1e-4,
     and the gradients of every parameter at rtol 1e-4, atol
     1e-5 * max|g|, from one shared forward (`_oracle` says why). Then
     the sddmm path: `sddmm` on the Reddit-scale storage at F = 64 (1
     sddmm_cells, 1 sddmm_csr) against the CSR-only sddmm_csr.
  7. numbers: CUDA-event times, in float32, of each kernel, its plain
     version and one PyTorch call computing the same function where there
     is one (torch.sparse CSR matmul, i.e. cuSPARSE, for the SpMM, over a
     block-diagonal CSR of H copies for H heads; torch.sparse.sampled_addmm
     over a batched CSR for the SDDMM; torch.sparse.mm(..., reduce="amax")
     for the MAX SpMM, its error recorded where CUDA refuses it, and
     beside it, labelled as two calls, x.index_select(0, col) followed by
     torch.segment_reduce(..., "max", offsets=rowptr), held to the
     kernel's out on the non-empty rows; for the MAX backward's d_dense,
     labelled as two calls, torch.zeros(n + 1, F).scatter_add_(0,
     col_ext[arg], g)[:n], held to the kernel at 1e-5 of the terms'
     absolute sum; comparators only, never called by the port; the
     multi-head and SDDMM ones held to the kernel at 1e-4),
     at the p2p shape and at the shapes
     of both main paths, beside the bound: the larger of the compulsory
     bytes (each input read once, each output written once) over
     3.35 TB/s and the operations over 67 TFLOP/s (H100 SXM data sheet,
     fp32; 495 / 3 TFLOP/s for the kernels on 3xTF32 tensor cores).
     csr_spmm at F = 256 also on the one-pass path (4, 32, 2); "kernel"
     passes the split plan the main
     path passes (the storage's, for its rows longer than SPLIT_CHUNK),
     and "unsplit" is the same launch without it where the plan splits a
     row, also on the benchmark's graph (portbench/graphs/citation.py,
     seed 0, its hub rows up to 13,096 entries), forward and CSC at F = 256
     and 40, the split held to the plain version first; spmm_maxmin also
     on feature slices of 32, 64 and 128 fp32 features and on 16 and 8
     lanes of 16 bytes a row; its d_dense and
     sddmm_csr on the mapping their picker picks ("kernel") and on each
     of their two mappings (winner masks or the group mapping, and the
     ones they had before: one warp a CSC column, one warp a row);
     sddmm_csr also on the benchmark's graph at GAT's widths there (H = 8,
     F = 8 and H = 1, F = 40), "kernel" with the storage's split plan and
     "unsplit" without, the split held first to the plain version and,
     bit for bit, to the unsplit launch; and over the Reddit-scale
     storage's non-cell edges (the hybrid sddmm's CSR launch) at F = 64
     and 41; edge_softmax's forward and backward kernels on the
     benchmark's graph at GAT's two layers (H = 8 and 1, logits made as
     GATConv makes them), held to the plain versions in float64, timed
     beside those versions and, forward and backward together, beside the
     aten chain they replaced (the plain forward under autograd); on the
     Reddit-scale storage over the
     residue's sub-CSR and the non-cell edges' CSC (the hybrid route's two
     CSR launches) at F = 64 and 41. At Reddit scale (F = 64 and 41):
     spmm_dense_cells forward and
     transpose, spmm_bell and sddmm_cells beside their plain versions and
     torch.bmm over the gathered blocks (cuSPARSE over the BELL edges for
     spmm_bell); spmm_bell standalone and added into a given out, into
     out beside torch.addmm(out, BELL CSR, x), its bound counting the
     distinct B rows its edges reference, 8 bytes a real slot, the row
     runs and the output (all of it standalone, the BELL rows read and
     written into out); the whole hybrid SpMM beside csr_spmm and
     cuSPARSE over the full CSR. segment_sum_csr at the cell
     materialisation of the Reddit-scale storage (its dense-tier values,
     F = 1) and at a p2p sorted_segment_sum (F = 32), beside its plain
     version and torch.segment_reduce(data, "sum", offsets=rowptr). On
     the 60,000-voxel cloud (bench_spconv's SubM at
     32->32 and 64->64, and the four convs of "unet-60k"): spconv_pairs
     forward and dX and spconv_dw beside their plain versions and the
     dense cuDNN call over the densified grid (conv3d, conv_transpose3d
     for the inverse conv, torch.nn.grad.conv3d_input / conv3d_weight for
     dX / dW; TF32 off), each held to the kernel at 1e-4 at the active
     sites. At Reddit scale (`phase_attention_numbers`): a GATConv on
     the slot route against the same layer forced onto the edge route,
     then gat_attention against the edge route, forward and with the
     backward, one head at F = 16 and 41, four heads against GATConv's
     edge branch, and the slot chain against the edge-order chain.
 7b. bf16 hybrid (`phase_bf16_hybrid`, the hybrid tiers' bf16 compute
     mode): on the small graph of bf16_hybrid_small.npz, `spmm` of a bf16
     x (SUM and MEAN, forward and d_dense) against the JAX package's frozen
     PALLAS_ROW_TILE run on the rows and columns its cells visit, and on
     attention_small.npz's graph gat_attention(compute_dtype=bfloat16)
     against JAX's frozen bf16 forward and against the plain versions, all
     at 1e-2 of the terms' absolute sum, with exact launches; the
     bf16-cell variant of spmm_dense_cells (the storage's bf16 twin of the
     cells times a bf16 B), forward and transpose, against its plain
     version at 1e-5 of the terms' absolute sum and bitwise against a
     second call, on a small clustered graph (F in {1, 41, 64, 130}) and
     at Reddit scale (F = 64, 41), the twin's bytes logged; the same for
     sddmm_cells' bf16 kernel (sddmm_cells_bf16_kernel) on bf16 d1 and
     d2; the slice's
     path at Reddit scale with the counts set to 0 just before it: `spmm`
     forward + d_dense at F = 64 and 41 with an fp32 and a bf16 x,
     gat_attention forward + backward one head at F = 16 and 41 in both
     modes, and `sddmm` of bf16 d1 and d2 at F = 64 and 41 (1
     sddmm_cells_bf16, 1 sddmm_csr each), exact launches by variant, bf16
     against fp32 at 1e-2; CUDA-event times of the bf16-cell kernel beside
     the fp32-mode kernel, its plain version and torch.bmm over the bf16
     blocks, and of the bf16 sddmm_cells kernel (on bf16 operands and with
     the cast from fp32) beside the fp32-mode kernel,
     its plain version and torch.bmm over the gathered bf16 blocks with
     out_dtype=float32 (the same function; bf16 out beside it) and the
     blocks' bytes zeroed (the card's rate for the store alone), beside
     their bounds (bytes, or operations at bf16's 989 TFLOP/s); and the
     path's ops in both modes with their peak memory.
 7c. gspmm hybrid (`phase_gspmm_hybrid`): on the Reddit-scale storage at
     F = 64 and 41, every SUM/MEAN op of the semiring grid (MUL, DIV, ADD,
     SUB, copy_u), which runs its weighted SpMM on the hybrid tiers
     (`ops/gspmm.py`), forward and forward + backward (d_dense, and
     d_values where there are values), each call's launches exact (the
     forward spmm_dense_cells 1, spmm_bell 1, csr_spmm 1; the backward one
     more spmm_dense_cells and csr_spmm, and sddmm_csr 1 for MUL and DIV;
     DIV's per-call tier build one segment_sum_csr), held to the CSR route
     (the same storage without its plan) at 1e-5 of the terms' absolute
     sum, MUL bitwise equal to `spmm`, and a bf16 x (MUL, F = 64) on the
     bf16-cell variant against the fp32 x at 1e-2; CUDA-event times (best
     of two turns of 3 after 1) of each op on both routes, forward and
     with the backward, cuSPARSE over the full CSR for MUL, DIV's tier
     build alone, and the forward's peak memory above resident for MUL,
     ADD and DIV at F = 64.
  8. profile: the time of the per-edge gather of an [N, 4] fp32 table,
     contiguous and column-major; torch.profiler over 3 training steps
     each of gcn-arxiv, gat-arxiv and gin-max-arxiv after 2 warm-up
     steps, and of gcn-reddit, gat-reddit and unet-60k, device time per
     step by kernel and the
     device's busy share of the wall time; gin-max-arxiv's d_dense passes
     (winner_mask_kernel, d_dense_cols_kernel), gat-arxiv's
     sddmm_group_kernel, gcn-reddit's bell_rows_kernel and
     bell_long_kernel and gat-reddit's cell and SDDMM kernels by name, and
     gcn-reddit's elementwise float adds (the tier sums among them).
  9. utilities: with `utils.metrics` on, one forward each of gcn-reddit,
     gat-reddit, gin-max-arxiv and unet-60k, its `metrics.summary()`
     printed and its routes held to the kernels that launched (the hybrid
     tiers, PALLAS_ROW_TILE, on Reddit; the max/min CSR kernel on GIN;
     the fused spconv on the UNet; gat_attention records none); with
     validation on, a card storage whose column was corrupted after
     construction raises ValueError before any launch, then a clean SpMM
     runs; `degree_stats` of the Reddit storage; RCM on a geometric graph
     of 10^5 nodes: bandwidth, host seconds, and csr_spmm at F=256 in
     both orders (equal after un-permuting at 1e-5 of the terms'
     absolute sum, CUDA-event times).
 10. native: unet-60k's four rulebooks from the native C++ builder and
     from numpy, identical plans, each builder's host seconds with the
     upload; fails if the library does not build or load.
 11. bf16 layers: an enc2-shaped SubMConv3d(64, 64,
     compute_dtype=bfloat16) forward and backward against the fp32 layer
     at 1e-2 of the largest |fp32 value|, and the bf16 spconv_pairs /
     spconv_dw against their plain versions at 1e-5 of the terms'
     absolute sum; each check refuses a planted fault (a tenth of one
     offset's pairs left out).
 12. checkpoint: gcn-arxiv, 2 Adam steps, saved and restored into a
     fresh trainer, one more step in both: parameters bitwise equal.
 13. dist: the sharded ops of `dgsparse_tpu_torch/dist/` as ranks on
     this one card (`dist.launch.run_ranks`, spawned processes; NCCL
     refuses two ranks on one device, so D > 1 runs on gloo, whose
     collectives stage CUDA tensors through pinned host memory, and D = 1
     on NCCL), fp32, TF32 off. D = 2: the arxiv GCN (128 -> 256 -> 40)
     row-sharded by rows and by edges, its forward against the
     single-process forward at 1e-5 of the terms' absolute sum and 3 SGD
     steps (loss, parameters) against D = 1 at 1e-5 of the largest
     magnitude; the 4-head GAT at gat-arxiv's widths, forward and step-1
     gradients against D = 1; `spconv_sharded` on the unet-60k cloud,
     SubM 3^3 32 -> 32 and 64 -> 64, out, dX and dW against the
     single-device `spconv` in slab order at scaled 1e-5, ppermute volume
     2 * h_max * C a rank, h_max < 0.35 own_max; the frozen JAX dist run
     (`dist_small.npz`) at 1e-4. D = 4: `spmm_sharded_2d` on a 2 x 2
     mesh at F = 256, forward and d_x, against the 1-D mesh of the same
     graph axis and one device, its per-rank gather half the 1-D one's.
     D = 1 on NCCL: `spmm_sharded` at F = 256 (forward and d_x) and the
     GCN step against the unsharded path. The ranks run the cases of
     `dist/cases.py`, the tests' rank bodies, with a hook that times each
     step; `spconv_sharded` gives every rank the global dW. Per rank, for D = 2 and D = 1: step time (host
     clock), the kernels' time (CUDA events around each launch), the
     staged collectives' host time and peak memory. Every rank checks
     that it imported no JAX; the launches of the ranks' driven runs are
     the "dist" path.
 14. tune (last: `run` points DGSPARSE_TUNE_CACHE at a temporary file
     before its first phase, so no earlier phase sees an entry and no
     user's cache is read or written):
     `tune_spmm` on the Reddit storage at F=64 and 41, forward and with
     the backward; a gcn-reddit forward under AUTO runs the winners (the
     metrics show them), each width against the other route at 1e-5
     scaled; `tune_report` on the arxiv storage; the file deleted.
Then one JSON line of per-kernel results (csr_spmm's launches by path
include the dist and tune paths; spmm_dense_cells_bf16 and
sddmm_cells_bf16, the bf16 variants, count the "bf16_hybrid" path of phase
7b; the "gspmm_hybrid" path is phase 7c's, and segment_sum_csr launches
there, in DIV's tier builds; every path counts every kernel), the card's
name and power limit, and as
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

import contextlib
import functools
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures", "torch_port")
FIXTURE = os.path.join(FIXTURES, "gcn_small.npz")
TRAIN_FIXTURE = os.path.join(FIXTURES, "train_small.npz")
GIN_FIXTURE = os.path.join(FIXTURES, "gin_small.npz")
HYBRID_FIXTURE = os.path.join(FIXTURES, "hybrid_small.npz")
UNET_FIXTURE = os.path.join(FIXTURES, "unet_small.npz")
ATTENTION_FIXTURE = os.path.join(FIXTURES, "attention_small.npz")
BF16_FIXTURE = os.path.join(FIXTURES, "bf16_hybrid_small.npz")
# bench.py:57-61 — the p2p-Gnutella31 shape; the .mtx is not in the repo
P2P_NODES, P2P_EDGES = 62586, 147892
FEATS = (1, 7, 32, 40, 41, 64, 128, 256)
SDDMM_FEATS = (1, 7, 16, 32, 64, 128)
MH_FEATS = (1, 7, 16, 64)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
REQUESTS = 5
STEPS = 5
# H100 SXM data sheet: HBM, fp32 (FFMA) and TF32 tensor-core peaks; a
# 3xTF32 product takes three TF32 products
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12
RATE_NAMES = {FP32_FLOPS: "fp32 FFMA 67 TFLOP/s",
              TF32X3_FLOPS: "3xTF32 on TF32 tensor cores 165 TFLOP/s",
              BF16_FLOPS: "bf16 tensor cores 989 TFLOP/s"}
KERNELS = ("spmm_csr", "sddmm_csr", "spmm_maxmin", "spmm_cells", "spmm_bell",
           "spconv", "edge_softmax")
# the wrappers the main paths launch, as `kernels.launch_counts` names them
KERNEL_NAMES = ("csr_spmm", "segment_sum_csr", "sddmm_csr", "spmm_maxmin",
                "spmm_maxmin_d_dense", "spmm_maxmin_d_values",
                "spmm_dense_cells", "spmm_dense_cells_bf16", "spmm_bell",
                "sddmm_cells", "sddmm_cells_bf16", "spconv_pairs",
                "spconv_dw")
_NONE = dict.fromkeys(KERNEL_NAMES, 0)
# kernel launches per training step: the forward and d_dense of both
# layers, plus d_values of both layers where the edge values are
# attention weights (a GCN's adjacency is constant); a 3-layer GIN-max
# maxes twice and differentiates only the second aggregation, over a bare
# graph without values; a GCN on a graph with a hybrid plan
# ("gcn-hybrid") runs per layer the cells, BELL and residue (CSR) tiers
# forward and the cells and non-cell CSC (CSR kernel) tiers in d_dense; the
# point-cloud UNet runs its 4 convs forward, dX of the 3 whose input is not
# data, and dW of all 4
# one slot-space gat_attention, forward and backward: the forward's tiers
# (cells, BELL, residue); d_x's transpose (cells, non-cell CSC); dsig's
# sddmm_cells and sddmm_csr; d_s_row's tiers and d_s_col's transpose
ATTENTION_LAUNCHES = {"csr_spmm": 4, "spmm_dense_cells": 4, "spmm_bell": 2,
                      "sddmm_cells": 1, "sddmm_csr": 1}
# ... in the bf16 compute mode: the forward's and d_x's cells on the
# bf16-cell variant, d_s_row's and d_s_col's on the fp32 kernel
ATTENTION_LAUNCHES_BF16 = {**ATTENTION_LAUNCHES, "spmm_dense_cells": 2,
                           "spmm_dense_cells_bf16": 2}
# one hybrid spmm forward and d_dense: cells 2, BELL 1, CSR 2 (residue,
# non-cell transpose), the cells on the bf16 variant for a bf16 operand
SPMM_LAUNCHES = {"csr_spmm": 2, "spmm_dense_cells": 2, "spmm_bell": 1}
SPMM_LAUNCHES_BF16 = {"csr_spmm": 2, "spmm_dense_cells_bf16": 2,
                      "spmm_bell": 1}
# one hybrid sddmm of bf16 d1 and d2: the cells' blocks on the bf16
# variant, the non-cell edges on the CSR SDDMM
SDDMM_LAUNCHES_BF16 = {"sddmm_cells_bf16": 1, "sddmm_csr": 1}
# a GAT on a hybrid storage of 2^21 or more edges ("gat-hybrid") runs one
# gat_attention a head: 4 in its first layer, 1 in its second
GAT_HEADS = 5
STEP_LAUNCHES = {"gcn": {**_NONE, "csr_spmm": 4},
                 "gat": {**_NONE, "csr_spmm": 4, "sddmm_csr": 2},
                 "gat-hybrid": {**_NONE, **{k: GAT_HEADS * v for k, v in
                                            ATTENTION_LAUNCHES.items()}},
                 "gin": {**_NONE, "spmm_maxmin": 2,
                         "spmm_maxmin_d_dense": 1},
                 "gcn-hybrid": {**_NONE, "spmm_dense_cells": 4,
                                "spmm_bell": 2, "csr_spmm": 4},
                 "unet": {**_NONE, "spconv_pairs": 7, "spconv_dw": 4}}
# ... and per served forward
FORWARD_LAUNCHES = {"gcn": {**_NONE, "csr_spmm": 2},
                    "gin": {**_NONE, "spmm_maxmin": 2},
                    "gcn-hybrid": {**_NONE, "spmm_dense_cells": 2,
                                   "spmm_bell": 2, "csr_spmm": 2},
                    "gat-hybrid": {**_NONE, "spmm_dense_cells": GAT_HEADS,
                                   "spmm_bell": GAT_HEADS,
                                   "csr_spmm": GAT_HEADS},
                    "unet": {**_NONE, "spconv_pairs": 4}}
# the hybrid kernels' widths: every tier of a small clustered graph, and the
# Reddit-scale GCN's two layers
HYBRID_FEATS = (1, 41, 64, 130)
REDDIT_FEATS = (64, 41)
# gat_attention's widths a head at Reddit scale (gat-reddit's 16 and 41)
ATTENTION_FEATS = (16, 41)
# the semiring grid's SUM/MEAN computes ("copy_u": a storage without values)
GSPMM_COMPUTES = ("mul", "div", "add", "sub", "copy_u")
# one SUM/MEAN gspmm on a hybrid storage: the forward's three tiers; its
# backward's d_dense transpose (cells, non-cell CSC), and d_values' SDDMM
# over every edge for MUL and DIV (ADD/SUB's is autograd of a row sum)
GSPMM_FORWARD = {"spmm_dense_cells": 1, "spmm_bell": 1, "csr_spmm": 1}
GSPMM_BACKWARD = {"spmm_dense_cells": 1, "csr_spmm": 1}
# the max/min kernel phase: the compute ops (None: copy_u) and widths
MAXMIN_COMPUTES = (None, "add", "sub", "mul", "div")
MAXMIN_FEATS = {"p2p": (32,), "arxiv": (128, 256)}
# kernels phase 8 reports by name: d_dense's two passes, the group SDDMM,
# the BELL kernels of short and long rows
PROFILED_PASSES = {"gin-max-arxiv": ("winner_mask_kernel",
                                     "d_dense_cols_kernel"),
                   "gat-arxiv": ("sddmm_group_kernel",),
                   "gcn-reddit": ("bell_rows_kernel", "bell_long_kernel"),
                   "gat-reddit": ("dense_cells_kernel", "sddmm_cells_kernel",
                                  "sddmm_group_kernel")}
# the spconv kernels' (c_in, c_out): the UNet's convs and a ragged pair
SPCONV_CHANNELS = ((8, 32), (32, 64), (64, 64), (7, 33))
# the point clouds of the UNet configurations
CLOUDS = ("unet", "unet-60k")


def log(*args):
    print(*args, flush=True)


def max_err(out, ref, tol):
    """Max |out - ref|; raises unless out matches ref at rtol = atol = tol."""
    import torch

    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    return (out.float() - ref.float()).abs().max().item() if out.numel() \
        else 0.0


def bound(nbytes, flops, rate=FP32_FLOPS):
    """The least time the card could take: {"bound": ms, "bound_by":
    "bytes" or "operations", "bound_rate": the operation rate's name}, the
    operations counted at `rate` (FP32_FLOPS for a kernel on FFMA,
    TF32X3_FLOPS for one on 3xTF32 tensor cores)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return {"bound": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": RATE_NAMES[rate]}


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
                    # both mappings, whichever pick_sddmm picks
                    for path, reduce in itertools.product(
                            (S.sddmm_path(feat, heads, d1.element_size()),
                             S.WARP_PER_ROW), ("sum", "mean")):
                        out = S.sddmm_csr_cuda(rowptr, col, d1, d2, heads,
                                               reduce, path)
                        if not torch.equal(out, S.sddmm_csr_cuda(
                                rowptr, col, d1, d2, heads, reduce, path)):
                            raise AssertionError(
                                f"sddmm_csr {tag} H={heads} F={feat} "
                                f"{reduce} {dtype} path {path}: a second "
                                f"call differs")
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
                    f"sum/mean fp32/bf16, group path "
                    f"{S.sddmm_path(feat, heads, 4)} and warp_per_row "
                    f"(picked {S.pick_sddmm(feat, heads, 4)}): max_abs_err "
                    f"{max(worst):.3e}; a second call bitwise equal")

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


def phase_maxmin_kernels(torch, cuda, gin_graphs):
    """spmm_maxmin and both backward entry points against their plain
    versions, at the p2p shape and on the arxiv-scale GIN graph."""
    import numpy as np

    from dgsparse_tpu_torch import SparseTensor
    from dgsparse_tpu_torch.kernels import spmm_maxmin as M
    from dgsparse_tpu_torch.utils.testing import assert_sum_close, random_csr

    errs = {k: {"float32": 0.0, "bfloat16": 0.0}
            for k in ("spmm_maxmin", "spmm_maxmin_bwd")}
    gen = torch.Generator(device=cuda).manual_seed(2)

    def edge_values(nnz, heads, integer=False):
        # |v| in [0.5, 2], away from 0: DIV and its gradient divide by them
        sign = torch.randint(0, 2, (nnz, heads), generator=gen,
                             device=cuda) * 2 - 1
        if integer:
            return sign.float()
        mag = torch.rand(nnz, heads, generator=gen, device=cuda) * 1.5 + 0.5
        return mag * sign

    def forward_case(tag, st, x, values, reduce, compute):
        out, arg = M.spmm_maxmin_cuda(st.rowptr(), st.col(), values, x,
                                      reduce, compute or "mul")
        ref, ref_arg = M.spmm_maxmin_plain(st.rowptr(), st.col(), values, x,
                                           reduce, compute or "mul",
                                           coo_row=st.coo_row())
        torch.cuda.synchronize()
        wrong = int((arg != ref_arg).sum())
        if wrong or not torch.equal(out, ref):
            raise AssertionError(
                f"spmm_maxmin {tag} {reduce} {compute}: {wrong} winners "
                f"differ, max |out - ref| "
                f"{(out.float() - ref.float()).abs().max().item():.3e}")
        return out, arg

    graphs = {}
    rp, col, _ = random_csr(P2P_NODES, P2P_NODES,
                            avg_degree=P2P_EDGES / P2P_NODES, seed=0,
                            skew=1.0)
    graphs["p2p"] = SparseTensor.from_csr(
        rp, col, sparse_sizes=(P2P_NODES, P2P_NODES), device=cuda).storage
    graphs["arxiv"] = gin_graphs["arxiv"][0].storage
    for tag, st in graphs.items():
        m, n, nnz = st.num_rows, st.num_cols, st.nnz
        log(f"[maxmin] {tag}: {m} rows, {nnz} edges, "
            f"{int((st.rowptr()[1:] == st.rowptr()[:-1]).sum())} empty rows")
        for feat in MAXMIN_FEATS[tag]:
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                for compute in MAXMIN_COMPUTES:
                    for heads in ((1,) if compute is None else (1, 4)):
                        x = torch.randn(n, feat, generator=gen,
                                        device=cuda).to(dt)
                        v = (None if compute is None
                             else edge_values(nnz, heads))
                        for reduce in ("max", "min"):
                            forward_case(f"{tag} F={feat} H={heads} {dtype}",
                                         st, x, v, reduce, compute)
                log(f"[maxmin] spmm_maxmin {tag} F={feat} {dtype}: MAX/MIN "
                    f"x copy_u/add/sub/mul/div x H=1,4: values and winners "
                    f"equal to the plain version's")
            # integer-valued features: exact ties, the earliest edge wins
            for compute in (None, "mul"):
                x = torch.randint(-2, 3, (n, feat), generator=gen,
                                  device=cuda).float()
                v = None if compute is None else edge_values(nnz, 1, True)
                for reduce in ("max", "min"):
                    forward_case(f"{tag} F={feat} integer", st, x, v,
                                 reduce, compute)
            log(f"[maxmin] spmm_maxmin {tag} F={feat} integer-valued "
                f"(ties): winners equal to the plain version's")

            # the backward entry points, on the winners of a MAX forward
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                worst = []
                for heads, weighted in ((1, False), (1, True), (4, True)):
                    x = torch.randn(n, feat, generator=gen,
                                    device=cuda).to(dt)
                    v = edge_values(nnz, heads) if weighted else None
                    _, arg = M.spmm_maxmin_cuda(st.rowptr(), st.col(), v, x)
                    g = torch.randn(m, feat, generator=gen,
                                    device=cuda).to(dt)
                    w = (None if v is None
                         else v[st.csr2csc().long()].contiguous())
                    args = (st.colptr(), st.row(), st.csr2csc())
                    rows = (st.rowptr(), st.csc_slot())
                    out = M.spmm_maxmin_d_dense_cuda(
                        *args, w, arg, g, *rows,
                        path=M.d_dense_path(feat, heads, g.element_size()))
                    # bitwise: a second call, the picked mapping and the
                    # one-warp-a-column kernel (all add each element's
                    # terms in CSC order)
                    for path in (M.d_dense_path(feat, heads,
                                                g.element_size()),
                                 None, M.WARP_PER_COLUMN):
                        again = M.spmm_maxmin_d_dense_cuda(
                            *args, w, arg, g, *rows, path=path)
                        if not torch.equal(out, again):
                            raise AssertionError(
                                f"spmm_maxmin_d_dense {tag} F={feat} "
                                f"H={heads} {dtype}: the winner masks not "
                                f"bitwise equal to the mapping {path}")
                    ref = M.spmm_maxmin_d_dense_plain(
                        *args, w, arg, g, csc_col=st.csc_col())
                    abs_sum = M.spmm_maxmin_d_dense_plain(
                        *args, None if w is None else w.abs(), arg,
                        g.float().abs(), csc_col=st.csc_col())
                    torch.cuda.synchronize()
                    worst.append(assert_sum_close(out, ref, abs_sum,
                                                  TOL[dtype]))
                    for dense in (x, None):
                        dv = M.spmm_maxmin_d_values_cuda(
                            st.rowptr(), st.col(), arg, g, dense, heads)
                        ref = M.spmm_maxmin_d_values_plain(
                            st.rowptr(), st.col(), arg, g, dense, heads,
                            coo_row=st.coo_row())
                        abs_sum = M.spmm_maxmin_d_values_plain(
                            st.rowptr(), st.col(), arg, g.float().abs(),
                            None if dense is None else dense.float().abs(),
                            heads, coo_row=st.coo_row())
                        torch.cuda.synchronize()
                        worst.append(assert_sum_close(dv, ref, abs_sum,
                                                      TOL[dtype]))
                errs["spmm_maxmin_bwd"][dtype] = max(
                    errs["spmm_maxmin_bwd"][dtype], max(worst))
                picked = M.pick_d_dense(feat, 1, 4, 16, nnz, m)
                log(f"[maxmin] spmm_maxmin_d_dense (weights none, per edge, "
                    f"4 heads; winner masks on path "
                    f"{M.d_dense_path(feat, 1, 4)}, bitwise equal to a "
                    f"second call and to the one-warp-a-column kernel; "
                    f"picked {picked}) and spmm_maxmin_d_values (dot, sum) "
                    f"{tag} F={feat} {dtype}: max_abs_err {max(worst):.3e}")
    return errs


def _device_bytes(obj, seen=None) -> int:
    """Bytes of the distinct device tensors reachable from a storage, plan
    or dict (shared tensors counted once)."""
    import dataclasses

    import torch

    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = obj.untyped_storage().data_ptr()
        if key in seen:
            return 0
        seen.add(key)
        return obj.untyped_storage().nbytes()
    if isinstance(obj, dict):
        return sum(_device_bytes(v, seen) for v in obj.values())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_device_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    if hasattr(obj, "__dict__") and type(obj).__name__ == "Storage":
        return _device_bytes(vars(obj), seen)
    return 0


def _hybrid_stats(st):
    """One line on a storage's hybrid tiers."""
    hp = st.ell_plan()
    c, b = hp.cells, hp.bell
    return (f"{hp.nnz} edges: {0 if c is None else c.num_cells} dense cells "
            f"holding {0 if c is None else c.nnz} edges "
            f"({0 if c is None else 4 * c.cell_slots} B of fp32 blocks), "
            f"BELL {0 if b is None else b.nnz} edges in "
            f"{0 if b is None else b.num_tiles} tiles of "
            f"{0 if b is None else b.edge_tile}, residue {hp.res.nnz} edges; "
            f"dense fraction {hp.dense_fraction:.4f}")


def phase_hybrid_kernels(torch, cuda, reddit):
    """spmm_dense_cells (forward and transpose), spmm_bell and sddmm_cells
    against their plain versions: on a small clustered graph where every
    tier is non-empty and one row block has no dense cell, at F in
    HYBRID_FEATS, and on the Reddit-scale storage at F = 64 and 41; float32
    at 1e-5 and bfloat16 at 1e-2, scaled by the terms' absolute sum.
    spmm_bell in both modes (fresh, and added into a given out)."""
    import numpy as np

    from dgsparse_tpu_torch import SparseTensor
    from dgsparse_tpu_torch.core.planner import build_bell_plan
    from dgsparse_tpu_torch.kernels import spmm_bell as B
    from dgsparse_tpu_torch.kernels import spmm_cells as C
    from dgsparse_tpu_torch.utils.testing import (assert_sum_close, block_csr,
                                                  hybrid_csr)

    errs = {k: {"float32": 0.0, "bfloat16": 0.0}
            for k in ("spmm_dense_cells", "spmm_bell", "sddmm_cells")}
    gen = torch.Generator(device=cuda).manual_seed(3)

    def randn(*shape, dtype="float32"):
        return torch.randn(*shape, generator=gen, device=cuda).to(
            getattr(torch, dtype))

    def check(kernel, dtype, out, ref, abs_sum):
        torch.cuda.synchronize()
        e = assert_sum_close(out, ref, abs_sum, TOL[dtype])
        errs[kernel][dtype] = max(errs[kernel][dtype], e)
        return e

    def bell_case(plan, vals, x, reduce, deg, dtype):
        # both modes: into fresh zeros, and added into a given out (the
        # hybrid SpMM's); each against the plain version, bitwise against
        # a second call; in place, bitwise out + the standalone result, rows
        # without BELL edges untouched
        args = (plan, vals, x, reduce, deg)
        out = B.spmm_bell_cuda(*args)
        abs_sum = B.spmm_bell_plain(plan, vals.abs(), x.float().abs(),
                                    reduce, deg)
        e = check("spmm_bell", dtype, out, B.spmm_bell_plain(*args), abs_sum)
        o = randn(plan.num_rows, x.shape[1])
        into = [o.clone() for _ in range(2)]
        B.spmm_bell_cuda(*args, out=into[0])
        B.spmm_bell_cuda(*args, out=into[1])
        e = max(e, check("spmm_bell", dtype, into[0],
                         B.spmm_bell_plain(*args, out=o.clone()), abs_sum))
        off = torch.ones(plan.num_rows, dtype=torch.bool, device=cuda)
        off[plan.rows.long()] = False
        for what, a, b in (
                ("a second call", out, B.spmm_bell_cuda(*args)),
                ("a second call, into out", into[0], into[1]),
                ("out + standalone", into[0], o + out),
                ("out off the BELL rows", into[0][off], o[off])):
            if not torch.equal(a, b):
                raise AssertionError(f"spmm_bell {reduce} {dtype} F="
                                     f"{x.shape[1]}: not bitwise equal to "
                                     f"{what}")
        return e

    def cases(tag, st, feats):
        hp, tiers = st.ell_plan(), st.tier_values()
        plan, cells = hp.cells, tiers["cells"]
        deg = st.rowptr()[1:] - st.rowptr()[:-1]
        for feat in feats:
            worst = {k: [] for k in errs}
            for dtype in ("float32", "bfloat16"):
                for transpose in (False, True):
                    n_in = plan.num_rows if transpose else plan.num_cols
                    x = randn(n_in, feat, dtype=dtype)
                    out = C.spmm_dense_cells_cuda(plan, cells, x, transpose)
                    ref = C.spmm_dense_cells_plain(plan, cells, x, transpose)
                    abs_sum = C.spmm_dense_cells_plain(
                        plan, cells.abs(), x.float().abs(), transpose)
                    worst["spmm_dense_cells"].append(check(
                        "spmm_dense_cells", dtype, out, ref, abs_sum))
                x = randn(hp.num_cols, feat, dtype=dtype)
                for reduce in ("sum", "mean"):
                    worst["spmm_bell"].append(bell_case(
                        hp.bell, tiers["bell"], x, reduce, deg, dtype))
                d1 = randn(hp.num_rows, feat, dtype=dtype)
                d2 = randn(hp.num_cols, feat, dtype=dtype)
                out = C.sddmm_cells_cuda(plan, d1, d2)
                ref = C.sddmm_cells_plain(plan, d1, d2)
                abs_sum = C.sddmm_cells_plain(plan, d1.float().abs(),
                                              d2.float().abs())
                worst["sddmm_cells"].append(check("sddmm_cells", dtype, out,
                                                  ref, abs_sum))
            log(f"[hybrid] {tag} F={feat} fp32/bf16: spmm_dense_cells "
                f"forward and transpose max_abs_err "
                f"{max(worst['spmm_dense_cells']):.3e}, spmm_bell sum/mean, "
                f"fresh and into out {max(worst['spmm_bell']):.3e} (bitwise "
                f"equal to a second call and to out + the standalone "
                f"result), sddmm_cells "
                f"{max(worst['sddmm_cells']):.3e}")

    rowptr, col, vals = hybrid_csr()
    n = len(rowptr) - 1
    small = SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                                  sparse_sizes=(n, n), device=cuda).storage
    hp = small.ell_plan()
    no_cell = set(range(-(-n // 128))) - set(hp.cells.cell_rb.tolist())
    if not no_cell or hp.bell is None or hp.res.nnz == 0:
        raise AssertionError("the small graph must fill every tier and "
                             "leave a row block without a dense cell")
    log(f"[hybrid] small clustered graph, {n} nodes, "
        f"{_hybrid_stats(small)}; row blocks without a cell "
        f"{sorted(no_cell)}")
    cases("small", small, HYBRID_FEATS)
    # a BELL plan with long rows (a warp each), runs spanning tiles
    rowptr, col, vals, n = block_csr(heavy=True)
    heavy = build_bell_plan(rowptr, col, n, device=cuda)
    ep = heavy.eperm
    slot_vals = torch.from_numpy(
        np.where(ep >= 0, vals[np.maximum(ep, 0)], 0).astype(np.float32)
    ).to(cuda)
    deg = torch.from_numpy(np.diff(rowptr)).to(cuda)
    worst = []
    for feat in HYBRID_FEATS:
        for dtype in ("float32", "bfloat16"):
            x = randn(n, feat, dtype=dtype)
            for reduce in ("sum", "mean"):
                worst.append(bell_case(heavy, slot_vals, x, reduce, deg,
                                       dtype))
    log(f"[hybrid] spmm_bell on a BELL plan with {heavy.num_long_rows} long "
        f"rows of {heavy.num_bell_rows}, F in {HYBRID_FEATS}, fp32/bf16, "
        f"sum/mean, fresh and into out: max_abs_err {max(worst):.3e}, "
        f"bitwise as above")
    st = reddit.storage
    log(f"[hybrid] reddit: {st.num_rows} nodes, {_hybrid_stats(st)}; the "
        f"storage holds {_device_bytes(st)} B on the card, of which the "
        f"hybrid plan {_device_bytes(st.ell_plan())} B and its cached tier "
        f"values {_device_bytes(st.tier_values())} B")
    cases("reddit", st, REDDIT_FEATS)
    if np.isnan(max(max(v.values()) for v in errs.values())):
        raise AssertionError("NaN error")
    return errs


def phase_spconv_kernels(torch, cuda, enc2_plan):
    """spconv_pairs forward (pairs by output, W) and dX (pairs by input,
    Wᵀ) and spconv_dw against their plain versions: on a two-batch cloud's
    submanifold, strided and inverse plans and on the "unet-60k" enc2 plan,
    at (c_in, c_out) in SPCONV_CHANNELS; float32 and bfloat16 both at 1e-5
    scaled by the terms' absolute sum (each side sums the products in
    float32, and a product of two bf16 values is exact there). Each kernel
    run twice equals itself bitwise (no atomics)."""
    from dgsparse_tpu_torch.kernels import spconv as K
    from dgsparse_tpu_torch.ops.spconv import build_rulebook, inverse_plan
    from dgsparse_tpu_torch.utils.testing import (assert_sum_close,
                                                  random_cloud)

    errs = {k: {"float32": 0.0, "bfloat16": 0.0}
            for k in ("spconv_pairs", "spconv_dw")}
    gen = torch.Generator(device=cuda).manual_seed(6)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=cuda).to(
            getattr(torch, dtype))

    def check(kernel, dtype, fn, plain, *args):
        out, again = fn(*args), fn(*args)
        ref = plain(*args)
        abs_sum = plain(args[0], *(a.float().abs() for a in args[1:]))
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"{kernel}: two runs on the same inputs "
                                 f"differ")
        e = assert_sum_close(out, ref, abs_sum, TOL["float32"])
        errs[kernel][dtype] = max(errs[kernel][dtype], e)
        return e

    shape = (16, 14, 12)
    coords = random_cloud(1500, shape, 2, seed=11)
    subm, _ = build_rulebook(coords, 3, 1, 1, spatial_shape=shape,
                             device=cuda)
    strided, _ = build_rulebook(coords, 3, 2, 1, spatial_shape=shape,
                                device=cuda)
    plans = {"two-batch subm": subm, "two-batch strided": strided,
             "two-batch inverse": inverse_plan(strided),
             "unet-60k enc2": enc2_plan}
    for tag, plan in plans.items():
        for c_in, c_out in SPCONV_CHANNELS:
            worst = {k: [] for k in errs}
            for dtype in ("float32", "bfloat16"):
                x = randn(plan.num_in, c_in, dtype=dtype)
                g = randn(plan.num_out, c_out, dtype=dtype)
                w = randn(plan.k_vol, c_in, c_out, dtype=dtype)
                wt = w.transpose(1, 2).contiguous()
                for pairs, src, wk in ((plan.by_out, x, w),
                                       (plan.by_in, g, wt)):
                    worst["spconv_pairs"].append(check(
                        "spconv_pairs", dtype, K.spconv_pairs_cuda,
                        K.spconv_pairs_plain, pairs, src, wk))
                worst["spconv_dw"].append(check(
                    "spconv_dw", dtype, K.spconv_dw_cuda, K.spconv_dw_plain,
                    plan.by_offset, x, g))
            log(f"[spconv] {tag} ({plan.num_in} -> {plan.num_out} sites, "
                f"{plan.total_pairs} pairs) c_in={c_in} c_out={c_out} "
                f"fp32/bf16: spconv_pairs forward and dX max_abs_err "
                f"{max(worst['spconv_pairs']):.3e}, spconv_dw "
                f"{max(worst['spconv_dw']):.3e}; both bitwise repeatable")
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
                                                  fixture_model,
                                                  run_gin_fixture,
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

    with np.load(GIN_FIXTURE) as f:
        fx = dict(f)
    reset_launch_counts()
    out, losses, grads = run_gin_fixture(fx, cuda, steps=3)
    counts = {k: launch_counts()[k] for k in KERNEL_NAMES}
    # the eval forward, then 3 steps
    expected = {k: 3 * v for k, v in STEP_LAUNCHES["gin"].items()}
    expected["spmm_maxmin"] += FORWARD_LAUNCHES["gin"]["spmm_maxmin"]
    if counts != expected:
        raise AssertionError(f"GIN fixture: launches {counts}, expected "
                             f"{expected}")
    e = max_err(torch.from_numpy(out), torch.from_numpy(fx["gin/out"]), 1e-4)
    prefix = "gin/grads/"
    loss_err, grad_err = assert_train_close(
        losses, grads, fx["gin/losses"],
        {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)})
    log(f"[fixture] GIN-max {fx['gin/dims'].tolist()} (in, hidden, out, "
        f"layers) vs the JAX package's: forward max_abs_err {e:.3e}; 3 Adam "
        f"steps, losses {[round(x, 6) for x in losses]}, max loss err "
        f"{loss_err:.3e}, step-1 grads max_abs_err {grad_err:.3e}, "
        f"launches {counts}")

    # the GCN on the hybrid route (JAX's PALLAS_ROW_TILE)
    with np.load(HYBRID_FIXTURE) as f:
        fx = dict(f)
    model, adj, x, _ = fixture_model(fx, "gcn", cuda)
    if adj.storage.ell_plan() is None:
        raise AssertionError("the hybrid fixture's graph has no hybrid plan")
    reset_launch_counts()
    with torch.inference_mode():
        out = model(x, adj)
    counts = _counts()
    if counts != FORWARD_LAUNCHES["gcn-hybrid"]:
        raise AssertionError(f"hybrid fixture forward: launches {counts}")
    e = max_err(out, torch.from_numpy(fx["gcn/out"]).to(cuda), 1e-4)
    reset_launch_counts()
    losses, grads = run_train_fixture(fx, "gcn", cuda, steps=2)
    counts = _counts()
    expected = {k: 2 * v for k, v in STEP_LAUNCHES["gcn-hybrid"].items()}
    if counts != expected:
        raise AssertionError(f"hybrid fixture: launches {counts} in 2 "
                             f"steps, expected {expected}")
    prefix = "gcn/grads/"
    loss_err, grad_err = assert_train_close(
        losses, grads, fx["gcn/losses"],
        {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)})
    log(f"[fixture] hybrid GCN {fx['gcn/dims'].tolist()} on "
        f"{_hybrid_stats(adj.storage)} vs the JAX package's "
        f"PALLAS_ROW_TILE run: forward max_abs_err {e:.3e}; 2 Adam steps, "
        f"losses {[round(v, 6) for v in losses]}, max loss err "
        f"{loss_err:.3e}, step-1 grads max_abs_err {grad_err:.3e}, "
        f"launches per step "
        f"{ {k: v // 2 for k, v in counts.items() if v} }")

    # the point-cloud UNet: its eval forward, then 3 Adam steps
    with np.load(UNET_FIXTURE) as f:
        fx = dict(f)
    reset_launch_counts()
    out, losses, grads = run_gin_fixture(fx, cuda, steps=3, name="unet")
    counts = _counts()
    expected = {k: 3 * v for k, v in STEP_LAUNCHES["unet"].items()}
    expected["spconv_pairs"] += FORWARD_LAUNCHES["unet"]["spconv_pairs"]
    if counts != expected:
        raise AssertionError(f"UNet fixture: launches {counts}, expected "
                             f"{expected}")
    e = max_err(torch.from_numpy(out), torch.from_numpy(fx["unet/out"]),
                1e-4)
    prefix = "unet/grads/"
    loss_err, grad_err = assert_train_close(
        losses, grads, fx["unet/losses"],
        {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)})
    log(f"[fixture] point-cloud UNet on {len(fx['coords'])} voxels in "
        f"{fx['shape'].tolist()} vs the JAX package's: forward max_abs_err "
        f"{e:.3e}; 3 Adam steps at lr {float(fx['unet/lr'])}, losses "
        f"{[round(x, 6) for x in losses]}, max loss err {loss_err:.3e}, "
        f"step-1 grads max_abs_err {grad_err:.3e}, launches "
        f"{ {k: v for k, v in counts.items() if v} }")


def _slot_chain(torch, sp, d1, d2, x):
    """sddmm_slots -> LeakyReLU -> edge_softmax_slots -> spmm_slots."""
    import dgsparse_tpu_torch as pt
    from torch.nn import functional as F

    sv = pt.sddmm_slots(sp, d1, d2).map(lambda t: F.leaky_relu(t, 0.2))
    return pt.spmm_slots(sp, pt.edge_softmax_slots(sp, sv), x)


def _edge_chain(torch, sp, d1, d2, x):
    """The same chain in CSR edge order: sddmm, edge_softmax, spmm."""
    import dgsparse_tpu_torch as pt
    from torch.nn import functional as F

    z = F.leaky_relu(pt.sddmm(sp, d1, d2), 0.2)
    return pt.spmm(sp.set_values(pt.edge_softmax(sp, z)), x)


def _grad_close(torch, got, ref, rtol, scale):
    """Max |got - ref| over tensors; raises unless each is within rtol and
    an atol of `scale` times its reference's largest value."""
    err = 0.0
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=rtol,
                                   atol=scale * b.abs().max().item())
        err = max(err, (a - b).abs().max().item())
    return err


def phase_attention(torch, cuda):
    """The slot-space attention on small graphs (attention_small.npz's,
    `utils.testing.hybrid_csr` with duplicate edges and empty rows):
    gat_attention through the kernels against the same call on their plain
    versions (forward at 1e-4; gradients of s_row, s_col and x at rtol
    1e-4, atol 1e-5 of each one's largest value) with the launches of one
    call, and against the JAX package's frozen forward (2e-4) and
    edge-space gradients (2e-3); a GATConv forced onto the slot route
    against the frozen JAX GATConv (1e-4); the public slot chain against
    the edge-order chain (forward 1e-4, gradients 2e-3); and hybrid values
    changed in place and by an optimizer step, the hybrid route against
    the CSR route within assert_sum_close's 1e-5."""
    import numpy as np

    import dgsparse_tpu_torch as pt
    from dgsparse_tpu_torch.kernels import reset_launch_counts
    from dgsparse_tpu_torch.nn import gat as G
    from dgsparse_tpu_torch.utils.testing import (assert_sum_close,
                                                  fixture_gatconv, hybrid_csr)

    with np.load(ATTENTION_FIXTURE) as f:
        fx = dict(f)
    n = fx["x"].shape[0]
    sp = pt.SparseTensor.from_csr(fx["rowptr"], fx["col"], None,
                                  sparse_sizes=(n, n), device=cuda)
    if sp.storage.ell_plan() is None:
        raise AssertionError("the attention fixture's graph has no hybrid "
                             "plan")
    inputs = [torch.from_numpy(fx[k]).to(cuda).requires_grad_()
              for k in ("s_row", "s_col", "x")]
    ct = torch.from_numpy(fx["ct"]).to(cuda)

    def attend():
        out = pt.gat_attention(sp, *inputs)
        return out.detach(), torch.autograd.grad(out, inputs, ct)

    with plain_kernels():
        ref, ref_grads = attend()
    reset_launch_counts()
    out, grads = attend()
    counts = _counts()
    if counts != {**_NONE, **ATTENTION_LAUNCHES}:
        raise AssertionError(f"gat_attention: launches {counts}")
    e_plain = max_err(out, ref, 1e-4)
    g_plain = _grad_close(torch, grads, ref_grads, 1e-4, 1e-5)
    e_jax = max_err(out, torch.from_numpy(fx["attn/out"]).to(cuda), 2e-4)
    g_jax = max(
        max_err(g, torch.from_numpy(fx[f"attn/grads/{k}"]).to(cuda), 2e-3)
        for g, k in zip(grads, ("s_row", "s_col", "x")))
    log(f"[attention] gat_attention on {n} nodes, "
        f"{_hybrid_stats(sp.storage)}, F={fx['x'].shape[1]}: vs the plain "
        f"versions forward max_abs_err {e_plain:.3e}, gradients "
        f"{g_plain:.3e}; vs the JAX package's forward {e_jax:.3e} and "
        f"edge-space gradients {g_jax:.3e}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")

    conv, xg = fixture_gatconv(fx, cuda)
    saved = G.GAT_SLOT_MIN_NNZ
    G.GAT_SLOT_MIN_NNZ = sp.nnz
    try:
        reset_launch_counts()
        with torch.inference_mode():
            gout = conv(xg, sp)
        counts = _counts()
    finally:
        G.GAT_SLOT_MIN_NNZ = saved
    heads = int(fx["gat/dims"][2])
    if counts["sddmm_cells"] or counts["spmm_dense_cells"] != heads:
        raise AssertionError(f"GATConv on the slot route: launches {counts}")
    e = max_err(gout, torch.from_numpy(fx["gat/out"]).to(cuda), 1e-4)
    log(f"[attention] GATConv {fx['gat/dims'].tolist()} (in, out, heads) on "
        f"the slot route vs the JAX package's: max_abs_err {e:.3e}")

    rowptr, col, vals = hybrid_csr()
    m = len(rowptr) - 1
    hsp = pt.SparseTensor.from_csr(rowptr, col, None, sparse_sizes=(m, m),
                                   device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    args = [torch.randn(m, 16, generator=gen, device=cuda).requires_grad_()
            for _ in range(3)]
    cot = torch.randn(m, 16, generator=gen, device=cuda)
    chains = []
    for chain in (_slot_chain, _edge_chain):
        o = chain(torch, hsp, *args)
        chains.append((o.detach(), torch.autograd.grad(o, args, cot)))
    e = max_err(chains[0][0], chains[1][0], 1e-4)
    g = max(max_err(a, b, 2e-3) for a, b in zip(chains[0][1], chains[1][1]))
    log(f"[attention] slot chain (sddmm_slots, LeakyReLU, edge_softmax_slots,"
        f" spmm_slots) vs the edge-order chain on {m} nodes, "
        f"{_hybrid_stats(hsp.storage)}, F=16: forward max_abs_err {e:.3e}, "
        f"gradients {g:.3e}")

    # the tier values follow in-place changes of the values (ROADMAP C1)
    for change in ("mul_", "sgd step"):
        src = torch.from_numpy(vals.copy()).to(cuda)
        if change == "sgd step":
            src = torch.nn.Parameter(src)
        p = pt.SparseTensor.from_csr(rowptr, col, src, sparse_sizes=(m, m),
                                     device=cuda)
        x = torch.randn(m, 8, generator=gen, device=cuda).requires_grad_()
        cot = torch.randn(m, 8, generator=gen, device=cuda)
        pt.spmm(p, x)
        if change == "sgd step":
            opt = torch.optim.SGD([src], lr=0.5)
            (pt.spmm(p, x) * cot).sum().backward()
            opt.step()
        else:
            src.mul_(2)
        routes = []
        for algorithm in (pt.Algorithm.AUTO, pt.Algorithm.XLA_SEGMENT):
            o = pt.spmm(p, x, algorithm=algorithm)
            routes.append((o.detach(), torch.autograd.grad(o, x, cot)[0]))
        abs_p = p.set_values(src.detach().abs())
        abs_out = pt.spmm(abs_p, x.detach().abs(),
                          algorithm=pt.Algorithm.XLA_SEGMENT)
        abs_dx = pt.spmm(abs_p.t(), cot.abs())
        torch.cuda.synchronize()
        e = max(assert_sum_close(routes[0][0], routes[1][0], abs_out,
                                 TOL["float32"]),
                assert_sum_close(routes[0][1], routes[1][1], abs_dx,
                                 TOL["float32"]))
        log(f"[attention] hybrid values after {change}: the hybrid route vs "
            f"the CSR route, forward and d_dense, max_abs_err {e:.3e}")


def _describe(model):
    """The model's class and its widths, input to output."""
    from torch import nn

    from dgsparse_tpu_torch.nn import PointCloudUNet

    if isinstance(model, PointCloudUNet):
        convs = (model.enc1.SubMConv3d_0, model.down1,
                 model.enc2.SubMConv3d_0, model.up1)
        dims = [convs[0].kernel.shape[1]] + [c.kernel.shape[2]
                                             for c in convs]
        return (f"PointCloudUNet {'->'.join(map(str, dims))} (+"
                f"{dims[1]} skip)->{model.head.out_features}")
    linears = [m for m in model.modules() if isinstance(m, nn.Linear)]
    dims = [linears[0].in_features] + [m.out_features for m in linears]
    return f"{type(model).__name__} " + "->".join(map(str, dims))


def _data_desc(adj):
    """The size of a main path's graph or voxel cloud."""
    if hasattr(adj, "coords"):
        return (f"{len(adj.coords)} voxels in "
                f"{'x'.join(map(str, adj.spatial_shape))}")
    return f"{adj.sparse_sizes()[0]} nodes, {adj.nnz} nnz"


def _out_shape(tc):
    """(rows, classes) of a configuration's logits."""
    from dgsparse_tpu_torch.entry import CLOUDS, CONFIGS

    if tc.model == "unet":
        cloud = CLOUDS[tc.graph]
        return cloud.num_points, cloud.num_classes
    cfg = CONFIGS[tc.graph]
    return cfg.num_nodes, cfg.num_classes


def _counts():
    from dgsparse_tpu_torch.kernels import launch_counts

    counts = launch_counts()
    return {k: counts[k] for k in KERNEL_NAMES}


def phase_slice(torch, cuda, graphs):
    from dgsparse_tpu_torch.entry import SERVE_CONFIGS, build_model
    from dgsparse_tpu_torch.kernels import reset_launch_counts

    runs = {}
    for config, tc in SERVE_CONFIGS.items():
        adj, x, _ = graphs[_graph_key(tc)]
        model = build_model(config, seed=0, device=cuda)
        with torch.inference_mode(), plain_kernels():
            ref = model(x, adj)
        torch.cuda.synchronize()
        log(f"[slice] {config}: {_data_desc(adj)}, {_describe(model)}")
        runs[config] = (adj, x, model, ref)

    reset_launch_counts()
    per_config = {}
    resident = torch.cuda.memory_allocated()
    for config, (adj, x, model, _) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        before = _counts()
        latencies = []
        with torch.inference_mode():
            for _ in range(REQUESTS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model(x, adj)
                torch.cuda.synchronize()
                latencies.append((time.perf_counter() - t0) * 1e3)
        after = _counts()
        per_config[config] = (out, latencies,
                              {k: after[k] - before[k] for k in KERNEL_NAMES},
                              torch.cuda.max_memory_allocated())
    launches = _counts()

    for config, (out, latencies, n_launch, peak) in per_config.items():
        adj, _, model, ref = runs[config]
        tc = SERVE_CONFIGS[config]
        expected = {k: REQUESTS * v for k, v in
                    FORWARD_LAUNCHES[_launch_kind(tc, adj)].items()}
        if n_launch != expected:
            raise AssertionError(
                f"{config}: launches {n_launch} in {REQUESTS} forwards, "
                f"expected {expected}")
        if tuple(out.shape) != _out_shape(tc):
            raise AssertionError(f"{config}: output shape {out.shape}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{config}: non-finite output")
        e = max_err(out, ref, 1e-4)
        log(f"[slice] {config}: {REQUESTS} requests, latency ms "
            f"{[round(t, 4) for t in latencies]}, launches "
            f"{ {k: v for k, v in n_launch.items() if v} }, "
            f"max_memory_allocated {peak} B (all graphs resident: "
            f"{resident} B), vs the plain versions max_abs_err {e:.3e}")
    return runs, launches


def _graph_key(tc):
    """The `graphs` key of a configuration: GIN takes the bare graph."""
    return f"{tc.graph}-gin" if tc.model == "gin" else tc.graph


def _launch_kind(tc, adj):
    """The key of a configuration's launches: its model's, or for a GCN on
    a graph with a hybrid plan "gcn-hybrid", for a GAT on one of at least
    `nn.gat.GAT_SLOT_MIN_NNZ` edges (its slot-space branch) "gat-hybrid"."""
    from dgsparse_tpu_torch.nn import gat

    if tc.model == "unet":
        return "unet"
    hybrid = adj.storage.ell_plan() is not None and (
        tc.model != "gat" or adj.nnz >= gat.GAT_SLOT_MIN_NNZ)
    return f"{tc.model}-hybrid" if hybrid else tc.model


def build_graphs(torch, cuda):
    """Each graph and cloud the main paths take, built once: the
    GCN-normalized Cora, arxiv and Reddit-scale graphs, the bare Cora and
    arxiv structures for GIN, and the UNet's voxel clouds with their four
    rulebooks; the Reddit-scale build's phases timed."""
    from dgsparse_tpu_torch.entry import synthetic_cloud, synthetic_graph

    graphs = {}
    for config, gin in (("cora", False), ("cora", True), ("arxiv", False),
                        ("arxiv", True), ("reddit", False)):
        t0 = time.perf_counter()
        data = synthetic_graph(config, seed=0, device=cuda,
                               gcn_norm=not gin)
        torch.cuda.synchronize()
        key = f"{config}-gin" if gin else config
        graphs[key] = data
        phases = data[0].storage.build_seconds
        log(f"[graphs] {key}: {data[0].sparse_sizes()[0]} nodes, "
            f"{data[0].nnz} nnz "
            f"{'(bare structure)' if gin else 'with self-loops'}; host "
            f"build and upload {time.perf_counter() - t0:.2f} s; phases "
            f"{ {k: round(v, 3) for k, v in phases.items()} }")
    for config in CLOUDS:
        t0 = time.perf_counter()
        graphs[config] = synthetic_cloud(config, seed=0, device=cuda)
        plans = unet_plans(graphs[config][0])
        torch.cuda.synchronize()
        log(f"[graphs] {config}: {_data_desc(graphs[config][0])}; cloud and "
            f"its 4 rulebooks built and uploaded in "
            f"{time.perf_counter() - t0:.2f} s; pairs per conv "
            f"{ {k: p.total_pairs for k, p in plans.items()} }, "
            f"{plans['enc2'].num_in} coarse sites")
    return graphs


def unet_plans(st):
    """The UNet's rulebook of each conv on the cloud `st`, built once and
    cached on st as a forward caches them."""
    from dgsparse_tpu_torch.nn import PointCloudUNet

    return PointCloudUNet().plans(st)


@contextlib.contextmanager
def plain_kernels():
    """The kernels' plain versions in place of their launches, on the
    card: the oracle of the serving and training phases."""
    from dgsparse_tpu_torch.kernels import edge_softmax as E
    from dgsparse_tpu_torch.kernels import sddmm_csr as S
    from dgsparse_tpu_torch.kernels import spconv as P
    from dgsparse_tpu_torch.kernels import spmm_bell as B
    from dgsparse_tpu_torch.kernels import spmm_cells as C
    from dgsparse_tpu_torch.kernels import spmm_csr as K
    from dgsparse_tpu_torch.kernels import spmm_maxmin as M

    swaps = [(E, "edge_softmax_cuda", E.edge_softmax_plain),
             (E, "edge_softmax_bwd_cuda", E.edge_softmax_bwd_plain),
             (P, "spconv_pairs_cuda", P.spconv_pairs_plain),
             (P, "spconv_dw_cuda", P.spconv_dw_plain),
             (K, "csr_spmm_cuda", K.csr_spmm_plain),
             (S, "sddmm_csr_cuda", S.sddmm_csr_plain),
             (M, "spmm_maxmin_cuda", M.spmm_maxmin_plain),
             # the kernel's CSR view (rowptr, slot) is not the plain's
             (M, "spmm_maxmin_d_dense_cuda",
              lambda *args: M.spmm_maxmin_d_dense_plain(*args[:6])),
             (M, "spmm_maxmin_d_values_cuda", M.spmm_maxmin_d_values_plain),
             (C, "spmm_dense_cells_cuda", C.spmm_dense_cells_plain),
             (C, "sddmm_cells_cuda", C.sddmm_cells_plain),
             # out= as the router passes it: added into in place
             (B, "spmm_bell_cuda", B.spmm_bell_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


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
    return float(loss.detach()), fwd_err, ref, _grads(model)


def phase_training(torch, cuda, graphs):
    import numpy as np

    from dgsparse_tpu_torch.entry import (TRAIN_CONFIGS, build_trainer,
                                          train_step)
    from dgsparse_tpu_torch.kernels import reset_launch_counts

    prepared = {}
    for config, tc in TRAIN_CONFIGS.items():
        data = graphs[_graph_key(tc)]
        adj, x, y = data
        model, _, _ = build_trainer(config, seed=0, device=cuda, data=data)
        oracle = _oracle(torch, model, x, adj, y)
        model, opt, _ = build_trainer(config, seed=0, device=cuda, data=data)
        prepared[config] = (model, opt, data, oracle)
    torch.cuda.synchronize()

    reset_launch_counts()
    runs = {}
    resident = torch.cuda.memory_allocated()
    for config, (model, opt, (adj, x, y), _) in prepared.items():
        torch.cuda.reset_peak_memory_stats()
        losses, latencies, per_step = [], [], []
        for _ in range(STEPS):
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = train_step(model, opt, x, adj, y)
            torch.cuda.synchronize()
            latencies.append((time.perf_counter() - t0) * 1e3)
            after = _counts()
            per_step.append({k: after[k] - before[k]
                             for k in KERNEL_NAMES})
            losses.append(float(loss))
        runs[config] = (losses, latencies, per_step,
                        torch.cuda.max_memory_allocated())
    launches = _counts()

    step_ms = {}
    for config, (losses, latencies, per_step, peak) in runs.items():
        tc = TRAIN_CONFIGS[config]
        expected = STEP_LAUNCHES[_launch_kind(tc, prepared[config][2][0])]
        if any(p != expected for p in per_step):
            raise AssertionError(
                f"{config}: launches per step {per_step}, expected "
                f"{expected}")
        # with the port's seeded init, a GIN's first Adam update overshoots
        # and its loss rises before it falls (its fixture, started from
        # JAX's init, falls from step 1 as JAX's does)
        falls = tc.model != "gin"
        if not np.isfinite(losses).all() or (falls
                                             and not losses[-1] < losses[0]):
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
        adj = graphs[_graph_key(tc)][0]
        log(f"[training] {config}: {_data_desc(adj)}, {STEPS} Adam steps, "
            f"losses "
            f"{[round(v, 6) for v in losses]}, step latency ms "
            f"{[round(t, 4) for t in latencies]}, launches per step "
            f"{ {k: v for k, v in per_step[0].items() if v} }, "
            f"max_memory_allocated {peak} B (before the steps: "
            f"{resident} B resident); step 1 vs the "
            f"plain versions: logits max_abs_err {fwd_err:.3e}, gradients "
            f"max_abs_err {grad_err:.3e}")
        step_ms[config] = latencies
        if _launch_kind(tc, adj) == "gat-hybrid":
            model, _, (_, x, _), _ = prepared[config]
            log(f"[training] {config}: largest max(s_col) - min(s_col) of a "
                f"head after {STEPS} steps (the slot route's shift is loose "
                f"by it): {_score_range(torch, model, x, adj):.4f}")
    return launches, step_ms


def _score_range(torch, model, x, adj):
    """The largest range max(s_col) - min(s_col) of a GAT head's
    source-side scores in the forward of `model` on (x, adj)."""
    from dgsparse_tpu_torch.nn.gat import GATConv

    ranges = []

    def hook(conv, args, _):
        h = conv.proj(args[0]).reshape(args[0].shape[0], conv.num_heads, -1)
        ss = torch.einsum("nhf,hf->nh", h, conv.a_src)
        ranges.append((ss.amax(0) - ss.amin(0)).max().item())

    handles = [c.register_forward_hook(hook) for c in model.modules()
               if isinstance(c, GATConv)]
    try:
        with torch.no_grad():
            model(x, adj)
    finally:
        for h in handles:
            h.remove()
    return max(ranges)


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

    for config in ("gcn-arxiv", "gat-arxiv", "gin-max-arxiv", "gcn-reddit",
                   "gat-reddit", "unet-60k"):
        data = graphs[_graph_key(TRAIN_CONFIGS[config])]
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
        if config == "gcn-reddit":
            # the float adds (`+=`, `add_`): the tier sums among them
            adds = [r for r in rows if "CUDAFunctor_add" in r[2]]
            log(f"[profile]   {config} elementwise float adds: "
                f"{sum(r[0] for r in adds) / steps:.1f} us/step in "
                f"{sum(r[1] for r in adds) // steps} calls/step")
        # the redesigned kernels of the step, by name
        for kernel in PROFILED_PASSES.get(config, ()):
            hits = [r for r in rows if kernel in r[2]]
            if not hits:
                raise AssertionError(f"{config}: no {kernel} in the profile")
            log(f"[profile]   {config} {kernel}: "
                f"{sum(r[0] for r in hits) / steps:.1f} us/step in "
                f"{sum(r[1] for r in hits) // steps} calls/step")


def _time_turns(fns, **counts):
    """Best of two turns of CUDA-event timings, the second turn in reverse
    order, so drift in clocks hits every version alike; `counts` (warmup,
    iters) go to cuda_time."""
    from dgsparse_tpu_torch.utils.bench import cuda_time

    t = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for who in order:
            fn, args = fns[who]
            t[who].append(cuda_time(fn, *args, **counts))
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


def _citation_graph(cuda):
    """The GCN adjacency of the benchmark's graph at seed 0: the generator
    and sizes of `portbench/configs/gcn-arxiv.json`, normalized as the
    benchmark's GCN builds it (self-loops, D^-1/2 (A + I) D^-1/2)."""
    from dgsparse_tpu_torch.nn.gcn import get_gcn_dcsr_from_edge_index
    from portbench.graphs import citation

    with open(os.path.join(HERE, "portbench", "configs",
                           "gcn-arxiv.json")) as f:
        cfg = json.load(f)["graph"]
    g = citation.make(cfg, 0)
    return get_gcn_dcsr_from_edge_index(g["edge_index"], g["num_nodes"],
                                        device=cuda)


def _edge_softmax_numbers(torch, cuda, st, gen):
    """edge_softmax on the benchmark's graph at GAT's two layers (8 heads,
    then one), logits made as GATConv makes them (a LeakyReLU of two
    `gather_rows`), the storage's split plan as the main path passes it:
    forward and backward kernels against the plain versions, and both
    kernels against the aten chain they replaced (the plain forward under
    autograd, then its backward)."""
    from torch.nn import functional as F

    from dgsparse_tpu_torch.core.transform import gather_rows
    from dgsparse_tpu_torch.kernels import edge_softmax as E
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    split, rowptr, row = st.row_split(), st.rowptr(), st.coo_row()
    m, nnz = st.num_rows, st.nnz
    out = {}
    for heads in (8, 1):
        sd, ss = (torch.randn(m, heads, generator=gen, device=cuda)
                  for _ in range(2))
        x = F.leaky_relu(gather_rows(sd, row) + gather_rows(ss, st.col()),
                         0.2)
        g = torch.randn(nnz, heads, generator=gen, device=cuda)
        cm = x.dim() == 2 and x.shape[1] > 1 and x.stride(0) == 1
        # held to the plain versions in float64: in float32, index_add_'s
        # atomics move a hub row's sum by more than the kernels' rounding
        alpha = E.edge_softmax_cuda(rowptr, x, split=split)
        ref = E.edge_softmax_plain(rowptr, x.double(), row).float()
        assert_sum_close(alpha, ref, ref, TOL["float32"])
        dx = E.edge_softmax_bwd_cuda(rowptr, alpha, g, split=split,
                                     column_major=cm)
        dref = E.edge_softmax_bwd_plain(rowptr, alpha.double(), g.double(),
                                        row).float()
        scale = alpha.abs() * (g.abs() + gather_rows(E._row_sums(
            (alpha * g).abs(), row, m), row))
        assert_sum_close(dx, dref, scale, TOL["float32"])

        def kernels(x, g):
            a = E.edge_softmax_cuda(rowptr, x, split=split)
            E.edge_softmax_bwd_cuda(rowptr, a, g, split=split,
                                    column_major=cm)

        def chain(x, g):
            xr = x.detach().requires_grad_()
            E.edge_softmax_plain(rowptr, xr, row).backward(g)

        ms = _time_turns({
            "forward": (functools.partial(E.edge_softmax_cuda, split=split),
                        (rowptr, x)),
            "backward": (functools.partial(E.edge_softmax_bwd_cuda,
                                           split=split, column_major=cm),
                         (rowptr, alpha, g)),
            "plain_forward": (E.edge_softmax_plain, (rowptr, x, row)),
            "plain_backward": (E.edge_softmax_bwd_plain,
                               (rowptr, alpha, g, row)),
            "kernels": (kernels, (x, g)),
            "aten_chain": (chain, (x, g))})
        e = nnz * heads
        ms["bound_forward"] = bound(4 * (m + 1 + 2 * e), 5.0 * e)["bound"]
        ms["bound_backward"] = bound(4 * (m + 1 + 3 * e), 4.0 * e)["bound"]
        ms.update(path=E.softmax_path(heads), column_major=cm,
                  split_rows=split.num_split_rows,
                  split_chunks=split.num_chunks)
        out[f"citation H={heads}"] = ms
        log(f"[numbers] edge_softmax citation H={heads} ({m} rows, {nnz} "
            f"nnz, fp32, logits {'column' if cm else 'row'}-major, path "
            f"{ms['path']}, {split.num_split_rows} rows split into "
            f"{split.num_chunks} chunks): "
            + ", ".join(f"{k} {ms[k] * 1e3:.2f} us" for k in (
                "forward", "bound_forward", "backward", "bound_backward",
                "plain_forward", "plain_backward", "kernels", "aten_chain")))
    return out


def phase_numbers(torch, cuda, runs, graphs):
    import numpy as np

    from dgsparse_tpu_torch.entry import SERVE_CONFIGS
    from dgsparse_tpu_torch.kernels import sddmm_csr as S
    from dgsparse_tpu_torch.kernels import spmm_csr as K
    from dgsparse_tpu_torch.utils.bench import spmm_gflops
    from dgsparse_tpu_torch.utils.testing import assert_sum_close, random_csr

    gen = torch.Generator(device=cuda).manual_seed(1)
    results = {"csr_spmm": {}, "sddmm_csr": {}}

    rp, col, vals = random_csr(P2P_NODES, P2P_NODES,
                               avg_degree=P2P_EDGES / P2P_NODES, seed=0,
                               skew=1.0)
    rowptr, col_t, vals_t = _to(cuda, rp, col, np.abs(vals))
    rowptr_p2p, col_p2p = rowptr, col_t
    # SpMM cases: (label, rowptr, col, values [nnz] or [nnz, H], N, H*F,
    # the split plan the main path passes or None)
    spmm_cases = [("p2p-synthetic F=32", rowptr, col_t, vals_t, P2P_NODES,
                   32, K.split_plan(rp, device=cuda))]
    for config, (adj, _, model, _) in runs.items():
        tc = SERVE_CONFIGS[config]
        if _launch_kind(tc, adj) != "gcn":
            continue            # the hybrid route is timed on its own
        st = adj.storage
        for layer in ("conv1", "conv2"):
            feat = getattr(model, layer).linear.out_features
            spmm_cases.append((f"{tc.graph} {layer} F={feat}", st.rowptr(),
                               st.col(), st.values(), adj.sparse_sizes()[1],
                               feat, st.row_split()))
    st = graphs["arxiv"][0].storage
    vals_csc = st.values()[st.csr2csc().long()]
    for layer, feat in (("conv1", 256), ("conv2", 40)):
        spmm_cases.append((f"arxiv {layer} backward d_dense (CSC) F={feat}",
                           st.colptr(), st.row(), vals_csc, st.num_rows,
                           feat, st.col_split()))
    alpha = torch.rand(st.nnz, 4, generator=gen, device=cuda)
    spmm_cases.append(("arxiv gat1 forward H=4 F=16", st.rowptr(), st.col(),
                       alpha, st.num_cols, 64, st.row_split()))
    spmm_cases.append(("arxiv gat2 forward H=1 F=7", st.rowptr(), st.col(),
                       alpha[:, :1].contiguous(), st.num_cols, 7,
                       st.row_split()))
    # the benchmark's graph (portbench/graphs/citation.py, seed 0): hub rows
    # of up to 13,096 entries, forward and CSC, with and without the plan
    st = citation = _citation_graph(cuda).storage
    vals_csc = st.values()[st.csr2csc().long()]
    for feat in (256, 40):
        spmm_cases.append((f"citation forward F={feat}", st.rowptr(),
                           st.col(), st.values(), st.num_cols, feat,
                           st.row_split()))
        spmm_cases.append((f"citation backward d_dense (CSC) F={feat}",
                           st.colptr(), st.row(), vals_csc, st.num_rows,
                           feat, st.col_split()))
    # the hybrid route's CSR launches at Reddit scale (~23 M edges each),
    # which pass no plan
    st = graphs["reddit"][0].storage
    hp, tiers = st.ell_plan(), st.tier_values()
    for feat in REDDIT_FEATS:
        spmm_cases.append((f"reddit residue F={feat}", hp.res.rowptr,
                           hp.res.col, tiers["res"], st.num_cols, feat,
                           None))
        spmm_cases.append((f"reddit non-cell transpose (CSC) F={feat}",
                           hp.nd_t.rowptr, hp.nd_t.col, tiers["nd_t"],
                           st.num_rows, feat, None))

    for label, rowptr, col_t, vals_t, n, width, split in spmm_cases:
        m, nnz = rowptr.numel() - 1, col_t.numel()
        heads = 1 if vals_t.dim() == 1 else vals_t.shape[1]
        x = torch.randn(n, width, generator=gen, device=cuda)
        fns = {"kernel": (functools.partial(K.csr_spmm_cuda, split=split),
                          (rowptr, col_t, vals_t, x)),
               "plain": (K.csr_spmm_plain, (rowptr, col_t, vals_t, x))}
        split_rows = split.num_split_rows if split is not None else 0
        if split_rows:
            # the same kernel without the plan, every row on its own group
            fns["unsplit"] = (K.csr_spmm_cuda, (rowptr, col_t, vals_t, x))
            assert_sum_close(
                K.csr_spmm_cuda(rowptr, col_t, vals_t, x, split=split),
                K.csr_spmm_plain(rowptr, col_t, vals_t, x),
                K.csr_spmm_plain(rowptr, col_t, vals_t.abs(), x.abs()),
                TOL["float32"])
        # the same kernel at F = 256 in one pass
        paths = {"one_pass_path": (4, 32, 2)} if width == 256 else {}
        for key, path in paths.items():
            fns[key] = (functools.partial(K.csr_spmm_cuda, path=path),
                        (rowptr, col_t, vals_t, x))
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
        # ~23 M edges: fewer launches (the plain version takes ~100 ms)
        ms = _time_turns(fns, **({"warmup": 2, "iters": 10}
                                 if label.startswith("reddit") else {}))
        nbytes = 4 * ((m + 1) + nnz + nnz * heads + n * width + m * width)
        ms.update(bound(nbytes, 2.0 * nnz * width))
        ms["library_call"] = library_call
        ms["paths"] = {"kernel": K.spmm_path(width, heads, 4), **paths}
        ms["split_rows"] = split_rows
        ms["split_chunks"] = split.num_chunks if split_rows else 0
        results["csr_spmm"][label] = ms
        log(f"[numbers] csr_spmm {label} ({m} rows, {nnz} nnz, fp32, path "
            f"{ms['paths']['kernel']}, {split_rows} rows split into "
            f"{ms['split_chunks']} chunks of {K.SPLIT_CHUNK}): "
            + ", ".join(f"{k} {ms[k] * 1e3:.2f} us "
                        f"{spmm_gflops(nnz, width, ms[k] / 1e3):.2f} GF/s"
                        for k in ("kernel", "unsplit", "plain", "library",
                                  *paths)
                        if k in ms)
            + f", bound {ms['bound'] * 1e3:.2f} us ({ms['bound_by']}, "
            f"{ms['bound_rate']}); {ms['bound'] / ms['kernel']:.3f} of the "
            f"bound; other paths {paths}")

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
                   "plain": (S.sddmm_csr_plain, args),
                   **_sddmm_mappings(S, feat, heads, args)}
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
            ms.update(bound(nbytes, 2.0 * nnz * heads * feat))
            ms["library_call"] = (
                "torch.sparse.sampled_addmm (cuSPARSE)" if heads == 1 else
                "torch.sparse.sampled_addmm over a batched CSR [H, M, N] "
                "(cuSPARSE)")
            _log_sddmm(results, label, m, nnz, ms, S, feat, heads)
    # GAT's d_values on the benchmark's graph at its two widths (8 heads of
    # 8, one of 40): "kernel" with the storage's split plan, as the main
    # path passes it, "unsplit" without; the split held to the plain
    # version and to the unsplit launch, bit for bit, first
    st = citation
    split = st.row_split()
    for heads, feat in ((8, 8), (1, 40)):
        label = f"citation d_values H={heads} F={feat}"
        m, n, nnz = st.num_rows, st.num_cols, st.nnz
        d1 = torch.randn(m, heads * feat, generator=gen, device=cuda)
        d2 = torch.randn(n, heads * feat, generator=gen, device=cuda)
        args = (st.rowptr(), st.col(), d1, d2, heads)
        out = S.sddmm_csr_cuda(*args, split=split)
        assert_sum_close(out, S.sddmm_csr_plain(*args),
                         S.sddmm_csr_plain(st.rowptr(), st.col(), d1.abs(),
                                           d2.abs(), heads),
                         TOL["float32"])
        if not torch.equal(out, S.sddmm_csr_cuda(*args)):
            raise AssertionError(f"sddmm_csr {label}: the split launch "
                                 "differs from the unsplit one")
        ms = _time_turns({
            "kernel": (functools.partial(S.sddmm_csr_cuda, split=split),
                       args),
            "unsplit": (S.sddmm_csr_cuda, args),
            "plain": (S.sddmm_csr_plain, args)})
        nbytes = 4 * ((m + 1) + nnz + (m + n) * heads * feat + nnz * heads)
        ms.update(bound(nbytes, 2.0 * nnz * heads * feat))
        ms["split_rows"] = split.num_split_rows
        ms["split_chunks"] = split.num_chunks
        _log_sddmm(results, label, m, nnz, ms, S, feat, heads)
    results["edge_softmax"] = _edge_softmax_numbers(torch, cuda, citation,
                                                    gen)
    # the hybrid sddmm's CSR launch at Reddit scale: the non-cell edges'
    # sub-CSR (~23 M edges), d2 [N, F] (60 MB at F = 64) past L2
    st = graphs["reddit"][0].storage
    nd = st.ell_plan().nd
    m, n, nnz = st.num_rows, st.num_cols, nd.col.numel()
    for feat in REDDIT_FEATS:
        label = f"reddit non-cell edges F={feat}"
        d1 = torch.randn(m, feat, generator=gen, device=cuda)
        d2 = torch.randn(n, feat, generator=gen, device=cuda)
        args = (nd.rowptr, nd.col, d1, d2)
        a = torch.sparse_csr_tensor(nd.rowptr, nd.col,
                                    torch.ones(nnz, device=cuda), size=(m, n))
        lib = torch.sparse.sampled_addmm(a, d1, d2.T, beta=0.0)
        max_err(lib.values(), S.sddmm_csr_cuda(*args).reshape(-1), 1e-4)
        del lib
        fns = {"kernel": (S.sddmm_csr_cuda, args),
               "plain": (S.sddmm_csr_plain, args),
               **_sddmm_mappings(S, feat, 1, args),
               "library": (lambda a, v1, v2: torch.sparse.sampled_addmm(
                   a, v1, v2, beta=0.0), (a, d1, d2.T))}
        ms = _time_turns(fns, warmup=2, iters=10)
        nbytes = 4 * ((m + 1) + nnz + (m + n) * feat + nnz)
        ms.update(bound(nbytes, 2.0 * nnz * feat))
        ms["library_call"] = "torch.sparse.sampled_addmm (cuSPARSE)"
        _log_sddmm(results, label, m, nnz, ms, S, feat, 1)
    results.update(_maxmin_numbers(torch, cuda, gen, graphs, rowptr_p2p,
                                   col_p2p))
    results.update(_segment_sum_numbers(torch, cuda, gen,
                                        graphs["reddit"][0].storage,
                                        rowptr_p2p, col_p2p.numel()))
    return results


def _segment_sum_numbers(torch, cuda, gen, reddit, rowptr_p2p, nnz_p2p):
    """segment_sum_csr (phase 7) at the two shapes it serves: the cell
    materialisation of the Reddit storage's dense-tier values (F = 1, one
    segment a distinct slot: the sum in DIV's per-call tier build) and a
    sorted_segment_sum of p2p's edge rows by row (F = 32); beside its
    plain version, torch.segment_reduce(data, "sum", offsets=rowptr) (held
    to the kernel at 1e-5 of the terms' absolute sum) and the bound."""
    from dgsparse_tpu_torch.kernels import spmm_cells as C
    from dgsparse_tpu_torch.kernels import spmm_csr as K
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    plan = reddit.ell_plan().cells
    rowptr, _, eperm = C._slot_segments(plan, cuda)
    cells = reddit.values().float()[eperm].unsqueeze(1).contiguous()
    cases = [("reddit cell materialisation F=1", rowptr, cells),
             ("p2p-synthetic sorted_segment_sum F=32", rowptr_p2p,
              torch.randn(nnz_p2p, 32, generator=gen, device=cuda))]
    results = {"segment_sum_csr": {}}
    for label, rowptr, data in cases:
        segs, (rows, feat) = rowptr.numel() - 1, data.shape
        out = K.segment_sum_csr_cuda(rowptr, data)
        abs_sum = K.segment_sum_csr_plain(rowptr, data.abs())
        e = assert_sum_close(out, K.segment_sum_csr_plain(rowptr, data),
                             abs_sum, TOL["float32"])
        e_lib = assert_sum_close(
            torch.segment_reduce(data, "sum", offsets=rowptr), out, abs_sum,
            TOL["float32"])
        ms = _time_turns({
            "kernel": (K.segment_sum_csr_cuda, (rowptr, data)),
            "plain": (K.segment_sum_csr_plain, (rowptr, data)),
            "library": (lambda d, r: torch.segment_reduce(d, "sum", offsets=r),
                        (data, rowptr))})
        ms.update(bound(4 * ((segs + 1) + rows * feat + segs * feat),
                        rows * feat))
        ms["library_call"] = ('torch.segment_reduce(data, "sum", '
                              'offsets=rowptr)')
        ms["path"] = K.spmm_path(feat, 1, 4, 16)
        results["segment_sum_csr"][label] = ms
        log(f"[numbers] segment_sum_csr {label} ({rows} rows into {segs} "
            f"segments, fp32, path {ms['path']}): kernel "
            f"{ms['kernel'] * 1e3:.2f} us, plain {ms['plain'] * 1e3:.2f} us, "
            f"{ms['library_call']} {ms['library'] * 1e3:.2f} us, bound "
            f"{ms['bound'] * 1e3:.2f} us ({ms['bound_by']}); "
            f"{ms['bound'] / ms['kernel']:.3f} of the bound; max_abs_err vs "
            f"plain {e:.3e}, the library call vs the kernel {e_lib:.3e}")
    return results


def _sddmm_mappings(S, feat, heads, args):
    """The two mappings of sddmm_csr, each forced, for phase 7: the group
    mapping on `sddmm_path`, and one warp a row (the mapping before it)."""
    return {"group": (functools.partial(
                S.sddmm_csr_cuda, path=S.sddmm_path(feat, heads, 4)), args),
            "old_mapping": (functools.partial(
                S.sddmm_csr_cuda, path=S.WARP_PER_ROW), args)}


def _log_sddmm(results, label, m, nnz, ms, S, feat, heads):
    ms["paths"] = {"kernel": S.pick_sddmm(feat, heads, 4),
                   "group": S.sddmm_path(feat, heads, 4),
                   "old_mapping": S.WARP_PER_ROW}
    results["sddmm_csr"][label] = ms
    split = (f", {ms['split_rows']} rows split into {ms['split_chunks']} "
             f"chunks" if "split_rows" in ms else "")
    log(f"[numbers] sddmm_csr {label} ({m} rows, {nnz} nnz, fp32, picked "
        f"{ms['paths']['kernel']}{split}): "
        + ", ".join(f"{k} {ms[k] * 1e3:.2f} us"
                    for k in ("kernel", "unsplit", "group", "old_mapping",
                              "plain", "library")
                    if k in ms)
        + f", bound {ms['bound'] * 1e3:.2f} us ({ms['bound_by']}, "
        f"{ms['bound_rate']}); {ms['bound'] / ms['kernel']:.3f} of the "
        f"bound")


def phase_sddmm_hybrid(torch, cuda, reddit):
    """The sddmm path on the Reddit-scale storage at F = 64: `sddmm` takes
    the hybrid route (1 sddmm_cells, 1 sddmm_csr over the non-cell edges)
    and is held to the CSR-only sddmm_csr kernel on the same inputs at
    1e-5 scaled by the terms' absolute sum. Returns the path's launches."""
    import dgsparse_tpu_torch as pt
    from dgsparse_tpu_torch.kernels import reset_launch_counts
    from dgsparse_tpu_torch.kernels import sddmm_csr as S
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    st = reddit.storage
    gen = torch.Generator(device=cuda).manual_seed(4)
    d1 = torch.randn(st.num_rows, 64, generator=gen, device=cuda)
    d2 = torch.randn(st.num_cols, 64, generator=gen, device=cuda)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = pt.sddmm(reddit, d1, d2)
    torch.cuda.synchronize()
    launches = _counts()
    expected = {**_NONE, "sddmm_cells": 1, "sddmm_csr": 1}
    if launches != expected:
        raise AssertionError(f"sddmm on the hybrid storage: launches "
                             f"{launches}, expected {expected}")
    ref = S.sddmm_csr_cuda(st.rowptr(), st.col(), d1, d2).reshape(-1)
    abs_sum = S.sddmm_csr_cuda(st.rowptr(), st.col(), d1.abs(),
                               d2.abs()).reshape(-1)
    e = assert_sum_close(out, ref, abs_sum, TOL["float32"])
    log(f"[sddmm] reddit F=64: {st.nnz} edges through the hybrid route, "
        f"launches { {k: v for k, v in launches.items() if v} }; vs the "
        f"CSR-only sddmm_csr max_abs_err {e:.3e}")
    return launches


def _bell_reads(plan):
    """(distinct B rows the BELL edges reference, bytes of the real slots'
    columns and values and of the row-run arrays): what any BELL SpMM
    must read besides out."""
    import numpy as np

    real = np.nonzero(plan.eperm >= 0)[0]
    cw = plan.tile_cw.cpu().numpy().astype(np.int64)
    cols = cw[real // plan.edge_tile] * plan.col_window + \
        plan.lcol.cpu().numpy()[real]
    runs = sum(getattr(plan, k).numel()
               for k in ("rows", "run_ptr", "run_slot", "run_len"))
    return len(np.unique(cols)), 8 * len(real) + 4 * runs


def phase_hybrid_numbers(torch, cuda, reddit):
    """CUDA-event times (fp32, best of two turns) on the Reddit-scale
    storage at F = 64 and 41 of spmm_dense_cells (forward and transpose),
    spmm_bell and sddmm_cells beside their plain versions, one PyTorch call
    each (torch.bmm over the gathered cell and window blocks, TF32 off;
    cuSPARSE over the BELL tier's sub-CSR) and their bounds; spmm_bell
    standalone and added into a given out (the hybrid SpMM's mode), into
    out beside torch.addmm(out, BELL CSR, x); then the whole hybrid SpMM,
    beside csr_spmm and cuSPARSE over the full CSR."""
    import numpy as np

    from dgsparse_tpu_torch.core.planner import LONG_ROW_SLOTS
    from dgsparse_tpu_torch.kernels import spmm_bell as B
    from dgsparse_tpu_torch.kernels import spmm_cells as C
    from dgsparse_tpu_torch.kernels import spmm_csr as K
    from dgsparse_tpu_torch.ops.hybrid import spmm_hybrid
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    st = reddit.storage
    hp, tiers = st.ell_plan(), st.tier_values()
    plan, cells = hp.cells, tiers["cells"]
    m, n = st.num_rows, st.num_cols
    gen = torch.Generator(device=cuda).manual_seed(5)
    results = {"spmm_dense_cells": {}, "spmm_bell": {}, "sddmm_cells": {},
               "hybrid_spmm": {}}

    def blocks(x, block, which):
        nb = -(-x.shape[0] // block)
        xp = torch.zeros(nb * block, x.shape[1], device=cuda)
        xp[:x.shape[0]] = x
        return xp.view(nb, block, -1)[which.long()].contiguous()

    def report(kernel, label, ms, call):
        ms["library_call"] = call
        results[kernel][label] = ms
        log(f"[numbers] {kernel} {label} (fp32): "
            + ", ".join(f"{k} {ms[k] * 1e3:.2f} us"
                        for k in ("kernel", "plain", "library") if k in ms)
            + f", bound {ms['bound'] * 1e3:.2f} us ({ms['bound_by']}, "
            f"{ms['bound_rate']}); {ms['bound'] / ms['kernel']:.3f} of the "
            f"bound")

    # the BELL tier as a CSR of its own edges, for cuSPARSE
    run_len = hp.bell.run_len.cpu().numpy()
    row_slots = np.add.reduceat(run_len, hp.bell.run_ptr.cpu().numpy()[:-1])
    ep = hp.bell.eperm
    ids = np.sort(ep[ep >= 0])
    b_rowptr = torch.from_numpy(np.searchsorted(
        ids, st.rowptr().cpu().numpy()).astype(np.int32)).to(cuda)
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(cuda)
    bell_csr = torch.sparse_csr_tensor(b_rowptr, st.col()[ids_t],
                                       st.values()[ids_t], size=(m, n))
    cell_flops = 2.0 * plan.num_cells * 128 * 128
    for feat in REDDIT_FEATS:
        x = torch.randn(n, feat, generator=gen, device=cuda)
        g = torch.randn(m, feat, generator=gen, device=cuda)
        for transpose, inp in ((False, x), (True, g)):
            blk = blocks(inp, 128, plan.cell_rb if transpose else plan.cell_cw)
            a = cells.transpose(1, 2) if transpose else cells
            args = (plan, cells, inp, transpose)
            ms = _time_turns({"kernel": (C.spmm_dense_cells_cuda, args),
                              "plain": (C.spmm_dense_cells_plain, args),
                              "library": (torch.bmm, (a, blk))})
            out_rows = n if transpose else m
            ms.update(bound(
                4 * (cells.numel() + inp.numel() + out_rows * feat),
                cell_flops * feat, TF32X3_FLOPS))
            report("spmm_dense_cells",
                   f"reddit {'transpose' if transpose else 'forward'} "
                   f"F={feat}", ms, "torch.bmm(cells, gathered window "
                   "blocks [ncells, 128, F]), TF32 off")
        # spmm_bell (i) standalone: the row-run kernel with its zeros,
        # plain, cuSPARSE
        args = (hp.bell, tiers["bell"], x)
        b_rows, b_meta = _bell_reads(hp.bell)
        bell_ops = 2.0 * hp.bell.nnz * feat
        ms = _time_turns({
            "kernel": (B.spmm_bell_cuda, args),
            "plain": (B.spmm_bell_plain, args),
            "library": (torch.matmul, (bell_csr, x))})
        ms.update(bound(4 * b_rows * feat + b_meta + 4 * m * feat, bell_ops))
        ms["distinct_b_rows"] = b_rows
        report("spmm_bell", f"reddit F={feat}", ms,
               "torch.matmul(sparse_csr of the BELL edges, dense) (cuSPARSE)")
        log(f"[numbers] spmm_bell reddit F={feat} standalone: {b_rows} "
            f"distinct B rows, {hp.bell.num_bell_rows} BELL rows of which "
            f"{hp.bell.num_long_rows} long; slots a row: median "
            f"{np.median(row_slots):.0f}, 99th percentile "
            f"{np.percentile(row_slots, 99):.0f}, max {row_slots.max()}, "
            f"{row_slots[row_slots >= LONG_ROW_SLOTS].sum()} of "
            f"{row_slots.sum()} in the long rows")
        # (ii) added into a given out, as the hybrid SpMM runs it: the
        # row-run kernel in place, plain, and torch.addmm(out, BELL CSR, x)
        # as the one PyTorch call
        o = torch.randn(m, feat, generator=gen, device=cuda)
        fns = {
            "kernel": (functools.partial(B.spmm_bell_cuda, out=o), args),
            "plain": (functools.partial(B.spmm_bell_plain, out=o), args)}
        call = "torch.addmm(out, sparse_csr of the BELL edges, dense)"
        try:
            lib = torch.addmm(o, bell_csr, x)
            fns["library"] = (torch.addmm, (o, bell_csr, x))
        except RuntimeError as err:
            lib = o + torch.matmul(bell_csr, x)
            fns["two_calls"] = (lambda o_, a_, x_: o_ + torch.matmul(a_, x_),
                                (o, bell_csr, x))
            call = (f"torch.addmm raises on CUDA ({str(err)[:80]}); two "
                    "calls, not one: out + torch.matmul(BELL CSR, dense)")
        ref = B.spmm_bell_cuda(*args, out=o.clone())
        abs_sum = B.spmm_bell_plain(hp.bell, tiers["bell"].abs(), x.abs(),
                                    out=o.abs())
        assert_sum_close(lib, ref, abs_sum, TOL["float32"])
        ms = _time_turns(fns)
        ms.update(bound(4 * b_rows * feat + b_meta
                        + 2 * 4 * hp.bell.num_bell_rows * feat, bell_ops))
        report("spmm_bell", f"reddit F={feat} into out", ms, call)
        if "two_calls" in ms:
            log(f"[numbers] spmm_bell reddit F={feat} into out: two calls "
                f"{ms['two_calls'] * 1e3:.2f} us")
        d1 = torch.randn(m, feat, generator=gen, device=cuda)
        d2 = torch.randn(n, feat, generator=gen, device=cuda)
        args = (plan, d1, d2)
        ms = _time_turns({
            "kernel": (C.sddmm_cells_cuda, args),
            "plain": (C.sddmm_cells_plain, args),
            "library": (torch.bmm, (blocks(d1, 128, plan.cell_rb),
                                    blocks(d2, 128, plan.cell_cw).transpose(
                                        1, 2)))})
        ms.update(bound(
            4 * (d1.numel() + d2.numel() + cells.numel()), cell_flops * feat,
            TF32X3_FLOPS))
        report("sddmm_cells", f"reddit F={feat}", ms,
               "torch.bmm(gathered d1 blocks, gathered d2 blocksᵀ), TF32 off")

        # the whole SpMM: the three tiers, the CSR kernel, cuSPARSE
        full = torch.sparse_csr_tensor(st.rowptr(), st.col(), st.values(),
                                       size=(m, n))
        ms = _time_turns({
            "hybrid": (spmm_hybrid, (st, tiers, x)),
            "csr_spmm": (K.csr_spmm_cuda, (st.rowptr(), st.col(),
                                           st.values(), x)),
            "library": (torch.matmul, (full, x))})
        ms.update(bound(
            4 * ((m + 1) + 2 * st.nnz + n * feat + m * feat),
            2.0 * st.nnz * feat))
        ms["library_call"] = "torch.matmul(sparse_csr, dense) (cuSPARSE)"
        results["hybrid_spmm"][f"reddit F={feat}"] = ms
        log(f"[numbers] whole SpMM reddit F={feat} (fp32, {st.nnz} nnz): "
            f"hybrid tiers {ms['hybrid'] * 1e3:.2f} us, csr_spmm "
            f"{ms['csr_spmm'] * 1e3:.2f} us, cuSPARSE "
            f"{ms['library'] * 1e3:.2f} us, CSR bound "
            f"{ms['bound'] * 1e3:.2f} us ({ms['bound_by']}, "
            f"{ms['bound_rate']})")
    return results


def _fwd_bwd(torch, fn, ct, *inputs):
    """fn(*inputs), then its gradients for the cotangent ct."""
    out = fn(*inputs)
    return torch.autograd.grad(out, inputs, ct)


def phase_attention_numbers(torch, cuda, reddit):
    """At Reddit scale (gat-reddit's graph): one GATConv (602 -> 4 x 16) on
    the slot route against the same layer forced onto the edge route,
    forward (rtol = atol = 1e-4) and its parameters' gradients (rtol 1e-3,
    atol 1e-4 of each one's largest value), with the slot route's
    launches; then CUDA-event times (fp32, best of two turns of 3 calls
    after 1) of gat_attention against the edge route, forward and forward
    plus backward: per head at H=4 F=16 (`_edge_space_attention`, the JAX
    package's edge route) and H=1 F=41, the four heads of a layer (4
    gat_attention calls against GATConv's edge branch: logits in CSR edge
    order, edge_softmax, spmm_multihead), and the slot chain against the
    edge-order chain at F=16."""
    from torch.nn import functional as F

    from dgsparse_tpu_torch.core.transform import gather_rows
    from dgsparse_tpu_torch.kernels import reset_launch_counts
    from dgsparse_tpu_torch.nn import gat as G
    from dgsparse_tpu_torch.ops.attention import (_edge_space_attention,
                                                  gat_attention)
    from dgsparse_tpu_torch.ops.edge_softmax import edge_softmax
    from dgsparse_tpu_torch.ops.spmm_mh import spmm_multihead

    adj, x, _ = reddit
    st = adj.storage
    m, n = st.num_rows, st.num_cols
    gen = torch.Generator(device=cuda).manual_seed(9)
    conv = G.GATConv(x.shape[1], 16, 4,
                     generator=torch.Generator().manual_seed(0)).to(cuda)
    ct = torch.randn(m, 64, generator=gen, device=cuda)

    def layer():
        conv.zero_grad(set_to_none=True)
        out = conv(x, adj)
        out.backward(ct)
        return out.detach(), [p.grad.clone() for p in conv.parameters()]

    reset_launch_counts()
    slot_out, slot_grads = layer()
    counts = _counts()
    expected = {**_NONE, **{k: 4 * v for k, v in ATTENTION_LAUNCHES.items()}}
    if counts != expected:
        raise AssertionError(f"GATConv at Reddit scale: launches {counts}, "
                             f"expected {expected}")
    saved = G.GAT_SLOT_MIN_NNZ
    G.GAT_SLOT_MIN_NNZ = 1 << 62
    try:
        edge_out, edge_grads = layer()
    finally:
        G.GAT_SLOT_MIN_NNZ = saved
    e = max_err(slot_out, edge_out, 1e-4)
    g = _grad_close(torch, slot_grads, edge_grads, 1e-3, 1e-4)
    log(f"[attention] reddit GATConv {x.shape[1]}->4x16, slot route vs edge "
        f"route: forward max_abs_err {e:.3e}, gradients of proj, a_dst and "
        f"a_src max_abs_err {g:.3e}; slot route launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    del slot_grads, edge_grads, conv

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    def edge_heads(sd, ss, h):
        z = gather_rows(sd, st.coo_row()) + gather_rows(ss, st.col())
        alpha = edge_softmax(adj, F.leaky_relu(z, 0.2))
        return spmm_multihead(adj, alpha, h, "sum")

    def slot_heads(sd, ss, h):
        return torch.stack([gat_attention(
            adj, sd[:, i].contiguous(), ss[:, i].contiguous(),
            h[:, i].contiguous()) for i in range(h.shape[1])], 1)

    def edge_one(s_row, s_col, h):
        return _edge_space_attention(adj, s_row, s_col, h, 0.2)

    def slot_one(s_row, s_col, h):
        return gat_attention(adj, s_row, s_col, h)

    def chain(fn):
        return lambda d1, d2, h: fn(torch, adj, d1, d2, h)

    cases = []
    for feat in (16, 41):
        inp = [randn(m).requires_grad_(), randn(n).requires_grad_(),
               randn(n, feat).requires_grad_()]
        cases.append((f"one head F={feat}", slot_one, edge_one,
                      "_edge_space_attention", inp, randn(m, feat)))
    inp = [randn(m, 4).requires_grad_(), randn(n, 4).requires_grad_(),
           randn(n, 4, 16).requires_grad_()]
    cases.append(("four heads F=16", slot_heads, edge_heads,
                  "GATConv's edge branch (edge_softmax, spmm_multihead)", inp,
                  randn(m, 4, 16)))
    inp = [randn(m, 16).requires_grad_(), randn(n, 16).requires_grad_(),
           randn(n, 16).requires_grad_()]
    cases.append(("slot chain F=16", chain(_slot_chain), chain(_edge_chain),
                  "the edge-order chain (sddmm, edge_softmax, spmm)", inp,
                  randn(m, 16)))
    for label, slot, edge, edge_name, inp, cot in cases:
        with torch.no_grad():
            max_err(slot(*inp), edge(*inp), 1e-4)
        fns = {"slot": (slot, inp), "edge": (edge, inp),
               "slot_fwd_bwd": (functools.partial(_fwd_bwd, torch, slot, cot),
                                inp),
               "edge_fwd_bwd": (functools.partial(_fwd_bwd, torch, edge, cot),
                                inp)}
        ms = _time_turns(fns, warmup=1, iters=3)
        log(f"[numbers] gat_attention reddit {label} ({st.nnz} edges, fp32): "
            f"forward slot route {ms['slot']:.3f} ms, edge route "
            f"({edge_name}) {ms['edge']:.3f} ms; forward and backward slot "
            f"{ms['slot_fwd_bwd']:.3f} ms, edge {ms['edge_fwd_bwd']:.3f} ms")


def _visited_rows(torch, blocks, size, cuda):
    """Mask [size] of the rows in the given 128-blocks."""
    mask = torch.zeros(-(-size // 128), dtype=torch.bool, device=cuda)
    mask[blocks.long()] = True
    return mask.repeat_interleave(128)[:size]


def _bf16_blocks(torch, x, block, which):
    """Row blocks `which` of x [N, F] as bf16 [len(which), block, F], x
    padded with zero rows to whole blocks: the operand of `torch.bmm`."""
    nb = -(-x.shape[0] // block)
    xp = torch.zeros(nb * block, x.shape[1], dtype=torch.bfloat16,
                     device=x.device)
    xp[:x.shape[0]] = x
    return xp.view(nb, block, -1)[which.long()].contiguous()


def phase_bf16_hybrid(torch, cuda, graphs):
    """The hybrid tiers' bf16 compute mode (see the module docstring,
    phase 7b): the small JAX-frozen fixture; the bf16-cell kernel against
    its plain version; the slice's path at Reddit scale, counted; its
    times beside both modes, the bound and torch.bmm. Returns (times,
    errs, launches of the driven run)."""
    import numpy as np

    import dgsparse_tpu_torch as pt
    from dgsparse_tpu_torch.kernels import reset_launch_counts
    from dgsparse_tpu_torch.kernels import spmm_cells as C
    from dgsparse_tpu_torch.utils.testing import assert_sum_close, hybrid_csr

    t0 = time.perf_counter()
    bf16, seg = torch.bfloat16, pt.Algorithm.XLA_SEGMENT
    gen = torch.Generator(device=cuda).manual_seed(14)
    kernel_errs = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    def check(out, ref, abs_sum, tol):
        torch.cuda.synchronize()
        return assert_sum_close(out, ref, abs_sum, tol)

    def expect(what, counts, *parts):
        want = dict(_NONE)
        for n, part in parts:
            for k, v in part.items():
                want[k] += n * v
        if counts != want:
            raise AssertionError(f"{what}: launches {counts}, expected "
                                 f"{want}")

    # (1) the JAX-frozen fixture: spmm of a bf16 x, SUM and MEAN, forward
    # and d_dense, on the visited rows / columns (JAX leaves the others
    # NaN); gat_attention(compute_dtype=bfloat16) on attention_small's
    # graph; both at 1e-2 of the terms' absolute sum, with exact launches
    with np.load(BF16_FIXTURE) as f:
        fx = dict(f)
    n, feat = fx["x"].shape
    sp = pt.SparseTensor.from_csr(fx["rowptr"], fx["col"],
                                  torch.from_numpy(fx["vals"]),
                                  sparse_sizes=(n, n), device=cuda)
    hp = sp.storage.ell_plan()
    rows = _visited_rows(torch, hp.cells.cell_rb, n, cuda)
    cols = _visited_rows(torch, hp.cells.cell_cw, n, cuda)
    a_abs = sp.set_values(sp.storage.values().abs())
    ct = torch.from_numpy(fx["ct"]).to(cuda)
    worst = []
    for reduce in ("sum", "mean"):
        xb = torch.from_numpy(fx["x"]).to(cuda).to(bf16).requires_grad_()
        reset_launch_counts()
        out = pt.spmm(sp, xb, reduce)
        (out.float() * ct).sum().backward()
        expect(f"fixture spmm {reduce}", _counts(), (1, SPMM_LAUNCHES_BF16))
        z = torch.zeros(n, feat, device=cuda, requires_grad=True)
        (pt.spmm(a_abs, z, reduce, seg) * ct.abs()).sum().backward()
        fwd_abs = pt.spmm(a_abs, xb.detach().float().abs(), reduce, seg)
        ref = torch.from_numpy(fx[f"spmm/{reduce}/out"]).to(cuda)
        ref_dx = torch.from_numpy(fx[f"spmm/{reduce}/d_x"]).to(cuda)
        worst.append(check(out.detach()[rows], ref[rows], fwd_abs[rows],
                           1e-2))
        worst.append(check(xb.grad[cols], ref_dx[cols], z.grad[cols], 1e-2))
    with np.load(ATTENTION_FIXTURE) as f:
        fa = dict(f)
    asp = pt.SparseTensor.from_csr(fa["rowptr"], fa["col"], None,
                                   sparse_sizes=(n, n), device=cuda)
    inputs = [torch.from_numpy(fa[k]).to(cuda).requires_grad_()
              for k in ("s_row", "s_col", "x")]
    act = torch.from_numpy(fa["ct"]).to(cuda)

    def attend():
        out = pt.gat_attention(asp, *inputs, compute_dtype=bf16)
        return out.detach(), torch.autograd.grad(out, inputs, act)

    with plain_kernels():
        ref, ref_grads = attend()
    reset_launch_counts()
    out, grads = attend()
    expect("fixture gat_attention", _counts(), (1, ATTENTION_LAUNCHES_BF16))
    abs_sum = pt.gat_attention(asp, inputs[0].detach(), inputs[1].detach(),
                               inputs[2].detach().abs())
    e_jax = check(out, torch.from_numpy(fx["attn/out"]).to(cuda), abs_sum,
                  1e-2)
    e_plain = check(out, ref, abs_sum, 1e-2)
    g_plain = _grad_close(torch, grads, ref_grads, 1e-2, 1e-2)
    log(f"[bf16] fixture ({n} nodes, F={feat}), bf16 compute mode: spmm "
        f"sum/mean of a bf16 x vs the JAX package's PALLAS_ROW_TILE, forward "
        f"and d_dense on the visited rows / columns, max_abs_err "
        f"{max(worst):.3e} (1e-2 of the terms' absolute sum); "
        f"gat_attention(compute_dtype=bfloat16) vs JAX's {e_jax:.3e}, vs the "
        f"plain versions forward {e_plain:.3e}, gradients {g_plain:.3e} "
        f"(1e-2); launches exact")

    # (2) the bf16-cell kernel against its plain version (the same bf16
    # operands, products exact in float32) at 1e-5 of the terms' absolute
    # sum, bitwise equal to a second call: a small clustered graph with a
    # row block without a cell (F in HYBRID_FEATS), then Reddit scale
    def kernel_cases(tag, st, feats):
        plan = st.ell_plan().cells
        twin = st.tier_values(compute_dtype=bf16)["cells_bf16"]
        worst = []
        for f in feats:
            for transpose in (False, True):
                x = randn(plan.num_rows if transpose else plan.num_cols,
                          f).to(bf16)
                args = (plan, twin, x, transpose, bf16)
                out = C.spmm_dense_cells_cuda(*args)
                abs_sum = C.spmm_dense_cells_plain(
                    plan, twin.float().abs(), x.float().abs(), transpose)
                kernel_errs.append(check(out, C.spmm_dense_cells_plain(*args),
                                         abs_sum, TOL["float32"]))
                worst.append(kernel_errs[-1])
                if not torch.equal(out, C.spmm_dense_cells_cuda(*args)):
                    raise AssertionError(f"bf16 cells {tag} F={f}: a second "
                                         "call differs")
        log(f"[bf16] spmm_dense_cells bf16-cell variant vs its plain version"
            f", {tag}, F in {feats}, forward and transpose: max_abs_err "
            f"{max(worst):.3e} (1e-5 of the terms' absolute sum), bitwise "
            f"repeatable")

    rowptr, col, vals = hybrid_csr()
    m = len(rowptr) - 1
    small = pt.SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                                     sparse_sizes=(m, m), device=cuda)
    # ... and sddmm_cells_bf16_kernel (bf16 d1, d2; exact products) against
    # its plain version at 1e-5 of the terms' absolute sum, bitwise equal
    # to a second call
    sddmm_errs = []

    def sddmm_cases(tag, st, feats):
        plan = st.ell_plan().cells
        worst = []
        for f in feats:
            d1 = randn(plan.num_rows, f).to(bf16)
            d2 = randn(plan.num_cols, f).to(bf16)
            out = C.sddmm_cells_cuda(plan, d1, d2)
            abs_sum = C.sddmm_cells_plain(plan, d1.float().abs(),
                                          d2.float().abs())
            sddmm_errs.append(check(out, C.sddmm_cells_plain(plan, d1, d2),
                                    abs_sum, TOL["float32"]))
            worst.append(sddmm_errs[-1])
            if not torch.equal(out, C.sddmm_cells_cuda(plan, d1, d2)):
                raise AssertionError(f"bf16 sddmm_cells {tag} F={f}: a "
                                     "second call differs")
            del out, abs_sum
        log(f"[bf16] sddmm_cells bf16 kernel vs its plain version, {tag}, F "
            f"in {feats}: max_abs_err {max(worst):.3e} (1e-5 of the terms' "
            f"absolute sum), bitwise repeatable")

    kernel_cases("small clustered graph", small.storage, HYBRID_FEATS)
    sddmm_cases("small clustered graph", small.storage, HYBRID_FEATS)
    adj, _, _ = graphs["reddit"]
    st = adj.storage
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tiers = st.tier_values(compute_dtype=bf16)
    torch.cuda.synchronize()
    twin_bytes = tiers["cells_bf16"].untyped_storage().nbytes()
    log(f"[bf16] reddit: the bf16 twin of {st.ell_plan().cells.num_cells} "
        f"cells holds {twin_bytes} B (fp32 blocks "
        f"{tiers['cells'].untyped_storage().nbytes()} B); allocated "
        f"{torch.cuda.memory_allocated() - before} B more, "
        f"{torch.cuda.memory_allocated()} B resident")
    kernel_cases("reddit", st, REDDIT_FEATS)
    sddmm_cases("reddit", st, REDDIT_FEATS)

    # (3) the slice's path at Reddit scale, counted: spmm forward + d_dense
    # at F = 64 and 41 with an fp32 and a bf16 x, gat_attention forward +
    # backward one head at F = 16 and 41 in both modes, sddmm of bf16 d1
    # and d2 at F = 64 and 41
    m, n = st.num_rows, st.num_cols
    a_abs = adj.set_values(st.values().abs())

    def spmm_step(x, ct):
        xt = x.detach().requires_grad_()
        out = pt.spmm(adj, xt)
        return out.detach(), torch.autograd.grad(out, xt, ct)[0]

    def attention_step(inputs, ct, cd):
        out = pt.gat_attention(adj, *inputs, compute_dtype=cd)
        return out.detach(), torch.autograd.grad(out, inputs, ct)

    spmm_cases = {f: (randn(n, f), randn(m, f)) for f in REDDIT_FEATS}
    attn_cases = {f: ([randn(m).requires_grad_(), randn(n).requires_grad_(),
                       randn(n, f).requires_grad_()], randn(m, f))
                  for f in ATTENTION_FEATS}
    sddmm_operands = {f: (randn(m, f).to(bf16), randn(n, f).to(bf16))
                      for f in REDDIT_FEATS}
    torch.cuda.synchronize()
    reset_launch_counts()
    runs = {}
    for f, (x, ct) in spmm_cases.items():
        for dt in (torch.float32, bf16):
            runs["spmm", f, dt] = spmm_step(x.to(dt), ct.to(dt))
    for f, (inputs, ct) in attn_cases.items():
        for cd in (torch.float32, bf16):
            runs["attention", f, cd] = attention_step(inputs, ct, cd)
    for f, (d1b, d2b) in sddmm_operands.items():
        runs["sddmm", f] = pt.sddmm(adj, d1b, d2b)
    torch.cuda.synchronize()
    launches = _counts()
    k = len(REDDIT_FEATS)
    j = len(ATTENTION_FEATS)
    expect("the bf16 path", launches, (k, SPMM_LAUNCHES),
           (k, SPMM_LAUNCHES_BF16), (j, ATTENTION_LAUNCHES),
           (j, ATTENTION_LAUNCHES_BF16), (k, SDDMM_LAUNCHES_BF16))
    for f, (x, ct) in spmm_cases.items():
        (o32, g32), (o16, g16) = (runs["spmm", f, dt]
                                  for dt in (torch.float32, bf16))
        if o16.dtype != bf16 or g16.dtype != bf16 or \
                not (torch.isfinite(o16).all() and torch.isfinite(g16).all()):
            raise AssertionError(f"bf16 spmm F={f}: {o16.dtype} output")
        e = check(o16, o32, pt.spmm(a_abs, x.abs(), "sum", seg), 1e-2)
        e = max(e, check(g16, g32, pt.spmm(a_abs.t(), ct.abs(), "sum", seg),
                         1e-2))
        log(f"[bf16] reddit spmm F={f}, bf16 x vs fp32 x, forward and "
            f"d_dense: max_abs_err {e:.3e} (1e-2 of the terms' absolute "
            f"sum)")
    for f, (inputs, ct) in attn_cases.items():
        (o32, g32), (o16, g16) = (runs["attention", f, cd]
                                  for cd in (torch.float32, bf16))
        abs_sum = pt.gat_attention(adj, inputs[0].detach(),
                                   inputs[1].detach(), inputs[2].detach().abs())
        e = check(o16, o32, abs_sum, 1e-2)
        g = _grad_close(torch, g16, g32, 1e-2, 1e-2)
        log(f"[bf16] reddit gat_attention one head F={f}, bf16 mode vs fp32 "
            f"mode: forward max_abs_err {e:.3e} (1e-2 of the terms' "
            f"absolute sum), gradients {g:.3e} (1e-2 of the largest)")
    for f, (d1b, d2b) in sddmm_operands.items():
        out = runs["sddmm", f]
        if out.dtype != bf16 or out.shape != (st.nnz,) or \
                not torch.isfinite(out).all():
            raise AssertionError(f"bf16 sddmm F={f}: {out.dtype} "
                                 f"{tuple(out.shape)} output")
        # the same products in float32 (bf16 values are exact there): the
        # bf16 result differs by its output rounding
        e = check(out, pt.sddmm(adj, d1b.float(), d2b.float()),
                  pt.sddmm(adj, d1b.float().abs(), d2b.float().abs()), 1e-2)
        log(f"[bf16] reddit sddmm F={f} of bf16 d1, d2 ({st.nnz} edges, "
            f"bf16 out) vs the same values in float32: max_abs_err {e:.3e} "
            f"(1e-2 of the terms' absolute sum)")
    log(f"[bf16] the path's launches: "
        f"{ {k: v for k, v in launches.items() if v} }")
    del runs

    # (4) times (CUDA events, best of two turns): the bf16-cell kernel
    # beside the fp32-mode kernel, its plain version and torch.bmm over
    # the bf16 blocks; sddmm_cells' bf16 kernel beside the fp32-mode
    # kernel, its plain version and torch.bmm with fp32 and bf16 out; the
    # path's ops in both modes, with their peak memory
    hp = st.ell_plan()
    plan, twin, cells = hp.cells, tiers["cells_bf16"], tiers["cells"]
    cell_flops = 2.0 * plan.num_cells * 128 * 128
    results = {"spmm_dense_cells_bf16": {}, "sddmm_cells_bf16": {}}
    for f in REDDIT_FEATS:
        for transpose in (False, True):
            inp = randn(m if transpose else n, f)
            xb = inp.to(bf16)
            blk = _bf16_blocks(torch, xb, 128,
                               plan.cell_rb if transpose else plan.cell_cw)
            a = twin.transpose(1, 2) if transpose else twin
            ms = _time_turns({
                "kernel": (C.spmm_dense_cells_cuda,
                           (plan, twin, xb, transpose, bf16)),
                "fp32_mode": (C.spmm_dense_cells_cuda,
                              (plan, cells, inp, transpose)),
                "plain": (C.spmm_dense_cells_plain,
                          (plan, twin, xb, transpose, bf16)),
                "library": (torch.bmm, (a, blk))})
            out_rows = n if transpose else m
            ms.update(bound(2 * (twin.numel() + xb.numel())
                            + 4 * out_rows * f, cell_flops * f, BF16_FLOPS))
            ms["library_call"] = ("torch.bmm(bf16 cells, gathered bf16 "
                                  "window blocks), bf16 out")
            label = f"reddit {'transpose' if transpose else 'forward'} F={f}"
            results["spmm_dense_cells_bf16"][label] = ms
            log(f"[numbers] spmm_dense_cells bf16 cells {label}: kernel "
                f"{ms['kernel'] * 1e3:.2f} us, fp32-mode kernel "
                f"{ms['fp32_mode'] * 1e3:.2f} us, plain {ms['plain'] * 1e3:.2f}"
                f" us, torch.bmm {ms['library'] * 1e3:.2f} us, bound "
                f"{ms['bound'] * 1e3:.2f} us ({ms['bound_by']}, "
                f"{ms['bound_rate']}); {ms['bound'] / ms['kernel']:.3f} of "
                f"the bound")
        d1, d2 = randn(m, f), randn(n, f)
        d1b, d2b = d1.to(bf16), d2.to(bf16)
        a = _bf16_blocks(torch, d1b, 128, plan.cell_rb)
        b = _bf16_blocks(torch, d2b, 128, plan.cell_cw).transpose(1, 2)
        fns = {
            "kernel": (C.sddmm_cells_cuda, (plan, d1b, d2b, bf16)),
            "kernel_with_cast": (C.sddmm_cells_cuda, (plan, d1, d2, bf16)),
            "fp32_mode": (C.sddmm_cells_cuda, (plan, d1, d2)),
            "plain": (C.sddmm_cells_plain, (plan, d1b, d2b, bf16)),
            "library_bf16_out": (torch.bmm, (a, b)),
            # the card's rate for the store alone: the blocks' bytes zeroed
            "write_only": (torch.Tensor.zero_, (
                torch.empty(plan.cell_slots, device=cuda),))}
        # the same function, fp32 blocks from bf16 operands: bmm's
        # out_dtype overload (aten::bmm.dtype), held to the kernel
        call = ("torch.bmm(gathered bf16 d1 blocks, gathered bf16 d2 "
                "blocksᵀ, out_dtype=torch.float32)")
        try:
            lib_out = torch.bmm(a, b, out_dtype=torch.float32)
        except (RuntimeError, TypeError) as exc:
            log(f"[numbers] {call} refused ({str(exc).splitlines()[0]}); "
                f"the library call is the bf16-out bmm, half the store")
            fns["library"] = fns.pop("library_bf16_out")
            call = ("torch.bmm(gathered bf16 d1 blocks, gathered bf16 d2 "
                    "blocksᵀ), bf16 out (out_dtype refused)")
        else:
            e = check(lib_out.reshape(-1), C.sddmm_cells_cuda(plan, d1b, d2b),
                      C.sddmm_cells_cuda(plan, d1b.abs(), d2b.abs()), 1e-4)
            log(f"[numbers] {call} vs the kernel: max_abs_err {e:.3e} (1e-4 "
                f"of the terms' absolute sum)")
            del lib_out
            fns["library"] = (functools.partial(
                torch.bmm, out_dtype=torch.float32), (a, b))
        ms = _time_turns(fns)
        ms.update(bound(2 * (d1.numel() + d2.numel()) + 4 * plan.cell_slots,
                        cell_flops * f, BF16_FLOPS))
        ms["library_call"] = call
        results["sddmm_cells_bf16"][f"reddit F={f}"] = ms
        bf16_out = ms.get("library_bf16_out")
        log(f"[numbers] sddmm_cells bf16 mode reddit F={f}: kernel on bf16 "
            f"d1, d2 {ms['kernel'] * 1e3:.2f} us (with the cast from fp32 "
            f"{ms['kernel_with_cast'] * 1e3:.2f}), fp32 mode "
            f"{ms['fp32_mode'] * 1e3:.2f} us, plain "
            f"{ms['plain'] * 1e3:.2f} us, {call} {ms['library'] * 1e3:.2f} us"
            + ("" if bf16_out is None else
               f", torch.bmm with bf16 out {bf16_out * 1e3:.2f} us")
            + f", bound {ms['bound'] * 1e3:.2f} us ({ms['bound_by']}); "
            f"{ms['bound'] / ms['kernel']:.3f} of the bound; the blocks' "
            f"{4 * plan.cell_slots} B zeroed (zero_, the store alone) "
            f"{ms['write_only'] * 1e3:.2f} us")
        del a, b
    for f, (x, ct) in spmm_cases.items():
        fns = {dt: (spmm_step, (x.to(dt), ct.to(dt)))
               for dt in (torch.float32, bf16)}
        ms = _time_turns(fns, warmup=2, iters=10)
        peak = {}
        for dt, (fn, args) in fns.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn(*args)
            torch.cuda.synchronize()
            peak[dt] = torch.cuda.max_memory_allocated() - base
        log(f"[numbers] reddit spmm F={f} forward + d_dense: fp32 x "
            f"{ms[torch.float32]:.3f} ms, bf16 x (bf16 mode) "
            f"{ms[bf16]:.3f} ms; peak above resident {peak[torch.float32]} / "
            f"{peak[bf16]} B")
    for f, (inputs, ct) in attn_cases.items():
        fns = {cd: (attention_step, (inputs, ct, cd))
               for cd in (torch.float32, bf16)}
        ms = _time_turns(fns, warmup=1, iters=3)
        peak = {}
        for cd, (fn, args) in fns.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn(*args)
            torch.cuda.synchronize()
            peak[cd] = torch.cuda.max_memory_allocated() - base
        log(f"[numbers] reddit gat_attention one head F={f} forward + "
            f"backward: fp32 mode {ms[torch.float32]:.3f} ms, bf16 mode "
            f"{ms[bf16]:.3f} ms; peak above resident {peak[torch.float32]} "
            f"/ {peak[bf16]} B")
    log(f"[bf16] phase {time.perf_counter() - t0:.1f} s")
    # the variants compute in the bf16 mode only: each one's error, against
    # its plain version, under both keys
    errs = {name: dict.fromkeys(("float32", "bfloat16"), max(e))
            for name, e in (("spmm_dense_cells_bf16", kernel_errs),
                            ("sddmm_cells_bf16", sddmm_errs))}
    return results, errs, launches


def _gspmm_name(reduce, compute):
    if compute == "copy_u":
        return f"copy_u_{reduce}"
    return f"u_{compute}_e_{reduce}"


def _gspmm_launches(compute, backward, bf16=False):
    """The exact launches of one SUM/MEAN gspmm on a hybrid storage, over
    KERNEL_NAMES (segment_sum_csr: DIV's per-call tier build)."""
    want = {**_NONE, "segment_sum_csr": int(compute == "div")}
    for part in (GSPMM_FORWARD, GSPMM_BACKWARD if backward else {}):
        for k, v in part.items():
            want[k] += v
    if backward and compute in ("mul", "div"):
        want["sddmm_csr"] += 1
    if bf16:
        want["spmm_dense_cells_bf16"] = want["spmm_dense_cells"]
        want["spmm_dense_cells"] = 0
    return want


def phase_gspmm_hybrid(torch, cuda, reddit):
    """SUM/MEAN gspmm on the Reddit-scale hybrid storage (phase 7c): every
    op of the grid at F = 64 and 41, forward and with the backward, with
    exact launches a call; against the CSR route; its times beside the CSR
    route, cuSPARSE and DIV's tier build; peak memory. Returns the
    launches of the driven runs."""
    import dgsparse_tpu_torch as pt
    from dgsparse_tpu_torch.core import planner
    from dgsparse_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dgsparse_tpu_torch.ops import gspmm as G
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    t0 = time.perf_counter()
    st = reddit.storage
    hp, m, n = st.ell_plan(), st.num_rows, st.num_cols
    gen = torch.Generator(device=cuda).manual_seed(16)
    # the CSR route: the same storage without its plan, every tensor
    # shared (`build_plans=False` would sort 114 M edges again)
    csr = pt.SparseTensor._wrap(st._replace(
        hybrid=None, tier_vals=None, tier_ones=None, tier_key=None,
        slot_maps=None), True)

    def launched(before):
        now = launch_counts()
        return {k: now[k] - before[k] for k in KERNEL_NAMES}

    def forward(sp, x, reduce, compute):
        return getattr(G, _gspmm_name(reduce, compute))(sp, x)

    def fwd_bwd(sp, v, x, ct, reduce, compute):
        xt = x.detach().requires_grad_()
        out = getattr(G, _gspmm_name(reduce, compute))(sp, xt)
        inputs = [xt] if compute == "copy_u" else [xt, v]
        return (out.detach(),) + torch.autograd.grad(out, inputs, ct)

    def check(got, ref, abs_sum, tol):
        torch.cuda.synchronize()
        return assert_sum_close(got, ref, abs_sum, tol)

    # the ones' tiers (ADD, SUB, copy_u) and the tiers of a values tensor
    # that requires grad, built before any count
    tb = time.perf_counter()
    ones = st.tier_values(ones=True)
    torch.cuda.synchronize()
    log(f"[gspmm] reddit ({m} nodes, {st.nnz} nnz, "
        f"{hp.cells.num_cells} cells): the ones' tiers hold "
        f"{_device_bytes(ones)} B on the card, ready in "
        f"{time.perf_counter() - tb:.2f} s (built on the host here, or "
        f"kept from an earlier phase)")
    v = st.values().detach().requires_grad_()
    hg, cg = reddit.set_values(v), csr.set_values(v)
    hg.storage.tier_values()
    va = st.values().abs().requires_grad_()
    ca = csr.set_values(va)

    path = dict.fromkeys(KERNEL_NAMES, 0)
    worst = {}
    for f in REDDIT_FEATS:
        x = torch.randn(n, f, generator=gen, device=cuda)
        ct = torch.randn(m, f, generator=gen, device=cuda)
        # (1) the driven run, counted: each op forward, then forward +
        # backward, its launches exact a call
        torch.cuda.synchronize()
        reset_launch_counts()
        runs = {}
        for reduce in ("sum", "mean"):
            for compute in GSPMM_COMPUTES:
                before = launch_counts()
                forward(reddit, x, reduce, compute)
                got = launched(before)
                before = launch_counts()
                runs[reduce, compute] = fwd_bwd(hg, v, x, ct, reduce, compute)
                got_bwd = launched(before)
                for what, counts, want in (
                        ("forward", got, _gspmm_launches(compute, False)),
                        ("forward + backward", got_bwd,
                         _gspmm_launches(compute, True))):
                    if counts != want:
                        raise AssertionError(
                            f"gspmm {_gspmm_name(reduce, compute)} F={f} "
                            f"{what}: launches {counts}, expected {want}")
        if f == 64:         # a bf16 dense: the tiers' bf16 compute mode
            before = launch_counts()
            forward(reddit, x.to(torch.bfloat16), "sum", "mul")
            got = launched(before)
            before = launch_counts()
            bf = fwd_bwd(hg, v, x.to(torch.bfloat16),
                         ct.to(torch.bfloat16), "sum", "mul")
            got_bwd = launched(before)
            if got != _gspmm_launches("mul", False, True) or \
                    got_bwd != _gspmm_launches("mul", True, True):
                raise AssertionError(f"gspmm bf16 mul F={f}: launches "
                                     f"{got} / {got_bwd}")
        torch.cuda.synchronize()
        counts = launch_counts()
        for k in KERNEL_NAMES:
            path[k] += counts[k]
        # (2) against the CSR route at 1e-5 of the terms' absolute sum
        # (the CSR route on |v|, |x|, |ct|, SUB as ADD); MUL bitwise
        # equal to spmm on the hybrid storage
        for (reduce, compute), got in list(runs.items()):
            ref = fwd_bwd(cg, v, x, ct, reduce, compute)
            sums = fwd_bwd(ca, va, x.abs(), ct.abs(), reduce,
                           "add" if compute == "sub" else compute)
            for i, what in enumerate(("out", "d_dense", "d_values")[
                    :len(got)]):
                if not torch.isfinite(got[i]).all():
                    raise AssertionError(f"gspmm {reduce} {compute} F={f}: "
                                         f"{what} not finite")
                e = check(got[i], ref[i], sums[i].abs(), TOL["float32"])
                worst[what] = max(worst.get(what, 0.0), e)
            del runs[reduce, compute]
        if not torch.equal(pt.gspmm(reddit, x, "sum", "mul"),
                           pt.spmm(reddit, x, "sum")) or not torch.equal(
                pt.gspmm(reddit, x, "mean", "mul"),
                pt.spmm(reddit, x, "mean")):
            raise AssertionError(f"gspmm mul F={f} is not spmm bitwise")
        if f == 64:
            ref = fwd_bwd(hg, v, x, ct, "sum", "mul")
            sums = fwd_bwd(ca, va, x.abs(), ct.abs(), "sum", "mul")
            if bf[0].dtype != torch.bfloat16 or bf[1].dtype != torch.bfloat16:
                raise AssertionError(f"gspmm bf16: {bf[0].dtype} output")
            e16 = max(check(bf[i], ref[i], sums[i].abs(), 1e-2)
                      for i in range(3))
            log(f"[gspmm] reddit u_mul_e_sum F={f}, bf16 x vs fp32 x, "
                f"forward, d_dense, d_values: max_abs_err {e16:.3e} (1e-2 "
                f"of the terms' absolute sum)")
            del ref, sums, bf
        # (3) times: each op's forward and forward + backward on both
        # routes (CUDA events, best of two turns of 3 after 1); cuSPARSE
        # over the full CSR for MUL
        full = torch.sparse_csr_tensor(st.rowptr(), st.col(), st.values(),
                                       size=(m, n))
        for reduce in ("sum", "mean"):
            for compute in GSPMM_COMPUTES:
                kw = dict(reduce=reduce, compute=compute)
                fns = {
                    "hybrid": (functools.partial(forward, reddit, **kw),
                               (x,)),
                    "csr": (functools.partial(forward, csr, **kw), (x,)),
                    "hybrid_bwd": (functools.partial(fwd_bwd, hg, **kw),
                                   (v, x, ct)),
                    "csr_bwd": (functools.partial(fwd_bwd, cg, **kw),
                                (v, x, ct))}
                if reduce == "sum" and compute == "mul":
                    fns["library"] = (torch.matmul, (full, x))
                ms = _time_turns(fns, warmup=1, iters=3)
                label = f"{_gspmm_name(reduce, compute)} F={f}"
                log(f"[numbers] gspmm reddit {label}: forward hybrid "
                    f"{ms['hybrid']:.3f} ms, CSR {ms['csr']:.3f} ms "
                    f"({ms['csr'] / ms['hybrid']:.2f}x); forward + backward "
                    f"hybrid {ms['hybrid_bwd']:.3f} ms, CSR "
                    f"{ms['csr_bwd']:.3f} ms "
                    f"({ms['csr_bwd'] / ms['hybrid_bwd']:.2f}x)"
                    + (f"; cuSPARSE {ms['library']:.3f} ms"
                       if "library" in ms else ""))
        # DIV's tier build alone (1/v into the cells, BELL, residue and
        # non-cell CSC), and the same with the gathers' edge ids uploaded
        # from the host on each call, as tier_values did before it kept
        # them on the card
        def build_uploading_ids(w):
            hp.__dict__.pop("_tier_ids", None)
            return planner.tier_values(hp, w, cuda)

        recip = 1.0 / st.values()
        ms = _time_turns({
            "build": (lambda w: planner.tier_values(hp, w, cuda), (recip,)),
            "uploading_ids": (build_uploading_ids, (recip,))},
            warmup=1, iters=3)
        log(f"[numbers] gspmm reddit F={f}: DIV's tier build alone (1/v "
            f"into the cells, BELL, residue and non-cell CSC) "
            f"{ms['build']:.3f} ms; uploading its edge ids on each call "
            f"{ms['uploading_ids']:.3f} ms")
        if f == 64:
            peak = {}
            for compute in ("mul", "add", "div"):
                for route, sp in (("hybrid", reddit), ("csr", csr)):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    out = forward(sp, x, "sum", compute)
                    torch.cuda.synchronize()
                    peak[compute, route] = \
                        torch.cuda.max_memory_allocated() - base
                    del out
            log(f"[numbers] gspmm reddit F={f} forward, peak above resident "
                f"(hybrid / CSR route): " + ", ".join(
                    f"{c} {peak[c, 'hybrid']} / {peak[c, 'csr']} B"
                    for c in ("mul", "add", "div")))
    log(f"[gspmm] reddit, every SUM/MEAN op of the grid on the hybrid tiers "
        f"at F in {REDDIT_FEATS}: vs the CSR route max_abs_err "
        f"{ {k: f'{e:.3e}' for k, e in worst.items()} } (1e-5 of the terms' "
        f"absolute sum); u_mul_e_sum and u_mul_e_mean bitwise equal to "
        f"spmm; launches exact a call; DIV's tier builds "
        f"(segment_sum_csr) {path['segment_sum_csr']}; the path's launches "
        f"{ {k: c for k, c in path.items() if c} }")
    log(f"[gspmm] phase {time.perf_counter() - t0:.1f} s")
    return path


def _grid(torch, feats, coords, shape):
    """feats [n, C] at the voxels `coords` (batch 0) of a dense
    [1, C, X, Y, Z] float32 grid, zero elsewhere."""
    c = torch.from_numpy(coords).to(feats.device).long()
    grid = torch.zeros(1, feats.shape[1], *shape, device=feats.device)
    grid[0][:, c[:, 1], c[:, 2], c[:, 3]] = feats.t()
    return grid


def _sites(torch, grid, coords):
    """The rows [n, C] of a dense [1, C, X, Y, Z] grid at `coords`."""
    c = torch.from_numpy(coords).to(grid.device).long()
    return grid[0][:, c[:, 1], c[:, 2], c[:, 3]].t()


def phase_spconv_numbers(torch, cuda, cloud):
    """CUDA-event times (fp32, best of two turns) on the 60,000-voxel cloud
    of spconv_pairs forward (pairs by output, W) and dX (pairs by input,
    Wᵀ) and of spconv_dw, beside their plain versions, their bounds and
    the dense cuDNN convolution over the densified grid (TF32 off): conv3d
    (conv_transpose3d for the inverse conv) for the forward, aten's
    convolution_backward for the input or the weight gradient alone (what
    torch.nn.grad.conv3d_input / conv3d_weight call). Each dense result,
    read at the active sites, is held to the kernel's at 1e-4 (scaled by
    the terms' absolute sum), with the center tap of a submanifold conv
    added to the kernel's side as `ops/spconv.py` adds it. Shapes:
    bench_spconv's SubM at 32->32 and 64->64 and the four convs of
    "unet-60k"."""
    from torch.nn import functional as F

    from dgsparse_tpu_torch.kernels import spconv as K
    from dgsparse_tpu_torch.nn import PointCloudUNet
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    st = cloud[0]
    unet = PointCloudUNet()
    plans = unet.plans(st)
    coarse = unet.down1.output_sites(st)
    fine_sites = (st.coords, st.spatial_shape)
    coarse_sites = (coarse.coords, coarse.spatial_shape)
    gen = torch.Generator(device=cuda).manual_seed(7)
    results = {"spconv_pairs": {}, "spconv_dw": {}}
    # label: (plan, c_in, c_out, input sites, output sites, stride,
    # transposed)
    layers = {
        "bench_spconv SubM 32->32": (plans["enc1"], 32, 32, fine_sites,
                                     fine_sites, 1, False),
        "bench_spconv SubM 64->64": (plans["enc1"], 64, 64, fine_sites,
                                     fine_sites, 1, False),
        "unet-60k enc1 SubM 8->32": (plans["enc1"], 8, 32, fine_sites,
                                     fine_sites, 1, False),
        "unet-60k down1 stride 2 32->64": (plans["down1"], 32, 64,
                                           fine_sites, coarse_sites, 2,
                                           False),
        "unet-60k enc2 SubM 64->64": (plans["enc2"], 64, 64, coarse_sites,
                                      coarse_sites, 1, False),
        "unet-60k up1 inverse 64->32": (plans["up1"], 64, 32, coarse_sites,
                                        fine_sites, 2, True),
    }
    counts = dict(warmup=3, iters=20)
    for label, (plan, c_in, c_out, sin, sout, stride, transposed) in \
            layers.items():
        mid = (plan.k_vol - 1) // 2
        x = torch.randn(plan.num_in, c_in, generator=gen, device=cuda)
        g = torch.randn(plan.num_out, c_out, generator=gen, device=cuda)
        w = torch.randn(plan.k_vol, c_in, c_out, generator=gen,
                        device=cuda) * 0.1
        wt = w.transpose(1, 2).contiguous()
        # the dense weight: [c_out, c_in, 3, 3, 3] for conv3d; for the
        # inverse conv the mirrored offsets as conv_transpose3d's [c_in,
        # c_out, 3, 3, 3]
        w5 = w.view(3, 3, 3, c_in, c_out)
        dense_w = (w5.flip(0, 1, 2).permute(3, 4, 0, 1, 2) if transposed
                   else w5.permute(4, 3, 0, 1, 2)).contiguous()
        x_grid = _grid(torch, x, sin[0], sin[1])
        g_grid = _grid(torch, g, sout[0], sout[1])
        out_pad = [o - (2 * i - 1) for o, i in zip(sout[1], sin[1])] \
            if transposed else [0, 0, 0]

        def dense_fwd(x_grid, dense_w):
            if transposed:
                return F.conv_transpose3d(x_grid, dense_w, stride=stride,
                                          padding=1,
                                          output_padding=out_pad)
            return F.conv3d(x_grid, dense_w, stride=stride, padding=1)

        def dense_bwd(g_grid, x_grid, dense_w, mask):
            return torch.ops.aten.convolution_backward(
                g_grid, x_grid, dense_w, None, [stride] * 3, [1] * 3,
                [1] * 3, transposed, out_pad, 1, mask)

        def center(a, b):
            return a @ b if plan.separate_mid else 0

        # the kernels' results, the center tap added, and the dense ones
        fwd = K.spconv_pairs_cuda(plan.by_out, x, w) + center(x, w[mid])
        fwd_abs = K.spconv_pairs_plain(plan.by_out, x.abs(), w.abs()) \
            + center(x.abs(), w[mid].abs())
        dx = K.spconv_pairs_cuda(plan.by_in, g, wt) + center(g, w[mid].T)
        dx_abs = K.spconv_pairs_plain(plan.by_in, g.abs(), wt.abs()) \
            + center(g.abs(), w[mid].T.abs())
        dw = K.spconv_dw_cuda(plan.by_offset, x, g)
        dw_abs = K.spconv_dw_plain(plan.by_offset, x.abs(), g.abs())
        if plan.separate_mid:
            dw[mid] += x.T @ g
            dw_abs[mid] += x.abs().T @ g.abs()
        lib_dw = dense_bwd(g_grid, x_grid, dense_w, [False, True, False])[1]
        lib_dw = (lib_dw.flip(2, 3, 4).permute(2, 3, 4, 0, 1) if transposed
                  else lib_dw.permute(2, 3, 4, 1, 0)).reshape(dw.shape)
        errs = [
            assert_sum_close(_sites(torch, dense_fwd(x_grid, dense_w),
                                    sout[0]), fwd, fwd_abs, 1e-4),
            assert_sum_close(_sites(torch, dense_bwd(
                g_grid, x_grid, dense_w, [True, False, False])[0], sin[0]),
                dx, dx_abs, 1e-4),
            assert_sum_close(lib_dw, dw, dw_abs, 1e-4)]

        pairs_ops = 2.0 * plan.total_pairs * c_in * c_out
        # x or g, the weights, ptr, src and widx, and the float32 output
        for direction, pairs, src, wk, grid, lib in (
                ("forward", plan.by_out, x, w, x_grid,
                 (dense_fwd, (x_grid, dense_w))),
                ("dX", plan.by_in, g, wt, g_grid,
                 (dense_bwd, (g_grid, x_grid, dense_w,
                              [True, False, False])))):
            ms = _time_turns({
                "kernel": (K.spconv_pairs_cuda, (pairs, src, wk)),
                "plain": (K.spconv_pairs_plain, (pairs, src, wk)),
                "library": lib}, **counts)
            ms.update(bound(
                4 * (src.numel() + wk.numel() + pairs.num_rows + 1
                     + 2 * pairs.num_pairs + pairs.num_rows * wk.shape[2]),
                pairs_ops, TF32X3_FLOPS))
            ms["library_call"] = (
                ("torch.nn.functional.conv_transpose3d" if transposed
                 else "torch.nn.functional.conv3d")
                if direction == "forward" else
                "torch.ops.aten.convolution_backward (input gradient)"
            ) + " over the densified grid, cuDNN, TF32 off"
            results["spconv_pairs"][f"{label} {direction}"] = ms
        # x, g, the pair ids and chunk bounds, and dW
        ms = _time_turns({
            "kernel": (K.spconv_dw_cuda, (plan.by_offset, x, g)),
            "plain": (K.spconv_dw_plain, (plan.by_offset, x, g)),
            "library": (dense_bwd, (g_grid, x_grid, dense_w,
                                    [False, True, False]))}, **counts)
        ms.update(bound(
            4 * (x.numel() + g.numel() + 2 * plan.total_pairs
                 + plan.by_offset.num_chunks + 1 + w.numel()), pairs_ops,
            TF32X3_FLOPS))
        ms["library_call"] = ("torch.ops.aten.convolution_backward (weight "
                              "gradient) over the densified grid, cuDNN, "
                              "TF32 off")
        results["spconv_dw"][f"{label} dW"] = ms
        log(f"[numbers] spconv {label} ({plan.num_in} -> {plan.num_out} "
            f"sites, {plan.total_pairs} pairs, fp32; the dense call held to "
            f"the kernel: max_abs_err fwd {errs[0]:.3e} dX {errs[1]:.3e} dW "
            f"{errs[2]:.3e}): " + "; ".join(
                f"{name} kernel {t['kernel'] * 1e3:.2f} us, plain "
                f"{t['plain'] * 1e3:.2f} us, cuDNN {t['library'] * 1e3:.2f} "
                f"us, bound {t['bound'] * 1e3:.2f} us ({t['bound_by']}, "
                f"{t['bound_rate']})"
                for name, t in (
                    ("forward", results["spconv_pairs"][f"{label} forward"]),
                    ("dX", results["spconv_pairs"][f"{label} dX"]),
                    ("dW", results["spconv_dw"][f"{label} dW"]))))
    return results


def _library_amax(torch, rowptr, col, x, out):
    """The one PyTorch call for a MAX SpMM, torch.sparse.mm(A, x,
    reduce="amax") over a CSR of ones, held to the kernel's out at 1e-5:
    (fn, args) to time, or the error string where it refuses or differs."""
    m, n = rowptr.numel() - 1, x.shape[0]
    a = torch.sparse_csr_tensor(rowptr, col,
                                torch.ones(col.numel(), device=x.device),
                                size=(m, n))
    try:
        lib = torch.sparse.mm(a, x, reduce="amax")
        torch.cuda.synchronize()
        max_err(lib, out, 1e-5)
    except Exception as exc:  # the comparator's failure is a result here
        return f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
    return (lambda a, x: torch.sparse.mm(a, x, reduce="amax"), (a, x))


def _gather_segment_max(x, col, offsets):
    """MAX copy_u in two PyTorch calls: the per-edge gather, then a
    segment max over CSR offsets (-inf in an empty row)."""
    import torch

    return torch.segment_reduce(x.index_select(0, col), "max",
                                offsets=offsets)


def _scatter_winners(torch, col_ext, arg, g, n):
    """MAX/MIN d_dense (no weights) in two PyTorch calls: each element of
    g added into the row of its winning edge's column, col_ext [nnz + 1]
    the CSR col with n for the sentinel arg = nnz of an empty row."""
    return torch.zeros(n + 1, g.shape[1], device=g.device).scatter_add_(
        0, col_ext[arg.long()], g)[:n]


def _maxmin_numbers(torch, cuda, gen, graphs, rowptr_p2p, col_p2p):
    """spmm_maxmin and its d_dense at the GIN-max shapes (copy_u over the
    bare graph, as GIN aggregates) and at p2p F=32, beside their bounds,
    plain versions and, for the forward, torch.sparse.mm's "amax" (one
    call; it raises on CUDA) and the gather + torch.segment_reduce pair
    (two calls, held to the kernel's out on the non-empty rows); the
    forward also on `maxmin_path`'s slices of 32, 64 and 128 fp32
    features (128, 256 and 512 bytes of a row) and on 16 and 8 lanes of
    16 bytes a row."""
    from dgsparse_tpu_torch.kernels import spmm_maxmin as M
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    results = {"spmm_maxmin": {}, "spmm_maxmin_bwd": {}}
    st = graphs["arxiv-gin"][0].storage
    cases = [("p2p-synthetic F=32", rowptr_p2p, col_p2p, P2P_NODES, 32),
             ("arxiv gin0 forward F=128", st.rowptr(), st.col(),
              st.num_cols, 128),
             ("arxiv gin1 forward F=256", st.rowptr(), st.col(),
              st.num_cols, 256)]
    for label, rowptr, col, n, feat in cases:
        m, nnz = rowptr.numel() - 1, col.numel()
        x = torch.randn(n, feat, generator=gen, device=cuda)
        args = (rowptr, col, None, x)
        fns = {"kernel": (M.spmm_maxmin_cuda, args),
               "plain": (M.spmm_maxmin_plain, args)}
        paths = {f"slice_{b}B": M.maxmin_path(feat, 1, 4, 16, b)
                 for b in (128, 256, 512)}
        # 16 and 8 lanes of 16 bytes a row (256- and 128-byte slices)
        paths["lanes_16x16B"] = (4, 16, 1)
        paths["lanes_8x16B"] = (4, 8, 1)
        for key, path in paths.items():
            fns[key] = (functools.partial(M.spmm_maxmin_cuda, path=path),
                        args)
        out = M.spmm_maxmin_cuda(*args)[0]
        lib = _library_amax(torch, rowptr, col, x, out)
        if isinstance(lib, tuple):
            fns["library"] = lib
        offsets = rowptr.long()
        two = _gather_segment_max(x, col, offsets)
        busy = rowptr[1:] != rowptr[:-1]
        max_err(two[busy], out[busy], 0.0)
        fns["two_calls"] = (_gather_segment_max, (x, col, offsets))
        ms = _time_turns(fns)
        if not isinstance(lib, tuple):
            ms["library_error"] = lib
        # rowptr and col, x, out and arg; a compare per edge and feature
        nbytes = 4 * ((m + 1) + nnz + n * feat + 2 * m * feat)
        ms.update(bound(nbytes, 1.0 * nnz * feat))
        ms["library_call"] = ('torch.sparse.mm(sparse_csr of ones, dense, '
                              'reduce="amax")')
        ms["two_calls_desc"] = ("two PyTorch calls, not one: "
                                "x.index_select(0, col), then "
                                "torch.segment_reduce(..., 'max', "
                                "offsets=rowptr); out only, no winners")
        ms["paths"] = {"kernel": M.maxmin_path(feat, 1, 4), **paths}
        results["spmm_maxmin"][label] = ms
        log(f"[numbers] spmm_maxmin MAX copy_u {label} ({m} rows, {nnz} nnz, "
            f"fp32, path {ms['paths']['kernel']}): "
            + ", ".join(f"{k} {ms[k] * 1e3:.2f} us"
                        for k in ("kernel", "plain", "library", *paths,
                                  "two_calls")
                        if k in ms)
            + (f", library refused: {ms['library_error']}"
               if "library_error" in ms else "")
            + f", bound {ms['bound'] * 1e3:.2f} us ({ms['bound_by']}, "
            f"{ms['bound_rate']}); {ms['bound'] / ms['kernel']:.3f} of the "
            f"bound; paths {paths}")

    # d_dense of the second GINConv (F=256) and at p2p F=32; the d_values
    # of a weighted MAX at F=256, which no GIN step runs
    for label, stx, feat in (("arxiv gin1 backward d_dense F=256", st, 256),
                             ("p2p-synthetic d_dense F=32", None, 32)):
        if stx is None:
            from dgsparse_tpu_torch import SparseTensor

            stx = SparseTensor.from_csr(rowptr_p2p.cpu(), col_p2p.cpu(),
                                        sparse_sizes=(P2P_NODES, P2P_NODES),
                                        device=cuda).storage
        m, n, nnz = stx.num_rows, stx.num_cols, stx.nnz
        x = torch.randn(n, feat, generator=gen, device=cuda)
        _, arg = M.spmm_maxmin_cuda(stx.rowptr(), stx.col(), None, x)
        g = torch.randn(m, feat, generator=gen, device=cuda)
        args = (stx.colptr(), stx.row(), stx.csr2csc(), None, arg, g,
                stx.rowptr(), stx.csc_slot())
        # two PyTorch calls, not one: each element's g added into the row
        # of its winner's column (n: an empty row's sentinel), held to the
        # kernel at 1e-5 of the terms' absolute sum (atomic order)
        col_ext = torch.cat([stx.col(), stx.col().new_full((1,), n)]).long()
        out = M.spmm_maxmin_d_dense_cuda(*args)
        abs_sum = _scatter_winners(torch, col_ext, arg, g.abs(), n)
        e = assert_sum_close(_scatter_winners(torch, col_ext, arg, g, n),
                             out, abs_sum, TOL["float32"])
        ms = _time_turns({
            "kernel": (M.spmm_maxmin_d_dense_cuda, args),
            "plain": (M.spmm_maxmin_d_dense_plain, args[:6]),
            "masks": (functools.partial(
                M.spmm_maxmin_d_dense_cuda,
                path=M.d_dense_path(feat, 1, 4)), args),
            "old_mapping": (functools.partial(
                M.spmm_maxmin_d_dense_cuda, path=M.WARP_PER_COLUMN), args),
            "library": (functools.partial(_scatter_winners, torch),
                        (col_ext, arg, g, n))})
        # colptr, row and perm, g and arg, d_dense; a compare per edge and
        # feature, an add per won element
        nbytes = 4 * ((n + 1) + 2 * nnz + 2 * m * feat + n * feat)
        ms.update(bound(nbytes, 1.0 * nnz * feat + m * feat))
        ms["library_call"] = (
            "two PyTorch calls, not one: torch.zeros(n + 1, F)"
            ".scatter_add_(0, col_ext[arg.long()], g)[:n], col_ext = col "
            "and the sentinel row n")
        ms["paths"] = {"kernel": M.pick_d_dense(feat, 1, 4, 16, nnz, m),
                       "masks": M.d_dense_path(feat, 1, 4),
                       "old_mapping": M.WARP_PER_COLUMN}
        results["spmm_maxmin_bwd"][label] = ms
        log(f"[numbers] spmm_maxmin_d_dense {label} ({n} columns, {nnz} "
            f"nnz, fp32, picked {ms['paths']['kernel']}): kernel "
            f"{ms['kernel'] * 1e3:.2f} us, winner masks "
            f"{ms['masks'] * 1e3:.2f} us, old mapping (one warp a column) "
            f"{ms['old_mapping'] * 1e3:.2f} us, plain "
            f"{ms['plain'] * 1e3:.2f} us, two calls (gather + scatter_add_) "
            f"{ms['library'] * 1e3:.2f} us, max_abs_err {e:.3e}; bound "
            f"{ms['bound'] * 1e3:.2f} us ({ms['bound_by']}, "
            f"{ms['bound_rate']}); {ms['bound'] / ms['kernel']:.3f} of the "
            f"bound")
    m, n, nnz, feat = st.num_rows, st.num_cols, st.nnz, 256
    x = torch.randn(n, feat, generator=gen, device=cuda)
    v = torch.rand(nnz, 1, generator=gen, device=cuda) + 0.5
    _, arg = M.spmm_maxmin_cuda(st.rowptr(), st.col(), v, x)
    g = torch.randn(m, feat, generator=gen, device=cuda)
    args = (st.rowptr(), st.col(), arg, g, x)
    ms = _time_turns({"kernel": (M.spmm_maxmin_d_values_cuda, args),
                      "plain": (M.spmm_maxmin_d_values_plain, args)})
    nbytes = 4 * ((m + 1) + 2 * nnz + 2 * m * feat + n * feat)
    ms.update(bound(nbytes, 2.0 * m * feat))
    label = "arxiv d_values dot F=256 (off the GIN path)"
    results["spmm_maxmin_bwd"][label] = ms
    log(f"[numbers] spmm_maxmin_d_values {label}: kernel "
        f"{ms['kernel'] * 1e3:.2f} us, plain {ms['plain'] * 1e3:.2f} us, "
        f"bound {ms['bound'] * 1e3:.2f} us ({ms['bound_by']}, "
        f"{ms['bound_rate']})")
    return results


# --- the single-card utilities, native rulebooks, bf16 layers, checkpoints
# and the tuner ---------------------------------------------------------------

# the forwards whose dispatch counters phase 9 reads, and the routes each
# must record: (op, route tags...) -> calls
METRIC_ROUTES = {
    "gcn-reddit": {("spmm", "PALLAS_ROW_TILE", "sum"): 2},
    # gat_attention runs the tiers directly: one dispatch a head (4 + 1)
    "gat-reddit": {("gat_attention",): 5},
    "gin-max-arxiv": {("spmm", "XLA_SEGMENT", "max"): 2},
    "unet-60k": {("spconv", "fused"): 4},
}
# a random geometric graph of ~9 neighbours a node for the RCM reading
RCM_NODES, RCM_RADIUS, RCM_FEAT = 100_000, 0.0054, 256


def _route_key(key):
    op, tags = key[0], dict(key[1:])
    if op == "spmm":
        return op, tags["alg"], tags["reduce"]
    if op == "spconv":
        return op, tags["path"]
    return (op,)


def phase_utilities(torch, cuda, graphs):
    """The dispatch counters on one forward each of gcn-reddit, gat-reddit,
    gin-max-arxiv and unet-60k, held to the kernels that launched;
    validation on a corrupted card storage (a ValueError and no launch,
    then a clean SpMM); the Reddit storage's degree statistics; RCM on a
    geometric graph of 10^5 nodes, csr_spmm at F = 256 in both orders.
    Returns the launches of the four forwards."""
    import numpy as np

    from dgsparse_tpu_torch import SparseTensor, spmm
    from dgsparse_tpu_torch.core import reorder
    from dgsparse_tpu_torch.entry import SERVE_CONFIGS, build_model
    from dgsparse_tpu_torch.kernels import reset_launch_counts
    from dgsparse_tpu_torch.kernels import spmm_csr as K
    from dgsparse_tpu_torch.utils import debug, metrics, stats
    from dgsparse_tpu_torch.utils.testing import (assert_sum_close,
                                                  geometric_graph,
                                                  random_csr)

    launches = dict(_NONE)
    for config, want in METRIC_ROUTES.items():
        tc = SERVE_CONFIGS[config]
        adj, x, _ = graphs[_graph_key(tc)]
        model = build_model(config, seed=0, device=cuda)
        metrics.reset()
        reset_launch_counts()
        metrics.enable()
        try:
            with torch.inference_mode():
                model(x, adj)
        finally:
            metrics.disable()
        torch.cuda.synchronize()
        counts = _counts()
        recorded = {}
        for key, n in metrics.counters().items():
            recorded[_route_key(key)] = recorded.get(_route_key(key), 0) + n
        log(f"[utilities] {config}: metrics.summary() of one forward:")
        for line in metrics.summary().splitlines():
            log(f"[utilities]   {line}")
        metrics.reset()
        if recorded != want:
            raise AssertionError(f"{config}: routes {recorded}, expected "
                                 f"{want}")
        if counts != FORWARD_LAUNCHES[_launch_kind(tc, adj)]:
            raise AssertionError(f"{config}: launches {counts}")
        for k in KERNEL_NAMES:
            launches[k] += counts[k]

    # validation: a column corrupted after construction raises before any
    # launch, and the context stays healthy
    rowptr, col, values = random_csr(4000, 3000, avg_degree=8.0, seed=12)
    sp = SparseTensor.from_csr(rowptr, col, torch.from_numpy(values),
                               sparse_sizes=(4000, 3000), device=cuda)
    good = sp.storage.col()
    bad = good.clone()
    bad[len(col) // 2] = 3000 + 7
    sp.storage._col = bad
    x = torch.randn(3000, 32, device=cuda)
    reset_launch_counts()
    debug.set_validate(True)
    try:
        spmm(sp, x)
    except ValueError as e:
        message = str(e)
    else:
        raise AssertionError("validation let a corrupted storage through")
    finally:
        debug.set_validate(False)
    torch.cuda.synchronize()
    if not message.startswith("col indices out of range") \
            or any(_counts().values()):
        raise AssertionError(f"validation: {message!r}, launches "
                             f"{_counts()}")
    sp.storage._col = good
    out = spmm(sp, x)
    abs_sum = K.csr_spmm_plain(sp.storage.rowptr(), good,
                               sp.storage.values().abs(), x.abs())
    e = assert_sum_close(out, K.csr_spmm_plain(
        sp.storage.rowptr(), good, sp.storage.values(), x), abs_sum, 1e-5)
    log(f"[utilities] validate: ValueError({message!r}) before any "
        f"launch; the clean SpMM afterwards launched "
        f"{ {k: v for k, v in _counts().items() if v} } and matched the "
        f"plain version, max_abs_err {e:.3e}")

    log(f"[utilities] degree_stats of the Reddit-scale storage: "
        f"{stats.degree_stats(graphs['reddit'][0].storage.rowptr())}")

    # RCM: bandwidth, host seconds, and csr_spmm in both orders
    t0 = time.perf_counter()
    rowptr, col, n = geometric_graph(RCM_NODES, RCM_RADIUS, seed=0)
    t_gen = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(len(col)).astype(np.float32)
    t0 = time.perf_counter()
    perm = reorder.rcm_permutation(rowptr, col)
    t_rcm = time.perf_counter() - t0
    t0 = time.perf_counter()
    rp2, col2, vals2 = reorder.permute_csr(rowptr, col, vals, perm)
    t_perm = time.perf_counter() - t0
    bw0, bw1 = reorder.bandwidth(rowptr, col), reorder.bandwidth(rp2, col2)
    r0, c0, v0, r1, c1, v1 = _to(cuda, rowptr, col, vals, rp2, col2, vals2)
    x = torch.randn(n, RCM_FEAT, device=cuda)
    idx = torch.from_numpy(perm).to(cuda).long()
    xp = x[idx].contiguous()
    out0 = K.csr_spmm_cuda(r0, c0, v0, x)
    out1 = K.csr_spmm_cuda(r1, c1, v1, xp)
    abs0 = K.csr_spmm_plain(r0, c0, v0.abs(), x.abs())
    e = assert_sum_close(out1, out0[idx], abs0[idx], 1e-5)
    ms = _time_turns({"shuffled": (K.csr_spmm_cuda, (r0, c0, v0, x)),
                      "rcm": (K.csr_spmm_cuda, (r1, c1, v1, xp))})
    log(f"[utilities] RCM on a geometric graph of {n} nodes, {len(col)} "
        f"edges (built in {t_gen:.2f} s): bandwidth {bw0} -> {bw1}; host "
        f"rcm_permutation {t_rcm:.3f} s, permute_csr {t_perm:.3f} s; "
        f"csr_spmm F={RCM_FEAT} fp32 shuffled ids {ms['shuffled'] * 1e3:.2f}"
        f" us, RCM order {ms['rcm'] * 1e3:.2f} us (un-permuted result vs "
        f"the shuffled one: max_abs_err {e:.3e})")
    return launches


@contextlib.contextmanager
def _numpy_rulebooks():
    """`build_rulebook` on its numpy path for the block, at every size."""
    from dgsparse_tpu_torch.ops import spconv as ops

    saved = ops._native_rulebook
    ops._native_rulebook = lambda *args: None
    try:
        yield
    finally:
        ops._native_rulebook = saved


def _unet_rulebooks(torch, st, cuda):
    """The UNet's four rulebooks on the cloud `st`, built afresh on `cuda`;
    (plans, coarse coords, host seconds incl. upload)."""
    from dgsparse_tpu_torch.ops.spconv import build_rulebook, inverse_plan

    t0 = time.perf_counter()
    shape = st.spatial_shape
    enc1, _ = build_rulebook(st.coords, 3, 1, 1, spatial_shape=shape,
                             device=cuda)
    down1, coarse = build_rulebook(st.coords, 3, 2, 1, spatial_shape=shape,
                                   device=cuda)
    shape2 = tuple(max((s + 2 - 3) // 2 + 1, 1) for s in shape)
    enc2, _ = build_rulebook(coarse, 3, 1, 1, spatial_shape=shape2,
                             device=cuda)
    up1 = inverse_plan(down1)
    torch.cuda.synchronize()
    return ({"enc1": enc1, "down1": down1, "enc2": enc2, "up1": up1},
            coarse, time.perf_counter() - t0)


def _same_plan(torch, a, b, name):
    for f in ("knnz", "kpos", "qkpos", "num_out", "num_in", "k_vol",
              "separate_mid"):
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"{name}: {f} differs")
    pairs = [(f, getattr(a, f), getattr(b, f))
             for f in ("imap", "omap", "widx", "o2i", "i2o")]
    for layout in ("by_out", "by_in", "by_offset"):
        la, lb = getattr(a, layout), getattr(b, layout)
        for f, v in vars(la).items():
            if isinstance(v, torch.Tensor):
                pairs.append((f"{layout}.{f}", v, getattr(lb, f)))
            elif v != getattr(lb, f):
                raise AssertionError(f"{name}: {layout}.{f} differs")
    for f, u, v in pairs:
        if not torch.equal(u, v):
            raise AssertionError(f"{name}: {f} differs")


def phase_native(torch, cuda, cloud):
    """unet-60k's four rulebooks by the native builder and by numpy:
    identical plans, and each builder's host seconds (upload included).
    Fails if the native library does not build or load."""
    from dgsparse_tpu_torch import native

    path = native.build()
    if not native.available():
        raise AssertionError(f"the native library {path} did not load")
    st = cloud[0]
    nat, nat_coarse, t_nat = _unet_rulebooks(torch, st, cuda)
    with _numpy_rulebooks():
        ref, ref_coarse, t_ref = _unet_rulebooks(torch, st, cuda)
    import numpy as np

    if not np.array_equal(nat_coarse, ref_coarse):
        raise AssertionError("the coarse sites differ")
    for name in nat:
        _same_plan(torch, nat[name], ref[name], name)
    log(f"[native] {path} (dg_version {native.version()}): unet-60k's 4 "
        f"rulebooks ({len(st.coords)} voxels; pairs "
        f"{ {k: p.total_pairs for k, p in nat.items()} }) identical from "
        f"both builders (by_out, by_in, by_offset, the imap/omap/widx "
        f"streams, o2i, i2o); host seconds with the upload: native "
        f"{t_nat:.3f} s, numpy {t_ref:.3f} s")
    return {"native_s": t_nat, "numpy_s": t_ref}


def _max_rel_close(what, got, want, tol):
    """max |got - want| <= tol * max |want|; returns max |got - want|."""
    err = (got.float() - want.float()).abs().max().item()
    bound = tol * want.float().abs().max().item()
    if not err <= bound:
        raise AssertionError(f"{what}: max |got - want| = {err:.3e} > "
                             f"{tol} * max |want| = {bound:.3e}")
    return err


def _refuses(what, check, *args):
    """A planted fault `check` must refuse."""
    try:
        check(*args)
    except AssertionError:
        return
    raise AssertionError(f"{what}: the check passed a planted fault")


def phase_bf16_layers(torch, cuda, cloud):
    """An enc2-shaped SubMConv3d(64, 64, compute_dtype=bfloat16), forward
    and backward, against the fp32 layer with the same parameters: out,
    dX, dW and db at 1e-2 of the terms' absolute sum, and dW and db, sums
    of about 10^5 terms, where that bound exceeds a typical value, also
    within 1e-2 of the largest |fp32 value| (bf16 rounds the inputs and
    each result to 8 significant bits, 2^-8 of a value at most). The bf16
    spconv_pairs / spconv_dw on its rounded inputs against their plain
    versions at 1e-5 of the terms' absolute sum: both sum the same exact
    bf16 products in float32, in another order. The kernel checks and the
    layer's dW check must also refuse a planted fault: a tenth of the
    busiest offset's pairs left out. Returns the bf16 layer's
    launches."""
    from dgsparse_tpu_torch.kernels import reset_launch_counts
    from dgsparse_tpu_torch.kernels import spconv as K
    from dgsparse_tpu_torch.nn import PointCloudUNet
    from dgsparse_tpu_torch.nn.sparse_conv import SubMConv3d
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    st = cloud[0]
    coarse = PointCloudUNet().down1.output_sites(st)
    plan = unet_plans(st)["enc2"]
    mid = (plan.k_vol - 1) // 2
    f32 = SubMConv3d(64, 64, generator=torch.Generator().manual_seed(3))
    f32 = f32.to(cuda)
    bf16 = SubMConv3d(64, 64, compute_dtype=torch.bfloat16).to(cuda)
    bf16.load_state_dict(f32.state_dict())
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(plan.num_in, 64, generator=gen, device=cuda)
    ct = torch.randn(plan.num_out, 64, generator=gen, device=cuda)

    def run(layer):
        xi = x.clone().requires_grad_()
        out = layer(coarse.replace(features=xi)).features
        (out.float() * ct).sum().backward()
        return out, xi.grad, layer.kernel.grad, layer.bias.grad

    reset_launch_counts()
    got = run(bf16)
    torch.cuda.synchronize()
    launches = _counts()
    want = run(f32)
    if got[0].dtype != torch.bfloat16 or launches != {
            **_NONE, "spconv_pairs": 2, "spconv_dw": 1}:
        raise AssertionError(f"bf16 layer: {got[0].dtype}, {launches}")
    w = f32.kernel.detach()
    with torch.no_grad():
        # the pairs' terms, then the center tap's added for the layer
        dw_abs = K.spconv_dw_plain(plan.by_offset, x.abs(), ct.abs())
        dw_abs[mid] += x.abs().T @ ct.abs()
        abs_sums = (
            K.spconv_pairs_plain(plan.by_out, x.abs(), w.abs())
            + x.abs() @ w[mid].abs(),
            K.spconv_pairs_plain(plan.by_in, ct.abs(), w.abs().transpose(
                1, 2).contiguous()) + ct.abs() @ w[mid].abs().T,
            dw_abs, ct.abs().sum(0))
    names = ("out", "dX", "dW", "db")
    errs = [assert_sum_close(a.float(), b, s, 1e-2)
            for a, b, s in zip(got, want, abs_sums)]
    for n, a, b in zip(names[2:], got[2:], want[2:]):
        _max_rel_close(f"bf16 layer {n}", a, b, 1e-2)
    xb, wb, gb = x.bfloat16(), w.bfloat16(), ct.bfloat16()
    with torch.no_grad():
        pairs = (K.spconv_pairs_cuda(plan.by_out, xb, wb),
                 K.spconv_pairs_plain(plan.by_out, xb, wb),
                 K.spconv_pairs_plain(plan.by_out, xb.float().abs(),
                                      wb.float().abs()))
        dw = (K.spconv_dw_cuda(plan.by_offset, xb, gb),
              K.spconv_dw_plain(plan.by_offset, xb, gb),
              K.spconv_dw_plain(plan.by_offset, xb.float().abs(),
                                gb.float().abs()))
    kerrs = [assert_sum_close(*pairs, 1e-5), assert_sum_close(*dw, 1e-5)]
    # the planted fault: a tenth of the busiest offset's pairs left out
    widx = plan.by_offset.widx.long()
    busy = torch.bincount(widx, minlength=plan.k_vol)
    busy[mid] = 0
    off = int(busy.argmax())
    sel = torch.nonzero(widx == off).flatten()
    sel = sel[:max(sel.numel() // 10, 1)]
    i = plan.by_offset.in_ids[sel].long()
    o = plan.by_offset.out_ids[sel].long()
    with torch.no_grad():
        bad_out = pairs[0].index_add(0, o, xb[i].float() @ wb[off].float(),
                                     alpha=-1)
        bad_dw = dw[0].clone()
        bad_dw[off] -= xb[i].float().T @ gb[o].float()
        bad_layer_dw = got[2].clone()
        bad_layer_dw[off] -= x[i].T @ ct[o]
    _refuses("spconv_pairs bf16", assert_sum_close, bad_out, *pairs[1:],
             1e-5)
    _refuses("spconv_dw bf16", assert_sum_close, bad_dw, *dw[1:], 1e-5)
    _refuses("bf16 layer dW", _max_rel_close, "dW", bad_layer_dw, want[2],
             1e-2)
    log(f"[bf16] SubMConv3d(64, 64, compute_dtype=bfloat16) on the enc2 "
        f"plan ({plan.num_in} sites, {plan.total_pairs} pairs): launches "
        f"{ {k: v for k, v in launches.items() if v} }, output "
        f"{got[0].dtype}; vs the fp32 layer max_abs_err "
        + " ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
        + " (at 1e-2 of the terms' absolute sum; dW and db also at 1e-2 "
        "of max |fp32|: "
        + " ".join(f"{n} {1e-2 * b.float().abs().max().item():.3e}"
                   for n, b in zip(names[2:], want[2:]))
        + f"); bf16 kernels vs their plain versions: spconv_pairs "
        f"{kerrs[0]:.3e}, spconv_dw {kerrs[1]:.3e} (at 1e-5 of the terms' "
        f"absolute sum); all three checks refuse {sel.numel()} of offset "
        f"{off}'s pairs left out")
    return launches


def phase_checkpoint(torch, cuda, graphs):
    """gcn-arxiv: 2 Adam steps, its model and Adam state saved and
    restored into a fresh trainer on the card, then one more step in both:
    the parameters bitwise equal (the kernels sum in a fixed order)."""
    from dgsparse_tpu_torch.entry import build_trainer, train_step
    from dgsparse_tpu_torch.utils import checkpoint

    data = graphs["arxiv"]
    adj, x, y = data
    model, opt, _ = build_trainer("gcn-arxiv", seed=0, device=cuda, data=data)
    for _ in range(2):
        train_step(model, opt, x, adj, y)
    tmp = tempfile.mkdtemp(prefix="dgsparse_ckpt_")
    try:
        path = os.path.join(tmp, "gcn-arxiv.pt")
        t0 = time.perf_counter()
        checkpoint.save(path, {"model": model.state_dict(),
                               "opt": opt.state_dict()})
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        fresh, fresh_opt, _ = build_trainer("gcn-arxiv", seed=1, device=cuda,
                                            data=data)
        t0 = time.perf_counter()
        state = checkpoint.restore(path, template={
            "model": fresh.state_dict(), "opt": fresh_opt.state_dict()})
        fresh.load_state_dict(state["model"])
        fresh_opt.load_state_dict(state["opt"])
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [float(train_step(m, o, x, adj, y))
              for m, o in ((model, opt), (fresh, fresh_opt))]
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"checkpoint: {name} differs after the "
                                 f"resumed step")
    if losses[0] != losses[1]:
        raise AssertionError(f"checkpoint: step-3 losses {losses}")
    log(f"[checkpoint] gcn-arxiv: 2 steps, saved ({size} B) in "
        f"{t_save:.3f} s, restored into a fresh trainer in {t_restore:.3f} "
        f"s; step 3 in both: loss {losses[0]:.6f}, every parameter "
        f"bitwise equal")


# --- phase 13: the sharded ops of dist/, as ranks on the card ----------------

# the kernels the dist path launches, by the module that holds each wrapper
DIST_KERNELS = {"csr_spmm": "spmm_csr", "sddmm_csr": "sddmm_csr",
                "spconv_pairs": "spconv", "spconv_dw": "spconv"}
DIST_STEPS = 3                 # SGD steps of the sharded GCN
DIST_GAT_STEPS = 2
DIST_LR = 1e-2
DIST_TIMEOUT = 240             # seconds a run_ranks call may take
DIST_CHANNELS = (32, 64)       # the sharded SubM 3^3 convs, C -> C
DIST_FEAT = 256                # the 2-D mesh's and NCCL spmm's width
DIST_FIXTURE = os.path.join(FIXTURES, "dist_small.npz")


@contextlib.contextmanager
def _kernel_events(torch):
    """CUDA events around every launch of the dist path's kernels while
    the context is open: yields the list of (start, stop) pairs."""
    import importlib

    events, saved = [], []
    for name, module in DIST_KERNELS.items():
        mod = importlib.import_module(f"dgsparse_tpu_torch.kernels.{module}")
        orig = getattr(mod, f"{name}_cuda")

        def timed(*args, _orig=orig, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _orig(*args, **kw)
            stop.record()
            events.append((start, stop))
            return out

        saved.append((mod, f"{name}_cuda", orig))
        setattr(mod, f"{name}_cuda", timed)
    try:
        yield events
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def _timed_steps(fn, steps):
    """`dist.cases`' run_steps on the card: ([fn() a step], {"steps": per
    step the host-clock ms around synchronize, the dist kernels' ms by
    CUDA events and the staged collectives' host ms; "peak_bytes":
    max_memory_allocated over them})."""
    import torch

    from dgsparse_tpu_torch.dist import comm

    device = torch.cuda.current_device()
    torch.cuda.reset_peak_memory_stats(device)
    outs, rows = [], []
    for _ in range(steps):
        staged = comm.STAGED["seconds"]
        with _kernel_events(torch) as events:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            outs.append(fn())
            torch.cuda.synchronize(device)
            host = time.perf_counter() - t0
        rows.append({"step_ms": host * 1e3,
                     "kernel_ms": sum(a.elapsed_time(b) for a, b in events),
                     "staged_ms": (comm.STAGED["seconds"] - staged) * 1e3})
    return outs, {"steps": rows,
                  "peak_bytes": torch.cuda.max_memory_allocated(device)}


def _dist_cloud_data(c, channels):
    """(features, kernel, cotangent) of the sharded conv at C channels,
    from a seed."""
    import numpy as np

    rng = np.random.default_rng(channels)
    n = len(c["coords"])
    return (rng.standard_normal((n, channels), dtype=np.float32),
            (rng.standard_normal((27, channels, channels), dtype=np.float32)
             * 0.1),
            rng.standard_normal((n, channels), dtype=np.float32))


def _no_jax():
    if "jax" in sys.modules:
        raise AssertionError("a rank imported JAX")


def _dist_ranks(rank, world, device, driven, checks):
    """A rank of phase 13: `dist.cases.run_cases` of the driven cases, each
    step timed (`_timed_steps`), with the launches they alone made; then
    the cases that only check (the frozen JAX fixture)."""
    from dgsparse_tpu_torch import kernels
    from dgsparse_tpu_torch.dist import cases

    kernels.reset_launch_counts()
    out = cases.run_cases(rank, world, device, driven, _timed_steps)
    launches = _counts()
    checked = cases.run_cases(rank, world, device, checks)
    _no_jax()
    return {"driven": out, "launches": launches, "checks": checked}


def _dist_wide(g):
    """(x, ct) [n, DIST_FEAT] of the 2-D mesh and the NCCL SpMM, from a
    seed."""
    import numpy as np

    rng = np.random.default_rng(DIST_FEAT)
    n = len(g["rowptr"]) - 1
    return (rng.standard_normal((n, DIST_FEAT), dtype=np.float32),
            rng.standard_normal((n, DIST_FEAT), dtype=np.float32))


def _dist_fixture_cases(fx):
    """The frozen JAX dist run's inputs as `dist.cases` cases: the GCN's
    loss and one SGD step, the GAT's logits, the sharded conv's output."""
    def part(prefix):
        return {k[len(prefix):]: v for k, v in fx.items()
                if k.startswith(prefix)}

    def graph(prefix):
        m = len(fx[f"{prefix}_rowptr"]) - 1
        return {"rowptr": fx[f"{prefix}_rowptr"], "col": fx[f"{prefix}_col"],
                "shape": (m, m), "x": fx[f"{prefix}_x"],
                "y": fx[f"{prefix}_y"]}

    return {"gcn": dict(graph("gcn"), op="gcn", values=fx["gcn_values"],
                        params=part("gcn_param_"), lr=1e-2, steps=1),
            "gat": dict(graph("gat"), op="gat", values=None,
                        params=part("gat_param_"),
                        heads=int(fx["gat_heads"]), lr=1e-2, steps=0),
            "conv": {"op": "spconv", "coords": fx["spconv_coords"],
                     "kernel_size": 3,
                     "spatial_shape": tuple(fx["spconv_spatial_shape"]),
                     "feats": fx["spconv_feats"],
                     "kernel": fx["spconv_kernel"]}}


def _scaled(what, got, want, rel):
    """max |got - want| / max |want| per array of a dict (or one array);
    raises above `rel`."""
    import numpy as np

    pairs = got.items() if isinstance(got, dict) else [(what, got)]
    worst = 0.0
    for k, g in pairs:
        w = want[k] if isinstance(want, dict) else want
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        if not np.isfinite(g).all() or err > rel:
            raise AssertionError(f"dist: {what} {k}: {err:.3e} of max |ref| "
                                 f"> {rel}")
        worst = max(worst, err)
    return worst


def _time_line(tag, t, card):
    rows = t["steps"]
    fmt = lambda key: "/".join(f"{r[key]:.2f}" for r in rows)  # noqa: E731
    return (f"[dist] {tag}: step {fmt('step_ms')} ms (host clock), "
            f"kernels {fmt('kernel_ms')} ms (CUDA events), staged "
            f"collectives {fmt('staged_ms')} ms, peak "
            f"{t['peak_bytes'] / 2**20:.1f} MiB; {card}")


def phase_dist(torch, cuda, graphs, card):
    """The sharded ops of `dist/` as ranks on the one card, through
    `dist.launch.run_ranks` (see the module docstring, phase 13); returns
    the summed launches of the ranks' driven runs."""
    import numpy as np
    from torch.nn import functional as F

    from dgsparse_tpu_torch import build_rulebook, spconv, spmm
    from dgsparse_tpu_torch.dist import gat as dgat
    from dgsparse_tpu_torch.dist import gcn as dgcn
    from dgsparse_tpu_torch.dist import spconv as dsp
    from dgsparse_tpu_torch.dist.launch import run_ranks
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    t0 = time.perf_counter()
    adj, x, y = graphs["arxiv"]
    st = adj.storage
    n = adj.sparse_sizes()[0]
    if bool((st.values() < 0).any()):
        raise AssertionError("dist: the arxiv GCN values must be >= 0, the "
                             "abs sums below reuse them")
    graph = {"rowptr": st.rowptr().cpu().numpy(),
             "col": st.col().cpu().numpy(),
             "values": st.values().cpu().numpy(),
             "shape": (n, n), "x": x.cpu().numpy(), "y": y.cpu().numpy()}
    gen = torch.Generator().manual_seed(0)
    gcn_p = {k: v.numpy() for k, v in
             dgcn.init_params(gen, 128, 256, 40).items()}
    gat_p = {k: v.numpy() for k, v in
             dgat.init_params(gen, 128, 16, 40, 4).items()}
    cloud_st = graphs["unet-60k"][0]
    cloud = {"coords": cloud_st.coords,
             "spatial_shape": cloud_st.spatial_shape}
    with np.load(DIST_FIXTURE) as f:
        fixture = dict(f)
    # the cases of `dist/cases.py`; the ranks' pickle holds each array once
    gcn_case = dict(graph, op="gcn", params=gcn_p, lr=DIST_LR,
                    steps=DIST_STEPS)
    models = {"gcn_rows": dict(gcn_case, balance="rows"),
              "gat": dict(graph, op="gat", values=None, params=gat_p,
                          heads=4, lr=DIST_LR, steps=DIST_GAT_STEPS)}
    convs = {f"conv{c}": dict(
        zip(("feats", "kernel", "ct"), _dist_cloud_data(cloud, c)),
        op="spconv", kernel_size=3, calls=2, **cloud)
        for c in DIST_CHANNELS}
    xw, ctw = _dist_wide(graph)
    wide = dict(graph, x=xw, ct=ctw)
    runs = {}
    for world, backend, driven, checks in (
            (2, "gloo", dict(models, gcn_edges=dict(gcn_case,
                                                    balance="edges"),
                             **convs), _dist_fixture_cases(fixture)),
            (4, "gloo", {"mesh": dict(wide, op="spmm2d", mesh=(2, 2))}, {}),
            (1, "nccl", dict(models, spmm=dict(wide, op="spmm",
                                               balance="rows",
                                               reduce="sum"), **convs),
             {})):
        t1 = time.perf_counter()
        res = run_ranks(_dist_ranks, world, backend, cuda, DIST_TIMEOUT,
                        (list(driven.values()), list(checks.values())))
        if any(r.jax_loaded for r in res):
            raise AssertionError("dist: a rank imported JAX")
        runs[world] = [dict(zip(driven, r.result["driven"]),
                            launches=r.result["launches"],
                            checks=dict(zip(checks, r.result["checks"])))
                       for r in res]
        log(f"[dist] D={world} {backend}: {world} rank(s) on {cuda} in "
            f"{time.perf_counter() - t1:.1f} s (spawn, host plans, runs)")
    d2, d4, d1 = runs[2], runs[4], runs[1][0]

    # the single-process GCN forward and SGD step on the full graph
    p = {k: torch.from_numpy(v).to(cuda).requires_grad_()
         for k, v in gcn_p.items()}
    h2 = torch.relu(spmm(adj, x @ p["w1"] + p["b1"])) @ p["w2"] + p["b2"]
    ref = spmm(adj, h2)
    loss = F.cross_entropy(ref, y)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    with torch.no_grad():
        abs_sum = spmm(adj, h2.abs())
        for balance in ("rows", "edges"):
            got = torch.from_numpy(np.concatenate(
                [r[f"gcn_{balance}"]["logits"] for r in d2])).to(cuda)
            err = assert_sum_close(got, ref, abs_sum, 1e-5)
            log(f"[dist] D=2 GCN ({balance}) forward vs one process: max "
                f"|diff| {err:.3e} (1e-5 of the terms' absolute sum)")
        one = {k: (v - DIST_LR * grads[k]).cpu().numpy() for k, v in p.items()}
    ref1 = d1["gcn_rows"]
    _scaled("NCCL D=1 GCN step-1 loss", float(ref1["losses"][0]),
            float(loss.detach()), 1e-5)
    err = _scaled("NCCL D=1 GCN step-1 params", ref1["params"][0], one, 1e-5)
    log(f"[dist] NCCL D=1 GCN step 1 vs the unsharded step: params "
        f"{err:.3e} of max |p|")
    for balance in ("rows", "edges"):
        for r in d2:
            run = r[f"gcn_{balance}"]
            for s in range(DIST_STEPS):
                _scaled(f"D=2 GCN ({balance}) step {s + 1} loss",
                        float(run["losses"][s]), float(ref1["losses"][s]),
                        1e-5)
                err = _scaled(f"D=2 GCN ({balance}) step {s + 1} params",
                              run["params"][s], ref1["params"][s], 1e-5)
        log(f"[dist] D=2 GCN ({balance}): {DIST_STEPS} SGD steps, losses "
            f"{[round(float(v), 6) for v in run['losses']]} = D=1's, "
            f"params {err:.3e} of max |p| after step {DIST_STEPS}")

    # GAT: the forward and step 1's gradients against D = 1
    gat1 = d1["gat"]
    got = np.concatenate([r["gat"]["logits"] for r in d2])
    err = _scaled("D=2 GAT logits", got, gat1["logits"], 1e-5)
    for r in d2:
        gerr = _scaled("D=2 GAT step-1 grads", r["gat"]["grads"],
                       gat1["grads"], 1e-5)
        for s in range(DIST_GAT_STEPS):
            _scaled(f"D=2 GAT step {s + 1} loss", float(r["gat"]["losses"][s]),
                    float(gat1["losses"][s]), 1e-5)
    log(f"[dist] D=2 GAT (4 x 16): logits {err:.3e}, step-1 gradients "
        f"{gerr:.3e} of max |ref| against D=1; losses "
        f"{[round(float(v), 6) for v in d2[0]['gat']['losses']]}")

    # the sharded conv against the single-device conv in slab order
    for c in DIST_CHANNELS:
        plan_d, order = dsp.shard_pointcloud(cloud["coords"], 2, 3,
                                             cloud["spatial_shape"])
        rb, _ = build_rulebook(cloud["coords"][order], 3, 1, 1,
                               spatial_shape=cloud["spatial_shape"],
                               device=cuda)
        feats, kernel, ct = _dist_cloud_data(cloud, c)
        feats, ct = (torch.from_numpy(a[order]).to(cuda) for a in (feats, ct))
        kernel = torch.from_numpy(kernel).to(cuda)
        xs, ws = feats.requires_grad_(), kernel.requires_grad_()
        out = spconv(xs, ws, rb)
        dx, dw = torch.autograd.grad((out * ct).sum(), (xs, ws))
        xa, wa = feats.abs().detach().requires_grad_(), kernel.abs().detach()
        wa.requires_grad_()
        out_a = spconv(xa, wa, rb)
        dxa, dwa = torch.autograd.grad((out_a * ct.abs()).sum(), (xa, wa))
        errs = []
        for key, want, bound in (("out", out, out_a), ("dx", dx, dxa)):
            got = torch.from_numpy(np.concatenate(
                [r[f"conv{c}"][key] for r in d2])).to(cuda)
            errs.append(assert_sum_close(got, want.detach(), bound.detach(),
                                         1e-5))
        # every rank holds the global dW
        for r in d2:
            got = torch.from_numpy(r[f"conv{c}"]["dw"]).to(cuda)
            errs.append(assert_sum_close(got, dw, dwa, 1e-5))
        for r in d2:
            s = r[f"conv{c}"]
            if s["volumes"] != {"ppermute": 2 * s["h_max"] * c} \
                    or not s["h_max"] < 0.35 * s["own_max"]:
                raise AssertionError(f"dist: conv {c}: volumes "
                                     f"{s['volumes']}, h_max {s['h_max']}, "
                                     f"own_max {s['own_max']}")
        log(f"[dist] D=2 SubM 3^3 {c}->{c} on unet-60k "
            f"({len(order)} voxels, h_max {plan_d.h_max}, own_max "
            f"{plan_d.own_max}): out / dX / dW vs one device "
            f"{errs[0]:.3e} / {errs[1]:.3e} / {max(errs[2:]):.3e} (1e-5 of "
            f"the terms' absolute sum); ppermute 2 * h_max * {c} a rank")

    # the 2-D mesh and the NCCL SpMM against the unsharded SpMM
    xw, ctw = (torch.from_numpy(a).to(cuda) for a in _dist_wide(graph))
    xw.requires_grad_()
    ref = spmm(adj, xw)
    dref, = torch.autograd.grad((ref * ctw).sum(), xw)
    xa = xw.detach().abs().requires_grad_()
    bound_out = spmm(adj, xa)
    bound_dx, = torch.autograd.grad((bound_out * ctw.abs()).sum(), xa)
    grid = {tuple(r["mesh"]["coords"]): r["mesh"] for r in d4}
    for name, feat, suffix in (("2d", 2, ""), ("1d", 1, "_1d")):
        def whole(key):
            return torch.from_numpy(np.concatenate([np.concatenate(
                [grid[(g, f)][key + suffix] for f in range(feat)], axis=1)
                for g in (0, 1)])[:n]).to(cuda)

        e1 = assert_sum_close(whole("out"), ref.detach(),
                              bound_out.detach(), 1e-5)
        e2 = assert_sum_close(whole("dx"), dref, bound_dx, 1e-5)
        log(f"[dist] D=4 {name} mesh (graph 2 x feat {feat}) F={DIST_FEAT}: "
            f"out {e1:.3e}, d_x {e2:.3e} vs one device (1e-5 of the "
            f"terms' absolute sum)")
    for r in d4:
        v1 = r["mesh"]["volumes_1d"]["all_gather"]
        v2 = r["mesh"]["volumes"]["all_gather"]
        if 2 * v2 != v1:
            raise AssertionError(f"dist: 2-D gather volume {v2} is not half "
                                 f"of the 1-D mesh's {v1}")
    log(f"[dist] D=4 per-rank all_gather: 2-D {v2} elements, 1-D {v1}")
    err = assert_sum_close(torch.from_numpy(d1["spmm"]["out"]).to(cuda),
                           ref.detach(), bound_out.detach(), 1e-5)
    e2 = assert_sum_close(torch.from_numpy(d1["spmm"]["dx"]).to(cuda),
                          dref, bound_dx, 1e-5)
    log(f"[dist] NCCL D=1 spmm_sharded F={DIST_FEAT} vs the unsharded "
        f"spmm: out {err:.3e}, d_x {e2:.3e} (1e-5 of the terms' absolute "
        f"sum)")

    # the frozen JAX dist run, at 1e-4
    for r in d2:
        fx = r["checks"]["gcn"]
        _scaled("fixture GCN loss", float(fx["loss"]),
                float(fixture["gcn_loss"]), 1e-4)
        _scaled("fixture GCN step loss", float(fx["losses"][0]),
                float(fixture["gcn_step_loss"]), 1e-4)
        _scaled("fixture GCN step", fx["params"][0],
                {k: fixture[f"gcn_step_{k}"] for k in fx["params"][0]}, 1e-4)
    _scaled("fixture GAT logits",
            np.concatenate([r["checks"]["gat"]["logits"] for r in d2]),
            fixture["gat_logits"], 1e-4)
    _, order = dsp.shard_pointcloud(fixture["spconv_coords"], 2, 3,
                                    tuple(fixture["spconv_spatial_shape"]))
    conv = np.empty_like(fixture["spconv_out"])
    conv[order] = np.concatenate([r["checks"]["conv"]["out"] for r in d2])
    _scaled("fixture conv", conv, fixture["spconv_out"], 1e-4)
    log("[dist] dist_small.npz (JAX's dist at D=4) at D=2: GCN loss and "
        "step, GAT logits, sharded conv within 1e-4")

    for world, results in ((2, d2), (1, [d1])):
        for rank, r in enumerate(results):
            tag = f"D={world} rank {rank}"
            log(_time_line(f"{tag} GCN arxiv (rows) SGD steps",
                           r["gcn_rows"]["time"], card))
            log(_time_line(f"{tag} GAT arxiv 4 x 16 steps", r["gat"]["time"],
                           card))
            for c in DIST_CHANNELS:
                log(_time_line(f"{tag} SubM {c}->{c} forward + backward",
                               r[f"conv{c}"]["time"], card))
    log("[dist] staged collectives: gloo copies each CUDA tensor to the "
        "host and back; on one card that measures the host, not NVLink")
    launches = dict(_NONE)
    for r in d2 + d4 + [d1]:
        for k in KERNEL_NAMES:
            launches[k] += int(r["launches"][k])
    log(f"[dist] launches of the ranks' driven runs: "
        f"{ {k: v for k, v in launches.items() if v} }; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_tune(torch, cuda, graphs, tune_dir):
    """The tuner on the Reddit-scale storage at F = 64 and 41, forward and
    with the backward; then a gcn-reddit forward under AUTO, whose metrics
    must show the tuned winners, and each width's AUTO SpMM against the
    other route at 1e-5 scaled by the terms' absolute sum; tune_report on
    the arxiv storage (one candidate). Runs last, on the temporary cache
    file in `tune_dir` that `run` points DGSPARSE_TUNE_CACHE at, and
    deletes it; refuses any other cache file. Returns the phase's
    launches."""
    from dgsparse_tpu_torch import spmm
    from dgsparse_tpu_torch.entry import build_model
    from dgsparse_tpu_torch.kernels import reset_launch_counts
    from dgsparse_tpu_torch.ops.types import Algorithm
    from dgsparse_tpu_torch.utils import metrics, tune
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    path = tune.cache_path()
    if os.path.dirname(os.path.abspath(path)) != os.path.abspath(tune_dir):
        raise AssertionError(f"tune: the cache {path} is not the run's "
                             f"temporary file under {tune_dir}")
    reddit, x, _ = graphs["reddit"]
    winners = {}
    reset_launch_counts()
    for feat in REDDIT_FEATS:
        for with_grad in (False, True):
            best, times = tune.tune_spmm(reddit, feat, with_grad=with_grad)
            if len(times) != 2:
                raise AssertionError(f"tune: candidates {list(times)}")
            winners[feat, with_grad] = best
            mode = ("forward+backward (d_values, d_dense)" if with_grad
                    else "forward")
            log(f"[tune] gcn-reddit storage F={feat} {mode}: best "
                f"{best.name}; " + ", ".join(
                    f"{a.name} {t * 1e6:.2f} us" for a, t in times.items()))
    model = build_model("gcn-reddit", seed=0, device=cuda)
    metrics.reset()
    metrics.enable()
    try:
        with torch.inference_mode():
            model(x, reddit)
    finally:
        metrics.disable()
    torch.cuda.synchronize()
    launches = _counts()
    routes = {dict(k[1:])["feat"]: dict(k[1:])["alg"]
              for k in metrics.counters() if k[0] == "spmm"}
    metrics.reset()
    want = {f: winners[f, False].name for f in REDDIT_FEATS}
    if routes != want:
        raise AssertionError(f"tune: AUTO ran {routes}, tuned {want}")
    gen = torch.Generator(device=cuda).manual_seed(13)
    errs = {}
    for feat in REDDIT_FEATS:
        xf = torch.randn(reddit.shape[1], feat, generator=gen, device=cuda)
        other = ({Algorithm.XLA_SEGMENT, Algorithm.PALLAS_ROW_TILE}
                 - {winners[feat, False]}).pop()
        abs_sum = spmm(reddit.set_values(reddit.storage.values().abs()),
                       xf.abs(), algorithm=Algorithm.XLA_SEGMENT)
        errs[feat] = assert_sum_close(spmm(reddit, xf),
                                      spmm(reddit, xf, algorithm=other),
                                      abs_sum, 1e-5)
    log(f"[tune] gcn-reddit forward under AUTO ran {routes} (by width), the "
        f"tuned forward winners; AUTO vs the other route max_abs_err "
        f"{ {f: f'{e:.3e}' for f, e in errs.items()} }")
    for line in tune.tune_report(graphs["arxiv"][0]).splitlines():
        log(f"[tune] arxiv storage: {line}")
    if tune.cache_path() != path:
        raise AssertionError(f"tune: the cache moved to {tune.cache_path()}")
    log(f"[tune] cache {path}: {len(tune._load())} entries; deleted")
    os.remove(path)
    return launches


def _kernel_entry(name, source, replaces, launches, errs, shapes, timed,
                  card, main="training"):
    t = shapes[timed]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[main],
        "launches_by_path": launches,
        "max_abs_err": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"],
        "ms": t["kernel"],
        "plain_ms": t["plain"],
        "bound_ms": t["bound"],
        "bound_by": t["bound_by"],
        "bound_rate": t["bound_rate"],
        "library_ms": t.get("library"),
        "library_call": t["library_call"],
        "timed_shape": timed,
        "shapes": shapes,
        "card": card,
    }


def run(torch, cuda) -> int:
    """Every phase on `cuda`, then the result lines; 1 on any failure.
    The tuner's cache is a fresh temporary file for the run's length, so
    AUTO follows the hybrid gate until the last phase tunes, and no
    user's cache is read or written (utils/tune.py reads the variable at
    each use)."""
    tune_dir = tempfile.mkdtemp(prefix="dgsparse_tune_")
    saved = os.environ.get("DGSPARSE_TUNE_CACHE")
    os.environ["DGSPARSE_TUNE_CACHE"] = os.path.join(tune_dir, "tune.json")
    try:
        return _run(torch, cuda, tune_dir)
    finally:
        if saved is None:
            os.environ.pop("DGSPARSE_TUNE_CACHE", None)
        else:
            os.environ["DGSPARSE_TUNE_CACHE"] = saved
        shutil.rmtree(tune_dir, ignore_errors=True)


def _run(torch, cuda, tune_dir) -> int:
    try:
        t0 = time.perf_counter()
        name, card = phase_device(torch)
        phase_build()
        errs = phase_kernels(torch, cuda)
        graphs = build_graphs(torch, cuda)
        errs.update(phase_maxmin_kernels(torch, cuda, {
            "arxiv": graphs["arxiv-gin"]}))
        errs.update(phase_hybrid_kernels(torch, cuda, graphs["reddit"][0]))
        errs.update(phase_spconv_kernels(
            torch, cuda, unet_plans(graphs["unet-60k"][0])["enc2"]))
        phase_fixture(torch, cuda)
        phase_attention(torch, cuda)
        runs, serving = phase_slice(torch, cuda, graphs)
        training, _ = phase_training(torch, cuda, graphs)
        sddmm_path = phase_sddmm_hybrid(torch, cuda, graphs["reddit"][0])
        times = phase_numbers(torch, cuda, runs, graphs)
        times.update(phase_hybrid_numbers(torch, cuda, graphs["reddit"][0]))
        phase_attention_numbers(torch, cuda, graphs["reddit"])
        bf16_times, bf16_errs, bf16_path = phase_bf16_hybrid(torch, cuda,
                                                             graphs)
        times.update(bf16_times)
        errs.update(bf16_errs)
        gspmm_path = phase_gspmm_hybrid(torch, cuda, graphs["reddit"][0])
        times.update(phase_spconv_numbers(torch, cuda, graphs["unet-60k"]))
        phase_profile(torch, cuda, graphs)
        utilities = phase_utilities(torch, cuda, graphs)
        phase_native(torch, cuda, graphs["unet-60k"])
        bf16 = phase_bf16_layers(torch, cuda, graphs["unet-60k"])
        phase_checkpoint(torch, cuda, graphs)
        dist = phase_dist(torch, cuda, graphs, card)
        tuned = phase_tune(torch, cuda, graphs, tune_dir)
        if "jax" in sys.modules:
            raise AssertionError("JAX was imported")
        # every kernel of each path launched in that path's run
        for kernel, path, counts in (
                ("csr_spmm", "serving", serving),
                ("csr_spmm", "training", training),
                ("sddmm_csr", "training", training),
                ("spmm_maxmin", "serving", serving),
                ("spmm_maxmin", "training", training),
                ("spmm_maxmin_d_dense", "training", training),
                ("spmm_dense_cells", "serving", serving),
                ("spmm_dense_cells", "training", training),
                ("spmm_bell", "serving", serving),
                ("spmm_bell", "training", training),
                ("sddmm_cells", "sddmm", sddmm_path),
                ("sddmm_cells", "training", training),
                ("spmm_dense_cells_bf16", "bf16_hybrid", bf16_path),
                ("spmm_dense_cells", "bf16_hybrid", bf16_path),
                ("spmm_bell", "bf16_hybrid", bf16_path),
                ("csr_spmm", "bf16_hybrid", bf16_path),
                ("sddmm_cells", "bf16_hybrid", bf16_path),
                ("sddmm_cells_bf16", "bf16_hybrid", bf16_path),
                ("sddmm_csr", "bf16_hybrid", bf16_path),
                ("spmm_dense_cells", "gspmm_hybrid", gspmm_path),
                ("spmm_dense_cells_bf16", "gspmm_hybrid", gspmm_path),
                ("spmm_bell", "gspmm_hybrid", gspmm_path),
                ("csr_spmm", "gspmm_hybrid", gspmm_path),
                ("sddmm_csr", "gspmm_hybrid", gspmm_path),
                ("segment_sum_csr", "gspmm_hybrid", gspmm_path),
                ("spconv_pairs", "serving", serving),
                ("spconv_pairs", "training", training),
                ("spconv_dw", "training", training),
                ("spmm_dense_cells", "utilities", utilities),
                ("spmm_maxmin", "utilities", utilities),
                ("spconv_pairs", "utilities", utilities),
                ("spconv_pairs", "bf16", bf16),
                ("spconv_dw", "bf16", bf16),
                ("csr_spmm", "dist", dist),
                ("sddmm_csr", "dist", dist),
                ("spconv_pairs", "dist", dist),
                ("spconv_dw", "dist", dist),
                ("csr_spmm", "tune", tuned),
                ("spmm_dense_cells", "tune", tuned),
                ("spmm_bell", "tune", tuned),
                ("sddmm_csr", "tune", tuned)):
            if counts[kernel] <= 0:
                raise AssertionError(
                    f"{kernel} never launched on the {path} path")
    except Exception:
        traceback.print_exc()
        return 1

    by_path = {"serving": serving, "training": training,
               "sddmm": sddmm_path, "bf16_hybrid": bf16_path,
               "gspmm_hybrid": gspmm_path,
               "utilities": utilities, "bf16": bf16,
               "dist": dist, "tune": tuned}

    def paths(*names):
        return {path: sum(counts[k] for k in names)
                for path, counts in by_path.items()}

    kernels = [
        _kernel_entry(
            "csr_spmm", "dgsparse_tpu_torch/csrc/spmm_csr.cu",
            "dgsparse_tpu/kernels/pallas_spmm.py:103", paths("csr_spmm"),
            errs["csr_spmm"], times["csr_spmm"], "arxiv conv1 F=256", card),
        _kernel_entry(
            "segment_sum_csr", "dgsparse_tpu_torch/csrc/spmm_csr.cu",
            "dgsparse_tpu/kernels/pallas_spmm.py:103 (segment_matmul as "
            "dgsparse_tpu/ops/segment.py:56 sorted_segment_sum runs it)",
            paths("segment_sum_csr"), errs["segment_sum_csr"],
            times["segment_sum_csr"], "reddit cell materialisation F=1",
            card, main="gspmm_hybrid"),
        _kernel_entry(
            "sddmm_csr", "dgsparse_tpu_torch/csrc/sddmm_csr.cu",
            "dgsparse_tpu/kernels/pallas_sddmm.py:44", paths("sddmm_csr"),
            errs["sddmm_csr"], times["sddmm_csr"],
            "arxiv gat1 d_values H=4 F=16", card),
        _kernel_entry(
            "spmm_maxmin", "dgsparse_tpu_torch/csrc/spmm_maxmin.cu",
            "dgsparse_tpu/kernels/pallas_spmm_maxmin.py:111",
            paths("spmm_maxmin"), errs["spmm_maxmin"],
            times["spmm_maxmin"], "arxiv gin1 forward F=256", card),
        _kernel_entry(
            "spmm_maxmin_bwd", "dgsparse_tpu_torch/csrc/spmm_maxmin.cu",
            "dgsparse_tpu/ops/spmm.py:439 (the XLA winner-mask backward of "
            "spmm_maxmin_esc, dgsparse_tpu/kernels/pallas_spmm_maxmin.py:111)",
            paths("spmm_maxmin_d_dense", "spmm_maxmin_d_values"),
            errs["spmm_maxmin_bwd"], times["spmm_maxmin_bwd"],
            "arxiv gin1 backward d_dense F=256", card),
        _kernel_entry(
            "spmm_dense_cells", "dgsparse_tpu_torch/csrc/spmm_cells.cu",
            "dgsparse_tpu/kernels/pallas_spmm.py:645",
            paths("spmm_dense_cells"), errs["spmm_dense_cells"],
            times["spmm_dense_cells"], "reddit forward F=64", card),
        _kernel_entry(
            "spmm_dense_cells_bf16", "dgsparse_tpu_torch/csrc/spmm_cells.cu",
            "dgsparse_tpu/kernels/pallas_spmm.py:645 "
            "(compute_dtype=bfloat16)",
            paths("spmm_dense_cells_bf16"), errs["spmm_dense_cells_bf16"],
            times["spmm_dense_cells_bf16"], "reddit forward F=64", card,
            main="bf16_hybrid"),
        _kernel_entry(
            "spmm_bell", "dgsparse_tpu_torch/csrc/spmm_bell.cu",
            "dgsparse_tpu/kernels/pallas_spmm.py:844", paths("spmm_bell"),
            errs["spmm_bell"], times["spmm_bell"], "reddit F=64 into out",
            card),
        _kernel_entry(
            "sddmm_cells", "dgsparse_tpu_torch/csrc/spmm_cells.cu",
            "dgsparse_tpu/kernels/pallas_sddmm.py:125", paths("sddmm_cells"),
            errs["sddmm_cells"], times["sddmm_cells"], "reddit F=64", card),
        _kernel_entry(
            "sddmm_cells_bf16", "dgsparse_tpu_torch/csrc/spmm_cells.cu",
            "dgsparse_tpu/kernels/pallas_sddmm.py:125 "
            "(compute_dtype=bfloat16)",
            paths("sddmm_cells_bf16"), errs["sddmm_cells_bf16"],
            times["sddmm_cells_bf16"], "reddit F=64", card,
            main="bf16_hybrid"),
        _kernel_entry(
            "spconv_pairs", "dgsparse_tpu_torch/csrc/spconv.cu",
            "dgsparse_tpu/kernels/pallas_spconv.py:147",
            paths("spconv_pairs"), errs["spconv_pairs"],
            times["spconv_pairs"], "unet-60k enc2 SubM 64->64 forward", card),
        _kernel_entry(
            "spconv_dw", "dgsparse_tpu_torch/csrc/spconv.cu",
            "dgsparse_tpu/kernels/pallas_spconv.py:258", paths("spconv_dw"),
            errs["spconv_dw"], times["spconv_dw"],
            "unet-60k enc2 SubM 64->64 dW", card),
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
        print("chip_smoke: dgsparse_tpu_torch not found beside this "
              "script", file=sys.stderr)
        return 1
    return run(torch, torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
