"""Times both mappings of `spmm_maxmin_d_dense` and of `sddmm_csr` over a
grid of shapes and reports where each picker (`pick_d_dense`,
`pick_sddmm`) chose the slower one.

    python3 -m dgsparse_tpu_torch.utils.path_sweep [--seed 0]

Needs a CUDA card (it builds the two kernels' sources first). The graphs
are random, made on the card from the seed: lognormal row degrees (sigma
1, 5 % empty rows) scaled to a mean, uniform columns; and the arxiv-scale
graph of `entry.synthetic_graph`. d_dense runs on the winners of a MAX
forward over random features; the two mappings' outputs are held bitwise
equal, the two SDDMM mappings' to 1e-5 of the terms' absolute sum. Each
time is the best of two turns of CUDA-event timings (the second turn in
reverse order). The last line is a JSON summary.
"""

import argparse
import functools
import json
import math
import subprocess
import sys

import torch

# d_dense: (rows, mean degrees, widths)
D_DENSE_GRID = ((62_586, (1.6, 2.6, 3.6, 4.6, 5.6, 7.4, 11.5), (32, 64, 256)),
                (169_343, (1.6, 2.6, 3.6, 4.6, 5.6, 7.4, 8.5, 11.5),
                 (32, 64, 128, 256)),
                (100_000, (3.2, 6.8), (256,)),
                (300_000, (5.2,), (64,)),
                (400_000, (3.2, 6.8), (64,)))
# sddmm_csr: (heads, features a head) in fp32, and in bf16
SDDMM_WIDTHS = ((1, 7), (1, 16), (1, 33), (1, 41), (1, 48), (1, 63),
                (1, 64), (1, 100), (1, 129), (1, 256), (1, 259), (1, 300),
                (4, 9), (4, 16), (4, 41))
SDDMM_BF16 = ((1, 41), (1, 64))
SDDMM_ROWS, SDDMM_DEGREES = 232_965, (20.0, 98.0)


def random_graph(n, degree, gen, device):
    """A Storage of n x n with lognormal row degrees of mean ~`degree`."""
    from dgsparse_tpu_torch import SparseTensor

    deg = torch.empty(n, device=device).log_normal_(
        math.log(degree), 1.0, generator=gen)
    deg[torch.rand(n, device=device, generator=gen) < 0.05] = 0
    deg = (deg * (degree / deg.mean())).long()
    rowptr = torch.zeros(n + 1, dtype=torch.long, device=device)
    rowptr[1:] = deg.cumsum(0)
    nnz = int(rowptr[-1])
    row = torch.repeat_interleave(torch.arange(n, device=device), deg)
    col = torch.randint(0, n, (nnz,), device=device, generator=gen)
    col = (row * n + col).sort().values % n
    return SparseTensor.from_csr(rowptr.int(), col.int(), sparse_sizes=(n, n),
                                 device=device, build_plans=False).storage


def best_of_turns(fns):
    """Microseconds a call of each (fn, args), the best of two turns."""
    from dgsparse_tpu_torch.utils.bench import cuda_time

    t = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            fn, args = fns[k]
            t[k].append(cuda_time(fn, *args, warmup=5, iters=30) * 1e6)
    return {k: min(v) for k, v in t.items()}


def verdict(rows, label, picked, times):
    """One result: which mapping was picked and how it fared."""
    other = min(v for k, v in times.items() if k != picked)
    loss = times[picked] / other - 1.0
    rows.append({"case": label, "picked": picked, **times,
                 "loss": max(loss, 0.0)})
    print(f"[sweep] {label}: " + ", ".join(
        f"{k} {v:.2f} us" for k, v in times.items())
        + f"; picked {picked}"
        + (f", {100 * loss:.1f} % slower than the other" if loss > 0
           else ", the faster"), flush=True)


def d_dense_case(rows, label, st, feat, gen):
    from dgsparse_tpu_torch.kernels import spmm_maxmin as M

    m, n, nnz = st.num_rows, st.num_cols, st.nnz
    x = torch.randn(n, feat, generator=gen, device=st.device)
    _, arg = M.spmm_maxmin_cuda(st.rowptr(), st.col(), None, x)
    g = torch.randn(m, feat, generator=gen, device=st.device)
    args = (st.colptr(), st.row(), st.csr2csc(), None, arg, g, st.rowptr(),
            st.csc_slot())
    masks = functools.partial(M.spmm_maxmin_d_dense_cuda,
                              path=M.d_dense_path(feat, 1, 4))
    column = functools.partial(M.spmm_maxmin_d_dense_cuda,
                               path=M.WARP_PER_COLUMN)
    if not torch.equal(masks(*args), column(*args)):
        raise AssertionError(f"d_dense {label}: the mappings differ")
    times = best_of_turns({"masks": (masks, args),
                           "warp_per_column": (column, args)})
    picked = M.pick_d_dense(feat, 1, 4, 16, nnz, m)
    verdict(rows, f"d_dense {label} rows={m} nnz={nnz} "
            f"degree={nnz / m:.2f} F={feat}",
            "warp_per_column" if picked == M.WARP_PER_COLUMN else "masks",
            times)


def sddmm_case(rows, label, st, heads, feat, dtype, gen):
    from dgsparse_tpu_torch.kernels import sddmm_csr as S
    from dgsparse_tpu_torch.utils.testing import assert_sum_close

    m, n = st.num_rows, st.num_cols
    d1 = torch.randn(m, heads * feat, generator=gen,
                     device=st.device).to(dtype)
    d2 = torch.randn(n, heads * feat, generator=gen,
                     device=st.device).to(dtype)
    args = (st.rowptr(), st.col(), d1, d2, heads)
    path = S.sddmm_path(feat, heads, d1.element_size())
    group = functools.partial(S.sddmm_csr_cuda, path=path)
    warp = functools.partial(S.sddmm_csr_cuda, path=S.WARP_PER_ROW)
    abs_sum = warp(st.rowptr(), st.col(), d1.float().abs(),
                   d2.float().abs(), heads)
    assert_sum_close(group(*args), warp(*args), abs_sum, 1e-5)
    times = best_of_turns({"group": (group, args),
                           "warp_per_row": (warp, args)})
    picked = S.pick_sddmm(feat, heads, d1.element_size())
    verdict(rows, f"sddmm_csr {label} degree={st.nnz / m:.2f} H={heads} "
            f"F={feat} {str(dtype).split('.')[1]} group path {path}",
            "warp_per_row" if picked == S.WARP_PER_ROW else "group", times)


def summary(rows):
    missed = [r for r in rows if r["loss"] > 0]
    return {"cases": len(rows), "picked_slower": len(missed),
            "worst_loss": max((r["loss"] for r in missed), default=0.0),
            "missed": [r["case"] for r in missed]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("path_sweep needs a CUDA card", file=sys.stderr)
        return 1
    from dgsparse_tpu_torch.entry import synthetic_graph
    from dgsparse_tpu_torch.kernels import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.build_all(["spmm_maxmin", "sddmm_csr"])
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(opts.seed)
    d_rows, s_rows = [], []

    st = synthetic_graph("arxiv", device=cuda, gcn_norm=False)[0].storage
    for feat in (32, 64, 128, 256):
        d_dense_case(d_rows, "arxiv-gin", st, feat, gen)
    for n, degrees, feats in D_DENSE_GRID:
        for degree in degrees:
            st = random_graph(n, degree, gen, cuda)
            for feat in feats:
                d_dense_case(d_rows, "random", st, feat, gen)

    graphs = [("arxiv", synthetic_graph("arxiv", device=cuda)[0].storage)]
    graphs += [("random", random_graph(SDDMM_ROWS, d, gen, cuda))
               for d in SDDMM_DEGREES]
    for label, st in graphs:
        for heads, feat in SDDMM_WIDTHS:
            sddmm_case(s_rows, label, st, heads, feat, torch.float32, gen)
        for heads, feat in SDDMM_BF16:
            sddmm_case(s_rows, label, st, heads, feat, torch.bfloat16, gen)
    print(json.dumps({"d_dense": summary(d_rows),
                      "sddmm_csr": summary(s_rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
