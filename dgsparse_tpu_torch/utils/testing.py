"""Deterministic synthetic graphs, slow numpy SpMM and semiring SpMM
oracles, a check for sums taken in different orders, and the port's side
of the frozen training fixtures.

`random_csr`, `spmm_oracle`, `sddmm_oracle` and `gspmm_oracle` are
copies of those in `dgsparse_tpu/utils/testing.py` (`collective_volumes`
is its counterpart, over the counters of `dist/comm.py`),
`clustered_graph` of the one in `benchmark/bench_scale.py` and
`random_cloud` of the one in `tests/test_spconv.py`, so the port and
`chip_smoke.py` build the same seeded graphs and voxel clouds without
importing JAX; `gcn_norm_csr` is
the Reddit-scale graph build of `benchmark/bench_train.py`.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np


def random_csr(
    num_rows: int,
    num_cols: int,
    avg_degree: float = 8.0,
    seed: int = 0,
    skew: float = 1.0,
    with_empty_rows: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded random CSR (rowptr, col, values) with power-law-ish degrees."""
    rng = np.random.default_rng(seed)
    # Degrees: lognormal-skewed around avg_degree, some rows forced empty.
    deg = rng.lognormal(mean=np.log(max(avg_degree, 1.0)), sigma=skew,
                        size=num_rows)
    deg = np.minimum(deg.astype(np.int64), num_cols)
    if with_empty_rows:
        deg[rng.random(num_rows) < 0.05] = 0
    rowptr = np.zeros(num_rows + 1, np.int32)
    rowptr[1:] = np.cumsum(deg)
    nnz = int(rowptr[-1])
    col = np.empty(nnz, np.int32)
    for r in range(num_rows):
        d = int(deg[r])
        if d:
            col[rowptr[r]:rowptr[r + 1]] = np.sort(
                rng.choice(num_cols, size=d, replace=False)
            )
    values = rng.standard_normal(nnz).astype(np.float32)
    return rowptr, col, values


def clustered_graph(m: int, n: int, avg_deg: float, seed: int = 0,
                    intra: float = 0.8, comm: int = 194, device=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Community-clustered CSR (rowptr, col), Reddit-like: Poisson degrees
    (at least 1), an `intra` fraction of each row's edges inside its node's
    `comm`-sized community, columns sorted within rows, duplicates kept.

    A copy of `benchmark/bench_scale.py::clustered_graph`, equal to it bit
    for bit; `device` only moves its one stable sort to the card
    (`core.transform.stable_argsort`)."""
    from dgsparse_tpu_torch.core.transform import stable_argsort

    rng = np.random.default_rng(seed)
    deg = np.maximum(rng.poisson(avg_deg, m), 1).astype(np.int64)
    nnz = int(deg.sum())
    row = np.repeat(np.arange(m, dtype=np.int64), deg)
    c0 = (row // comm) * comm
    width = np.minimum(comm, n - c0)
    is_intra = rng.random(nnz) < intra
    col = np.where(
        is_intra,
        c0 + rng.integers(0, 1 << 30, nnz) % width,
        rng.integers(0, n, nnz),
    ).astype(np.int32)
    del c0, width, is_intra
    order = stable_argsort(row * (n + 1) + col, device)
    col = col[order]
    rowptr = np.zeros(m + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    return rowptr.astype(np.int32), col


def hybrid_csr(m: int = 1500, n: int = 1500, deg: float = 40,
               comm: int = 150, intra: float = 0.8, seed: int = 0,
               sparse_block: Optional[int] = 5
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rowptr, col, vals): communities of `comm` nodes holding an `intra`
    share of each row's Poisson(deg) edges, columns drawn with replacement
    (duplicates), sorted within rows; rows 0, 17, 34, ... empty; the rows
    of row block `sparse_block` (None: none) draw every column uniformly,
    so that block holds BELL and residue edges but no dense cell. The
    hybrid tiers' test graph (`tests/test_torch_hybrid.py`), in the manner
    of `tests/test_hybrid.py::clustered_csr`."""
    rng = np.random.default_rng(seed)
    degs = rng.poisson(deg, m).astype(np.int64)
    degs[::17] = 0
    nnz = int(degs.sum())
    row = np.repeat(np.arange(m, dtype=np.int64), degs)
    c0 = (row // comm) * comm
    width = np.minimum(comm, n - c0)
    pick = rng.random(nnz) < intra
    if sparse_block is not None:
        pick &= row // 128 != sparse_block
    col = np.where(pick, c0 + rng.integers(0, 1 << 30, nnz) % width,
                   rng.integers(0, n, nnz)).astype(np.int32)
    col = col[np.argsort(row * (n + 1) + col, kind="stable")]
    rowptr = np.zeros(m + 1, np.int64)
    rowptr[1:] = np.cumsum(degs)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rowptr.astype(np.int32), col, vals


def block_csr(m: int = 700, n: int = 600, seed: int = 0, heavy: bool = False
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(rowptr, col, vals, n): rows in row blocks 0, 2 and 4 with ~150
    edges per (block, 128-column window) cell, rows of blocks 1, 3 and 5
    empty (so a BELL plan's all-padding tiles), rows 0, 17, 34, ... empty,
    duplicates kept, columns unsorted within a row (a self-loop appended
    last). With `heavy`, rows 5, 260 and 600 hold 300, 90 and 70 edges:
    the BELL kernel's long rows, with runs that span tiles. The BELL
    tests' graph (`tests/test_torch_bell.py`)."""
    rng = np.random.default_rng(seed)
    degs = np.where((np.arange(m) // 128) % 2 == 0,
                    rng.poisson(6, m), 0).astype(np.int64)
    degs[::17] = 0
    if heavy:
        degs[[5, 260, 600]] = [300, 90, 70]
    cols = [np.append(np.sort(rng.integers(0, n, d)), r % n)
            if d else np.zeros(0, np.int64) for r, d in enumerate(degs)]
    col = np.concatenate(cols).astype(np.int32)
    rowptr = np.zeros(m + 1, np.int64)
    rowptr[1:] = np.cumsum([len(c) for c in cols])
    vals = rng.standard_normal(len(col)).astype(np.float32)
    return rowptr.astype(np.int32), col, vals, n


def random_cloud(num_points: int = 200, shape=(13, 11, 9), batch: int = 2,
                 seed: int = 0) -> np.ndarray:
    """Seeded coords [n, 4] int32 (batch, x, y, z) of distinct voxels drawn
    from `batch` grids of `shape`."""
    rng = np.random.default_rng(seed)
    total = batch * shape[0] * shape[1] * shape[2]
    flat = rng.choice(total, size=min(num_points, total), replace=False)
    b, r = np.divmod(flat, shape[0] * shape[1] * shape[2])
    x, r = np.divmod(r, shape[1] * shape[2])
    y, z = np.divmod(r, shape[2])
    return np.stack([b, x, y, z], 1).astype(np.int32)


def gcn_norm_csr(rowptr: np.ndarray, col: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """D^-1/2 (A+I) D^-1/2 of a square CSR, straight on the CSR: drop the
    diagonal entries it has, append one self-loop at the end of each row
    (so rows are not sorted by column), and weight edge (r, c) by
    1/sqrt(deg(r) deg(c)) with the degrees counting the loop.

    The Reddit-scale graph build of `benchmark/bench_train.py:82-110`
    (fill_diag sets the diagonal, dgsparse/nn/gcnconv.py), without the
    edge-order lexsort of `gcn_norm_from_edge_index`. Returns (rowptr,
    col, vals float32)."""
    nodes = len(rowptr) - 1
    rows64 = np.repeat(np.arange(nodes, dtype=np.int64), np.diff(rowptr))
    keep = col.astype(np.int64) != rows64
    col = col[keep]
    old_deg = np.bincount(rows64[keep], minlength=nodes)
    rowptr = np.zeros(nodes + 1, np.int64)
    np.cumsum(old_deg, out=rowptr[1:])
    del keep
    # the entry at flat position p of row r moves to p + r; row r's loop
    # lands at rowptr[r + 1] + r
    rows64 = np.repeat(np.arange(nodes, dtype=np.int64), old_deg)
    col2 = np.empty(len(col) + nodes, dtype=col.dtype)
    col2[np.arange(len(col), dtype=np.int64) + rows64] = col
    col2[rowptr[1:].astype(np.int64) + np.arange(nodes)] = np.arange(
        nodes, dtype=col.dtype)
    rowptr = (rowptr.astype(np.int64)
              + np.arange(nodes + 1, dtype=np.int64)).astype(np.int32)
    del rows64, col
    dinv = 1.0 / np.sqrt((old_deg + 1).astype(np.float64))
    coo_row = np.repeat(np.arange(nodes, dtype=np.int64), np.diff(rowptr))
    vals = (dinv[coo_row] * dinv[col2]).astype(np.float32)
    return rowptr, col2, vals


def tf32_round(a) -> np.ndarray:
    """float32 `a` rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero, as the card's `cvt.rna.tf32.f32` rounds: a float32
    whose low 13 mantissa bits are zero (Inf and NaN not handled)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def assert_sum_close(out, ref, abs_sum, tol: float) -> float:
    """Check two sums of the same terms taken in different orders, and
    return max |out - ref|.

    Raises where |out - ref| > tol * (1 + abs_sum), abs_sum being the sum
    of the terms' absolute values: the scale of the rounding error a
    float summation makes (for a row of n terms, up to n·eps·abs_sum),
    which a tolerance relative to |ref| misses where the terms cancel.
    """
    import torch

    diff = (out.float() - ref.float()).abs()
    bound = tol * (1.0 + abs_sum.float())
    bad = diff > bound
    if bool(bad.any()):
        i = int(torch.argmax((diff / bound).flatten()))
        raise AssertionError(
            f"{int(bad.sum())} of {diff.numel()} elements differ by more "
            f"than {tol} * (1 + abs_sum); worst: |out - ref| = "
            f"{diff.flatten()[i].item():.3e}, ref = "
            f"{ref.flatten()[i].item():.3e}, abs_sum = "
            f"{abs_sum.flatten()[i].item():.3e}")
    return diff.max().item() if diff.numel() else 0.0


def spmm_oracle(
    rowptr: np.ndarray,
    col: np.ndarray,
    values: Optional[np.ndarray],
    dense: np.ndarray,
    reduce: str = "sum",
) -> np.ndarray:
    """Slow per-row numpy SpMM (reference include/cuda/spmm_cuda.cuh:10-55):
    empty rows -> 0, mean divides by the degree."""
    m = len(rowptr) - 1
    out = np.zeros((m, dense.shape[1]), dense.dtype)
    for r in range(m):
        s, e = int(rowptr[r]), int(rowptr[r + 1])
        if s == e:
            continue
        contrib = dense[col[s:e]]
        if values is not None:
            contrib = contrib * values[s:e, None]
        if reduce == "sum":
            out[r] = contrib.sum(0)
        elif reduce == "mean":
            out[r] = contrib.mean(0)
        elif reduce == "max":
            out[r] = contrib.max(0)
        elif reduce == "min":
            out[r] = contrib.min(0)
        else:
            raise ValueError(reduce)
    return out


def sddmm_oracle(rowptr, col, d1, d2, reduce="sum"):
    """Slow per-edge numpy SDDMM: out[p] = d1[row(p)] @ d2[col[p]], MEAN
    dividing by the row's degree."""
    nnz = len(col)
    out = np.zeros(nnz, d1.dtype)
    m = len(rowptr) - 1
    for r in range(m):
        s, e = int(rowptr[r]), int(rowptr[r + 1])
        for p in range(s, e):
            out[p] = d1[r] @ d2[col[p]]
            if reduce == "mean":
                out[p] /= (e - s)
    return out


def collective_volumes(fn, *args) -> dict:
    """The elements each collective of `dist/comm.py` passed on this rank
    during one call of fn(*args) (a forward, under no_grad), keyed by
    JAX's primitive names (all_gather, psum, psum_scatter, ppermute), the
    ones used only: per-rank sends, as the JAX helper of this name counts
    them in a traced jaxpr. A halo exchange whose volume grew to
    O(volume) still computes the right numbers; only a volume check
    catches it."""
    import torch

    from dgsparse_tpu_torch.dist import comm

    before = dict(comm.VOLUMES)
    with torch.no_grad():
        fn(*args)
    return {k: v - before[k] for k, v in comm.VOLUMES.items()
            if v != before[k]}


def gspmm_oracle(rowptr, col, values, dense, reduce, compute):
    """Semiring oracle: compute(edge, feat) then reduce."""
    m = len(rowptr) - 1
    out = np.zeros((m, dense.shape[1]), dense.dtype)
    for r in range(m):
        s, e = int(rowptr[r]), int(rowptr[r + 1])
        if s == e:
            continue
        feat = dense[col[s:e]]
        if values is None:
            c = feat
        else:
            ev = values[s:e, None]
            c = {
                "add": feat + ev,
                "sub": feat - ev,
                "mul": feat * ev,
                "div": feat / ev,
            }[compute]
        out[r] = {
            "sum": c.sum(0),
            "mean": c.mean(0),
            "max": c.max(0),
            "min": c.min(0),
        }[reduce]
    return out


# --- the training fixtures (tests/fixtures/torch_port/*.npz) -----------------
#
# train_small.npz keys: the graph ("rowptr", "col", "vals", "x", "y") and,
# per model name ("gcn", "gat"), "<name>/dims" (the constructor's sizes),
# the initial flax params under "<name>/params/<flax path>", the JAX losses
# of 3 Adam steps "<name>/losses" and the step-1 gradients
# "<name>/grads/<flax path>". gin_small.npz has the same keys for "gin"
# (dims: in, hidden, out, num_layers; MAX aggregation), a graph without
# "vals", and the eval-mode forward of the initial params, "gin/out".
# unet_small.npz holds a voxel cloud ("coords", "shape", "x", "y") in place
# of the graph and the same keys for "unet" (dims: in, classes), with
# "unet/out" and the learning rate "unet/lr".


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def fixture_model(fx: dict, name: str, device):
    """(model, adj, x, y) of the fixture's `name` model on `device`, with
    the fixture's initial flax params, in eval mode. For "unet" adj is the
    SparseConvTensor of the fixture's cloud."""
    import torch

    from dgsparse_tpu_torch.core.formats import SparseTensor
    from dgsparse_tpu_torch.nn import (GAT, GCN, GIN, PointCloudUNet,
                                       load_flax_params)
    from dgsparse_tpu_torch.ops.spconv import SparseConvTensor

    n = fx["x"].shape[0]
    x = torch.from_numpy(fx["x"]).to(device)
    y = torch.from_numpy(fx["y"]).long().to(device)
    dims = [int(d) for d in fx[f"{name}/dims"]]
    if name == "unet":
        adj = SparseConvTensor(x, fx["coords"], fx["shape"])
        model = PointCloudUNet(*dims)
    else:
        vals = torch.from_numpy(fx["vals"]) if "vals" in fx else None
        adj = SparseTensor.from_csr(fx["rowptr"], fx["col"], vals,
                                    sparse_sizes=(n, n), device=device)
    if name == "gin":
        model = GIN(*dims[:3], num_layers=dims[3], aggregator_type="max")
    elif name in ("gcn", "gat"):
        model = GCN(*dims) if name == "gcn" else GAT(*dims)
    model = model.to(device).eval()
    load_flax_params(model, _unflatten(_fixture_params(fx, name)))
    return model, adj, x, y


def fixture_gatconv(fx: dict, device):
    """(conv, x) of attention_small.npz: a GATConv with the fixture's
    flax params ("gat/dims": in, out, heads) and its input on `device`."""
    import torch

    from dgsparse_tpu_torch.nn import load_flax_params
    from dgsparse_tpu_torch.nn.gat import GATConv

    conv = GATConv(*(int(d) for d in fx["gat/dims"])).to(device)
    load_flax_params(conv, _unflatten(_fixture_params(fx, "gat")))
    return conv, torch.from_numpy(fx["gat/x"]).to(device)


def _fixture_params(fx: dict, name: str) -> Dict[str, np.ndarray]:
    prefix = f"{name}/params/"
    return {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}


def run_train_fixture(fx: dict, name: str, device, steps: int = 3
                      ) -> Tuple[List[float], Dict[str, np.ndarray]]:
    """The port's run of the fixture's `name` model on `device`: the loss
    of each of `steps` Adam steps and the step-1 gradients keyed by flax
    path, in flax layout. Same graph, inputs, initial params and protocol
    as the JAX run that wrote the fixture (Adam at the fixture's
    "<name>/lr" where it has one, else at 1e-2)."""
    from dgsparse_tpu_torch.entry import ADAM, build_optimizer, train_step
    from dgsparse_tpu_torch.nn._flax import flax_target

    model, adj, x, y = fixture_model(fx, name, device)
    flat = _fixture_params(fx, name)
    opt = build_optimizer(model, float(fx.get(f"{name}/lr", ADAM["lr"])))
    losses, grads = [], {}
    for step in range(steps):
        losses.append(float(train_step(model, opt, x, adj, y)))
        if step == 0:
            for path in flat:
                param, transposed = flax_target(model, path)
                g = param.grad.T if transposed else param.grad
                grads[path] = g.detach().cpu().numpy()
    return losses, grads


def run_gin_fixture(fx: dict, device, steps: int = 3, name: str = "gin"):
    """The port's run of gin_small.npz (or of unet_small.npz with
    name="unet") on `device`: (the eval-mode forward of the initial
    params, the losses of `steps` Adam steps, the step-1 gradients keyed
    by flax path)."""
    import torch

    model, adj, x, _ = fixture_model(fx, name, device)
    with torch.inference_mode():
        out = model(x, adj).cpu().numpy()
    return (out, *run_train_fixture(fx, name, device, steps))


def assert_train_close(losses, grads, ref_losses, ref_grads,
                       loss_tol: float = 1e-4, rtol: float = 1e-4,
                       atol_scale: float = 1e-5) -> Tuple[float, float]:
    """Check a training run against a reference run: losses at
    rtol = atol = loss_tol, each gradient at rtol with atol scaled by its
    own max |g|. Returns (max loss error, max gradient error)."""
    ref_losses = np.asarray(ref_losses, np.float64)
    np.testing.assert_allclose(losses, ref_losses, rtol=loss_tol,
                               atol=loss_tol, err_msg="losses")
    grad_err = 0.0
    for path, ref in ref_grads.items():
        ref = np.asarray(ref)
        atol = atol_scale * float(np.abs(ref).max())
        np.testing.assert_allclose(grads[path], ref, rtol=rtol, atol=atol,
                                   err_msg=path)
        grad_err = max(grad_err, float(np.abs(grads[path] - ref).max()))
    return float(np.abs(np.asarray(losses) - ref_losses).max()), grad_err


def load_mtx(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 Tuple[int, int]]:
    """MatrixMarket coordinate file -> CSR (rowptr, col, values, shape),
    columns sorted within rows (`dgsparse_tpu/utils/testing.py::load_mtx`,
    scipy's reader)."""
    import scipy.io

    mat = scipy.io.mmread(path).tocsr()
    mat.sort_indices()
    return (
        mat.indptr.astype(np.int32),
        mat.indices.astype(np.int32),
        np.asarray(mat.data, np.float32),
        (int(mat.shape[0]), int(mat.shape[1])),
    )


def geometric_graph(n: int = 800, radius: float = 0.06, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Random geometric graph in the unit square with shuffled ids
    (locality that the labels hide): (rowptr, col, n), equal to
    `tests/test_reorder.py::geometric_graph` for the same arguments. Every
    pair closer than `radius` is an edge in both directions; the pairs
    come from a k-d tree here instead of a Python loop over grid cells, so
    a graph of 10^5 nodes takes a second."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    # a hair wider than the radius, then the test's own strict comparison
    pairs = cKDTree(pts).query_pairs(radius * (1 + 1e-9),
                                     output_type="ndarray")
    i, j = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    keep = ((pts[i] - pts[j]) ** 2).sum(1) < radius ** 2
    i, j = i[keep], j[keep]
    shuffle = rng.permutation(n)
    u = shuffle[np.concatenate([i, j])]
    v = shuffle[np.concatenate([j, i])]
    order = np.lexsort((v, u))
    u, v = u[order], v[order]
    rowptr = np.zeros(n + 1, np.int64)
    np.add.at(rowptr, u + 1, 1)
    return np.cumsum(rowptr).astype(np.int32), v.astype(np.int32), n
