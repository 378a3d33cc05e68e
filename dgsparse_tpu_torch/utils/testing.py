"""Deterministic synthetic graphs, slow numpy SpMM and semiring SpMM
oracles, a check for sums taken in different orders, and the port's side
of the frozen training fixtures.

`random_csr`, `spmm_oracle` and `gspmm_oracle` are copies of those in
`dgsparse_tpu/utils/testing.py`, so the port and `chip_smoke.py` build the
same seeded graphs without importing JAX.
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


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _torch_param(model, path: str):
    """(parameter, transposed) for a flax param path: a Dense `kernel`
    [in, out] is the transpose of the Linear weight."""
    *mods, leaf = path.split("/")
    for m in mods:
        model = getattr(model, m)
    if leaf == "kernel":
        return model.weight, True
    return getattr(model, leaf), False


def fixture_model(fx: dict, name: str, device):
    """(model, adj, x, y) of the fixture's `name` model on `device`, with
    the fixture's initial flax params, in eval mode."""
    import torch

    from dgsparse_tpu_torch.core.formats import SparseTensor
    from dgsparse_tpu_torch.nn import GAT, GCN, GIN, load_flax_params

    n = fx["x"].shape[0]
    vals = torch.from_numpy(fx["vals"]) if "vals" in fx else None
    adj = SparseTensor.from_csr(fx["rowptr"], fx["col"], vals,
                                sparse_sizes=(n, n), device=device)
    dims = [int(d) for d in fx[f"{name}/dims"]]
    if name == "gin":
        model = GIN(*dims[:3], num_layers=dims[3], aggregator_type="max")
    else:
        model = GCN(*dims) if name == "gcn" else GAT(*dims)
    model = model.to(device).eval()
    load_flax_params(model, _unflatten(_fixture_params(fx, name)))
    x = torch.from_numpy(fx["x"]).to(device)
    y = torch.from_numpy(fx["y"]).long().to(device)
    return model, adj, x, y


def _fixture_params(fx: dict, name: str) -> Dict[str, np.ndarray]:
    prefix = f"{name}/params/"
    return {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}


def run_train_fixture(fx: dict, name: str, device, steps: int = 3
                      ) -> Tuple[List[float], Dict[str, np.ndarray]]:
    """The port's run of the fixture's `name` model on `device`: the loss
    of each of `steps` Adam steps and the step-1 gradients keyed by flax
    path, in flax layout. Same graph, inputs, initial params and protocol
    as the JAX run that wrote the fixture."""
    from dgsparse_tpu_torch.entry import build_optimizer, train_step

    model, adj, x, y = fixture_model(fx, name, device)
    flat = _fixture_params(fx, name)
    opt = build_optimizer(model)
    losses, grads = [], {}
    for step in range(steps):
        losses.append(float(train_step(model, opt, x, adj, y)))
        if step == 0:
            for path in flat:
                param, transposed = _torch_param(model, path)
                g = param.grad.T if transposed else param.grad
                grads[path] = g.detach().cpu().numpy()
    return losses, grads


def run_gin_fixture(fx: dict, device, steps: int = 3):
    """The port's run of gin_small.npz on `device`: (the eval-mode forward
    of the initial params, the losses of `steps` Adam steps, the step-1
    gradients keyed by flax path)."""
    import torch

    model, adj, x, _ = fixture_model(fx, "gin", device)
    with torch.inference_mode():
        out = model(x, adj).cpu().numpy()
    return (out, *run_train_fixture(fx, "gin", device, steps))


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
