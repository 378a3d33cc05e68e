"""Deterministic synthetic graphs, a slow numpy SpMM oracle, and a check
for sums taken in different orders.

`random_csr` and `spmm_oracle` are copies of those in
`dgsparse_tpu/utils/testing.py`, so the port and `chip_smoke.py` build the
same seeded graphs without importing JAX.
"""

from typing import Optional, Tuple

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
