"""Plan-time graph reordering (reverse Cuthill-McKee).

Counterpart of `dgsparse_tpu/core/reorder.py`, the same numpy algorithm
(stable sorts throughout, so the permutation equals JAX's). Relabeling
vertices to cluster edges near the diagonal raises the fill of the hybrid
plan's (row block x column window) cells and the reuse of each gathered
row in the card's L2 when the graph has locality (meshes, point clouds,
road networks). Structure is static, so this is a one-time host cost.
"""

from typing import Optional, Tuple

import numpy as np

from dgsparse_tpu_torch.core.formats import _host


def rcm_permutation(rowptr: np.ndarray, col: np.ndarray,
                    num_nodes: Optional[int] = None) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the (symmetrized) graph.

    Returns `perm` with perm[new_id] = old_id.
    """
    rowptr, col = _host(rowptr), _host(col)
    n = num_nodes if num_nodes is not None else len(rowptr) - 1

    # symmetrize adjacency (CSR of A + A^T) for traversal
    row = np.repeat(np.arange(len(rowptr) - 1, dtype=np.int32),
                    np.diff(rowptr))
    u = np.concatenate([row, col])
    v = np.concatenate([col, row])
    keep = (u < n) & (v < n)
    u, v = u[keep], v[keep]
    order = np.lexsort((v, u))
    u, v = u[order], v[order]
    sym_rowptr = np.zeros(n + 1, np.int64)
    np.add.at(sym_rowptr, u + 1, 1)
    sym_rowptr = np.cumsum(sym_rowptr)
    deg = np.diff(sym_rowptr)

    visited = np.zeros(n, bool)
    result = np.empty(n, np.int32)
    pos = 0
    # process components, seeding each from its min-degree unvisited node
    node_order = np.argsort(deg, kind="stable")
    seed_ptr = 0
    while pos < n:
        while seed_ptr < n and visited[node_order[seed_ptr]]:
            seed_ptr += 1
        seed = node_order[seed_ptr]
        visited[seed] = True
        queue = [seed]
        qhead = 0
        result[pos] = seed
        pos += 1
        while qhead < len(queue):
            x = queue[qhead]
            qhead += 1
            nbrs = v[sym_rowptr[x]:sym_rowptr[x + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = np.unique(nbrs)
                nbrs = nbrs[~visited[nbrs]]
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                for nb in nbrs:
                    result[pos] = nb
                    pos += 1
                    queue.append(nb)
    return result[::-1].copy()  # reverse (the "R" in RCM)


def permute_csr(rowptr: np.ndarray, col: np.ndarray,
                values: Optional[np.ndarray],
                perm: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                           Optional[np.ndarray]]:
    """Symmetric relabel: new_id i corresponds to old node perm[i]; both row
    and column spaces are relabeled (square adjacency). Tensors or arrays
    in, numpy arrays out."""
    rowptr, col, perm = _host(rowptr), _host(col), _host(perm)
    n = len(perm)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    row = np.repeat(np.arange(len(rowptr) - 1, dtype=np.int64),
                    np.diff(rowptr))
    new_row = inv[row]
    new_col = inv[col]
    order = np.lexsort((new_col, new_row))
    new_row, new_col = new_row[order], new_col[order]
    new_rowptr = np.zeros(n + 1, np.int64)
    np.add.at(new_rowptr, new_row + 1, 1)
    new_rowptr = np.cumsum(new_rowptr).astype(np.int32)
    new_vals = None if values is None else _host(values)[order]
    return new_rowptr, new_col.astype(np.int32), new_vals


def bandwidth(rowptr: np.ndarray, col: np.ndarray) -> int:
    """Max |row - col| over edges (diagnostic)."""
    rowptr, col = _host(rowptr), _host(col)
    row = np.repeat(np.arange(len(rowptr) - 1, dtype=np.int64),
                    np.diff(rowptr))
    return int(np.abs(row - col).max()) if len(col) else 0
