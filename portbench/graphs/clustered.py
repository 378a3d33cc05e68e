"""A community-clustered graph with Poisson degrees: the benchmark's
stand-in for Reddit's structure (Hamilton, Ying and Leskovec 2017) until
the real graph is in the repository.

Each node's degree is Poisson(avg_degree), at least 1. An `intra` share
of the edges (one draw an edge) join a node to one of its own community,
the `community` consecutive nodes its id falls among; the others join it
to any node, uniformly. Duplicates and self-edges are kept as drawn, and
each row's columns are sorted. For the same parameters and seed it draws
what the port's `utils/testing.py::clustered_graph` and
`benchmark/bench_scale.py::clustered_graph` draw, bit for bit, with numpy
alone (one stable argsort on the host). The real graph's heavy-tailed
degrees, its symmetry and its real communities are not reproduced.

Parameters: num_nodes, avg_degree, community, intra.
Returns {"num_nodes": n, "edge_index": int64 [2, nnz]}, row 0 the
destination (the row of the adjacency) and row 1 the source.
"""

import numpy as np


def make(params: dict, seed: int) -> dict:
    n = int(params["num_nodes"])
    comm = int(params["community"])
    rng = np.random.default_rng(seed)
    deg = np.maximum(rng.poisson(float(params["avg_degree"]), n),
                     1).astype(np.int64)
    nnz = int(deg.sum())
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    c0 = (row // comm) * comm
    width = np.minimum(comm, n - c0)
    is_intra = rng.random(nnz) < float(params["intra"])
    col = np.where(is_intra, c0 + rng.integers(0, 1 << 30, nnz) % width,
                   rng.integers(0, n, nnz)).astype(np.int32)
    del c0, width, is_intra
    col = col[np.argsort(row * (n + 1) + col, kind="stable")]
    return {"num_nodes": n,
            "edge_index": np.stack([row, col.astype(np.int64)])}
