"""A citation graph made symmetric, of a given size, with heavy-tailed
degrees: the benchmark's frozen stand-in for ogbn-arxiv's structure.

Each undirected pair joins a citing paper to a cited one. How often each
node is cited is fixed by its rank, count(r) proportional to
r^-zipf_exponent (a power-law tail of exponent 1 + 1 / zipf_exponent),
rounded so that the counts sum to `undirected_pairs` exactly; the ranks
sit on the nodes by one permutation that is the same for every seed. The
seed draws who cites: each pair's citing paper uniformly, drawn again
until every pair is distinct and no paper cites itself. So every seed
gives the same number of entries, the same hubs at the same rows, and
degrees that differ only by how often a node cites (about 6.8 on
average); the neighbours differ. The kernels' time, which the longest
rows set, then does not move with the seed. Real locality (papers citing
papers of their own field and year) is not reproduced.

Parameters: num_nodes, undirected_pairs, zipf_exponent.
Returns {"num_nodes": n, "edge_index": int64 [2, 2 * undirected_pairs]},
row 0 the destination (the row of the adjacency) and row 1 the source.
"""

import numpy as np

# the stream of the ranks' placement on the nodes, the same for all seeds
LAYOUT_STREAM = 20_200_101


def cited_counts(n: int, pairs: int, zipf_exponent: float) -> np.ndarray:
    """How often each node is cited: counts by rank, largest remainders
    rounded up, placed on the nodes by the fixed permutation."""
    share = np.arange(1, n + 1, dtype=np.float64) ** -zipf_exponent
    share *= pairs / share.sum()
    by_rank = np.floor(share).astype(np.int64)
    extra = pairs - int(by_rank.sum())
    by_rank[np.argsort(by_rank - share, kind="stable")[:extra]] += 1
    if by_rank[0] > n - 1:
        raise ValueError(f"{pairs} pairs give node of rank 1 more than "
                         f"{n - 1} citers")
    counts = np.empty(n, np.int64)
    counts[np.random.default_rng(LAYOUT_STREAM).permutation(n)] = by_rank
    return counts


def make(params: dict, seed: int) -> dict:
    n = int(params["num_nodes"])
    pairs = int(params["undirected_pairs"])
    cited = np.repeat(np.arange(n, dtype=np.int64),
                      cited_counts(n, pairs, float(params["zipf_exponent"])))
    rng = np.random.default_rng(seed)
    citing = rng.integers(0, n, pairs)
    redraw = np.ones(pairs, bool)
    while redraw.any():
        citing[redraw] = rng.integers(0, n, int(redraw.sum()))
        keys = np.minimum(citing, cited) * n + np.maximum(citing, cited)
        # the first pair of each key in pair order stays; the others and
        # self-citations are drawn again
        _, first = np.unique(keys, return_index=True)
        redraw = np.ones(pairs, bool)
        redraw[first] = False
        redraw |= citing == cited
    edge_index = np.stack([np.concatenate([cited, citing]),
                           np.concatenate([citing, cited])])
    return {"num_nodes": n, "edge_index": edge_index}
