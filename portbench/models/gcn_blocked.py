"""The program's side of a `gcn_blocked` configuration: the calls of
`models/gcn.py`, unchanged (the port's adjacency from the raw edge list
and its `nn.GCN` with the benchmark's weights). Only the reference
differs from `gcn`'s, in aggregating over blocks of edges."""

from pathlib import Path

from portbench.lib import spec

gcn = spec.named(Path(__file__).resolve().parents[2], "models", "gcn")

adjacency, nnz, param_map, build = (gcn.adjacency, gcn.nnz, gcn.param_map,
                                    gcn.build)
