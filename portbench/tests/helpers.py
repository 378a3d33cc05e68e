"""What the benchmark's CPU tests share: the checkout's root, the cells,
and a configuration override that keeps every width and shrinks the
graph."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL_GRAPH = {"graph": {"generator": "citation", "num_nodes": 600,
                         "undirected_pairs": 2400, "zipf_exponent": 0.75}}
CELLS = ("gcn-arxiv.serve", "gcn-arxiv.train", "gat-arxiv.train")
