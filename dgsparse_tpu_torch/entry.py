"""The port's main path: a 2-layer GCN forward on a seeded synthetic graph.

Counterpart of `__graft_entry__.py::_synthetic_graph`/`entry` (the
Cora-shaped graph, GCN 128 -> 64 -> 7) plus the arxiv-scale configuration of
`benchmark/bench_train.py:50` (169,343 nodes, GCN 128 -> 256 -> 40). Graphs
come from `random_csr` with GCN normalization and self-loops; features from
numpy with the same seeds as the JAX package; weights from a
`torch.Generator`.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.nn.gcn import GCN, get_gcn_dcsr_from_edge_index
from dgsparse_tpu_torch.utils.testing import random_csr


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    num_nodes: int
    avg_degree: float      # lognormal degree parameter of random_csr
    in_features: int
    hidden_features: int
    num_classes: int


CONFIGS = {
    "cora": GraphConfig(2708, 4.0, 128, 64, 7),
    "arxiv": GraphConfig(169_343, 4.2, 128, 256, 40),
}


def synthetic_graph(config: str = "cora", seed: int = 0, device=None
                    ) -> Tuple[SparseTensor, torch.Tensor, torch.Tensor]:
    """(adj, x, y): GCN-normalized adjacency with self-loops, features and
    labels of the named configuration."""
    cfg = CONFIGS[config]
    n = cfg.num_nodes
    rowptr, col, _ = random_csr(n, n, avg_degree=cfg.avg_degree, seed=seed,
                                with_empty_rows=False)
    coo_row = np.repeat(np.arange(n, dtype=np.int32), np.diff(rowptr))
    adj = get_gcn_dcsr_from_edge_index(np.stack([coo_row, col]), n,
                                       device=device)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n, cfg.in_features)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, n).astype(np.int64)
    return adj, torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def build_model(config: str = "cora", seed: int = 0, device=None) -> GCN:
    """The configuration's GCN with weights drawn from a seeded generator,
    in eval mode."""
    cfg = CONFIGS[config]
    gen = torch.Generator().manual_seed(seed)
    model = GCN(cfg.in_features, cfg.hidden_features, cfg.num_classes,
                generator=gen)
    return model.to(device).eval()


def entry(config: str = "cora", device=None, seed: int = 0):
    """(model, (x, adj)): the GCN forward of the main path and its inputs."""
    adj, x, _ = synthetic_graph(config, seed, device)
    return build_model(config, seed, device), (x, adj)

