"""The port's main paths on seeded synthetic graphs: the GCN forward
(serving) and GCN / GAT training steps.

Counterpart of `__graft_entry__.py::_synthetic_graph`/`entry` (the
Cora-shaped graph, GCN 128 -> 64 -> 7), the arxiv-scale configuration of
`benchmark/bench_train.py:47` (169,343 nodes, GCN 128 -> 256 -> 40), and
the training protocol of `benchmark/bench_train.py:144-156` (Adam at
lr 1e-2 with optax's defaults, mean cross-entropy, the model applied
without dropout). The GAT configurations take the 4-head GAT of
`benchmark/bench_gspmm.py:97-128` (128 -> 4 x 16 -> classes) onto the same
two graphs. Graphs come from `random_csr` with GCN normalization and
self-loops; features and labels from numpy with the same seeds as the JAX
package; weights from a `torch.Generator`.

Every entry point runs on the card unless the caller passes
device="cpu"; without a card, a call that does not name the CPU raises.
"""

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.nn.gat import GAT
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: str             # "gcn" or "gat"
    graph: str             # a key of CONFIGS
    hidden_features: int   # per head for a GAT
    num_heads: int = 1


TRAIN_CONFIGS = {
    "gcn-cora": TrainConfig("gcn", "cora", 64),
    "gcn-arxiv": TrainConfig("gcn", "arxiv", 256),
    "gat-cora": TrainConfig("gat", "cora", 16, 4),
    "gat-arxiv": TrainConfig("gat", "arxiv", 16, 4),
}

# optax.adam's defaults at the learning rate of bench_train.py
ADAM = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises for CUDA on a host without a
    card rather than run anywhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'")
    return device


def synthetic_graph(config: str = "cora", seed: int = 0, device="cuda"
                    ) -> Tuple[SparseTensor, torch.Tensor, torch.Tensor]:
    """(adj, x, y): GCN-normalized adjacency with self-loops, features and
    labels of the named configuration."""
    device = resolve_device(device)
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


def build_model(config: str = "cora", seed: int = 0, device="cuda") -> GCN:
    """The configuration's GCN with weights drawn from a seeded generator,
    in eval mode."""
    device = resolve_device(device)
    cfg = CONFIGS[config]
    gen = torch.Generator().manual_seed(seed)
    model = GCN(cfg.in_features, cfg.hidden_features, cfg.num_classes,
                generator=gen)
    return model.to(device).eval()


def entry(config: str = "cora", device="cuda", seed: int = 0):
    """(model, (x, adj)): the GCN forward of the main path and its inputs."""
    adj, x, _ = synthetic_graph(config, seed, device)
    return build_model(config, seed, device), (x, adj)


def build_trainer(config: str = "gcn-cora", seed: int = 0, device="cuda",
                  data: Optional[tuple] = None):
    """(model, optimizer, (adj, x, y)) for a training configuration.

    The model has seeded weights and sits in eval mode: the JAX step
    applies the model with dropout off (`bench_train.py:150`). `data` is a
    `synthetic_graph` result of the configuration's graph to reuse.
    """
    device = resolve_device(device)
    tc = TRAIN_CONFIGS[config]
    cfg = CONFIGS[tc.graph]
    if data is None:
        data = synthetic_graph(tc.graph, seed, device)
    gen = torch.Generator().manual_seed(seed)
    if tc.model == "gcn":
        model = GCN(cfg.in_features, tc.hidden_features, cfg.num_classes,
                    generator=gen)
    else:
        model = GAT(cfg.in_features, tc.hidden_features, cfg.num_classes,
                    tc.num_heads, generator=gen)
    model = model.to(device).eval()
    return model, build_optimizer(model), data


def build_optimizer(model) -> torch.optim.Adam:
    """Adam at lr 1e-2 with optax's defaults (`bench_train.py:145`)."""
    return torch.optim.Adam(model.parameters(), **ADAM)


def train_step(model, opt, x, adj, y) -> torch.Tensor:
    """One step: forward, mean cross-entropy, backward, Adam update.
    Returns the loss before the update (detached)."""
    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(x, adj), y)
    loss.backward()
    opt.step()
    return loss.detach()


def train(config: str = "gcn-cora", steps: int = 5, device="cuda",
          seed: int = 0) -> List[float]:
    """Run `steps` training steps of a configuration; returns the losses."""
    model, opt, (adj, x, y) = build_trainer(config, seed, device)
    return [float(train_step(model, opt, x, adj, y)) for _ in range(steps)]
