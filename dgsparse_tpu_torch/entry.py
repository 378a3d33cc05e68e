"""The port's main paths on seeded synthetic graphs and point clouds: GCN,
GIN-max and point-cloud UNet forwards (serving) and GCN / GAT / GIN-max /
UNet training steps.

Counterpart of `__graft_entry__.py::_synthetic_graph`/`entry` (the
Cora-shaped graph, GCN 128 -> 64 -> 7), the arxiv-scale configurations of
`benchmark/bench_train.py:50-53` (169,343 nodes, 128 -> 256 -> 40), and
the training protocol of `benchmark/bench_train.py:144-156` (Adam at
lr 1e-2 with optax's defaults, mean cross-entropy, the model applied
without dropout). The GAT configurations take the 4-head GAT of
`benchmark/bench_gspmm.py:97-128` (128 -> 4 x 16 -> classes) onto the
Cora and arxiv graphs. The GIN-max configurations are
`arxiv-scale-gin-max` of `bench_train.py:53` with 3 layers instead of 2,
so that the second GINConv maxes over hidden features that need a
gradient and a training step runs the MAX backward; at Cora they take the
port's Cora widths. "gcn-reddit" is the Reddit-scale GCN of
`bench_train.py:54-58` (232,965 nodes, ~114.4 M edges with self-loops,
602 -> 64 -> 41): its graph is `clustered_graph` with the self-loops and
normalization of `bench_train.py:82-110` (`utils.testing.gcn_norm_csr`),
and its storage gets a hybrid plan, so its SpMMs run the hybrid tiers.
"gat-reddit" is the same 4-head GAT as gat-cora and gat-arxiv (602 -> 16
x 4 -> 41) on that graph (its values are ignored: attention is structure
only); with its 2^21 or more edges on a hybrid plan, its layers take the
slot-space attention (`nn/gat.py`).
The other GCN and GAT graphs come from `random_csr` with GCN
normalization and self-loops; the GIN graph is `random_csr`'s structure as it is, with no values and no
self-loops (`bench_train.py:121-135`); features and labels from numpy with
the same seeds as the JAX package; weights from a `torch.Generator`.
`synthetic_graph` adds its host build times per phase to the storage's
`build_seconds`.

"unet" and "unet-60k" are the sparse UNet of
`examples/pointcloud_unet.py:49-60` (8 -> 32 -> 64 -> 32 -> 8 classes) on
a voxel cloud drawn as that example draws it (`synthetic_cloud`): its own
20,000 voxels in 128 x 128 x 32, and the 60,000 voxels in 128 x 128 x 64
of `benchmark/bench_spconv.py:31-50`. It trains as the example does: Adam
at lr 1e-3 with optax's defaults, mean cross-entropy. Its `adj` slot is
the cloud's SparseConvTensor, which caches the rulebooks.

Every entry point runs on the card unless the caller passes
device="cpu"; without a card, a call that does not name the CPU raises.
"""

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.nn.gat import GAT
from dgsparse_tpu_torch.nn.gcn import GCN, get_gcn_dcsr_from_edge_index
from dgsparse_tpu_torch.nn.gin import GIN
from dgsparse_tpu_torch.nn.unet import PointCloudUNet
from dgsparse_tpu_torch.ops.spconv import SparseConvTensor
from dgsparse_tpu_torch.utils import metrics
from dgsparse_tpu_torch.utils.testing import (clustered_graph, gcn_norm_csr,
                                              random_csr)


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    num_nodes: int
    avg_degree: float      # random_csr's lognormal degree parameter, or
                           # clustered_graph's Poisson mean
    in_features: int
    hidden_features: int
    num_classes: int
    generator: str = "random_csr"      # or "clustered_graph"


CONFIGS = {
    "cora": GraphConfig(2708, 4.0, 128, 64, 7),
    "arxiv": GraphConfig(169_343, 4.2, 128, 256, 40),
    "reddit": GraphConfig(232_965, 492.0, 602, 64, 41, "clustered_graph"),
}


@dataclasses.dataclass(frozen=True)
class CloudConfig:
    num_points: int
    spatial_shape: Tuple[int, int, int]
    in_features: int = 8
    num_classes: int = 8


CLOUDS = {
    "unet": CloudConfig(20_000, (128, 128, 32)),
    "unet-60k": CloudConfig(60_000, (128, 128, 64)),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: str             # "gcn", "gat", "gin" or "unet"
    graph: str             # a key of CONFIGS, or of CLOUDS for a UNet
    hidden_features: int   # per head for a GAT
    num_heads: int = 1
    num_layers: int = 2    # a GIN's, readout included
    aggregator: str = "sum"
    lr: float = 1e-2       # Adam's


TRAIN_CONFIGS = {
    "gcn-cora": TrainConfig("gcn", "cora", 64),
    "gcn-arxiv": TrainConfig("gcn", "arxiv", 256),
    "gat-cora": TrainConfig("gat", "cora", 16, 4),
    "gat-arxiv": TrainConfig("gat", "arxiv", 16, 4),
    "gin-max-cora": TrainConfig("gin", "cora", 64, num_layers=3,
                                aggregator="max"),
    "gin-max-arxiv": TrainConfig("gin", "arxiv", 256, num_layers=3,
                                 aggregator="max"),
    "gcn-reddit": TrainConfig("gcn", "reddit", 64),
    "gat-reddit": TrainConfig("gat", "reddit", 16, 4),
    "unet": TrainConfig("unet", "unet", 32, lr=1e-3),
    "unet-60k": TrainConfig("unet", "unet-60k", 32, lr=1e-3),
}

# the forwards served: the GCN of each graph (a bare graph name means it),
# the 3-layer GIN-max, the Reddit-scale GAT and the point-cloud UNet
SERVE_CONFIGS = {name: TRAIN_CONFIGS[name] for name in
                 ("gcn-cora", "gcn-arxiv", "gin-max-cora", "gin-max-arxiv",
                  "gcn-reddit", "gat-reddit", "unet", "unet-60k")}

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


def synthetic_graph(config: str = "cora", seed: int = 0, device="cuda",
                    gcn_norm: bool = True
                    ) -> Tuple[SparseTensor, torch.Tensor, torch.Tensor]:
    """(adj, x, y) of the named graph: the GCN-normalized adjacency with
    self-loops, or with gcn_norm=False the bare structure (no values, no
    self-loops; a GIN's graph), then features and labels."""
    device = resolve_device(device)
    cfg = CONFIGS[config]
    n = cfg.num_nodes
    t0 = time.perf_counter()
    if cfg.generator == "clustered_graph":
        rowptr, col = clustered_graph(n, n, cfg.avg_degree, seed=seed,
                                      device=device)
    else:
        rowptr, col, _ = random_csr(n, n, avg_degree=cfg.avg_degree,
                                    seed=seed, with_empty_rows=False)
    t1 = time.perf_counter()
    seconds = {"generator": t1 - t0}
    if gcn_norm and cfg.generator == "clustered_graph":
        rowptr, col, vals = gcn_norm_csr(rowptr, col)
        seconds["gcn_norm"] = time.perf_counter() - t1
        adj = SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                                    sparse_sizes=(n, n), device=device)
        del rowptr, col, vals
    elif gcn_norm:
        coo_row = np.repeat(np.arange(n, dtype=np.int32), np.diff(rowptr))
        adj = get_gcn_dcsr_from_edge_index(np.stack([coo_row, col]), n,
                                           device=device)
    else:
        adj = SparseTensor.from_csr(rowptr, col, sparse_sizes=(n, n),
                                    device=device)
    t2 = time.perf_counter()
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n, cfg.in_features)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, n).astype(np.int64)
    x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    seconds["features"] = time.perf_counter() - t2
    seconds["total"] = time.perf_counter() - t0
    adj.storage.build_seconds.update(seconds)
    return adj, x, y


def synthetic_cloud(config: str = "unet", seed: int = 0, device="cuda"
                    ) -> Tuple[SparseConvTensor, torch.Tensor, torch.Tensor]:
    """(st, x, y) of the named cloud: distinct voxels of batch 0 drawn
    without replacement from its grid, features [n, 8] and labels [n] in 8
    classes, with the draws of `examples/pointcloud_unet.py:37-46` (seed 0
    gives that example's cloud). st is the SparseConvTensor of the sites
    with the features x."""
    device = resolve_device(device)
    cfg = CLOUDS[config]
    shape = cfg.spatial_shape
    rng = np.random.default_rng(seed)
    total = shape[0] * shape[1] * shape[2]
    flat = rng.choice(total, size=min(cfg.num_points, total), replace=False)
    x_, r = np.divmod(flat, shape[1] * shape[2])
    y_, z_ = np.divmod(r, shape[2])
    coords = np.stack([np.zeros_like(x_), x_, y_, z_], 1).astype(np.int32)
    x = rng.standard_normal((len(coords), cfg.in_features)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, len(coords))
    x = torch.from_numpy(x).to(device)
    return (SparseConvTensor(x, coords, shape), x,
            torch.from_numpy(y.astype(np.int64)).to(device))


def synthetic_data(tc: TrainConfig, seed: int = 0, device="cuda"):
    """(adj, x, y) a configuration's model takes: its cloud for a UNet,
    else its graph (bare for a GIN)."""
    if tc.model == "unet":
        return synthetic_cloud(tc.graph, seed, device)
    return synthetic_graph(tc.graph, seed, device, gcn_norm=tc.model != "gin")


def _model_config(config: str) -> TrainConfig:
    """A model configuration, or a bare graph name for its GCN."""
    if config in CONFIGS:
        return TrainConfig("gcn", config, CONFIGS[config].hidden_features)
    return TRAIN_CONFIGS[config]


def _make_model(tc: TrainConfig, generator: torch.Generator):
    if tc.model == "unet":
        cloud = CLOUDS[tc.graph]
        return PointCloudUNet(cloud.in_features, cloud.num_classes,
                              generator=generator)
    cfg = CONFIGS[tc.graph]
    if tc.model == "gcn":
        return GCN(cfg.in_features, tc.hidden_features, cfg.num_classes,
                   generator=generator)
    if tc.model == "gat":
        return GAT(cfg.in_features, tc.hidden_features, cfg.num_classes,
                   tc.num_heads, generator=generator)
    return GIN(cfg.in_features, tc.hidden_features, cfg.num_classes,
               tc.num_layers, tc.aggregator, generator=generator)


def build_model(config: str = "cora", seed: int = 0, device="cuda"):
    """The model of a serving configuration (`SERVE_CONFIGS`, or a graph
    name of `CONFIGS` for its GCN) with weights drawn from a seeded
    generator, in eval mode."""
    device = resolve_device(device)
    model = _make_model(_model_config(config),
                        torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def entry(config: str = "cora", device="cuda", seed: int = 0):
    """(model, (x, adj)): the forward of a serving configuration and its
    inputs, on the graph that model takes."""
    adj, x, _ = synthetic_data(_model_config(config), seed, device)
    return build_model(config, seed, device), (x, adj)


def build_trainer(config: str = "gcn-cora", seed: int = 0, device="cuda",
                  data: Optional[tuple] = None):
    """(model, optimizer, (adj, x, y)) for a training configuration.

    The model has seeded weights and sits in eval mode: the JAX step
    applies the model with dropout off (`bench_train.py:150`). `data` is a
    `synthetic_data` result of the configuration's graph or cloud to
    reuse.
    """
    device = resolve_device(device)
    tc = TRAIN_CONFIGS[config]
    if data is None:
        data = synthetic_data(tc, seed, device)
    model = _make_model(tc, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    return model, build_optimizer(model, tc.lr), data


def build_optimizer(model, lr: float = ADAM["lr"]) -> torch.optim.Adam:
    """Adam with optax's defaults, at lr 1e-2 (`bench_train.py:145`) unless
    given another."""
    with metrics.span("dgsparse.setup.optimizer"):
        return torch.optim.Adam(model.parameters(), **{**ADAM, "lr": lr})


def train_step(model, opt, x, adj, y) -> torch.Tensor:
    """One step: forward, mean cross-entropy, backward, Adam update.
    Returns the loss before the update (detached). With tracing on, the
    span `dgsparse.step` holds its phases' spans."""
    with metrics.span("dgsparse.step"):
        opt.zero_grad(set_to_none=True)
        with metrics.span("dgsparse.step.forward"):
            out = model(x, adj)
        with metrics.span("dgsparse.step.loss"):
            loss = F.cross_entropy(out, y)
        # the logits are not saved for backward: free them before it
        del out
        with metrics.span("dgsparse.step.backward"):
            loss.backward()
        with metrics.span("dgsparse.step.optimizer"):
            opt.step()
        return loss.detach()


def train(config: str = "gcn-cora", steps: int = 5, device="cuda",
          seed: int = 0) -> List[float]:
    """Run `steps` training steps of a configuration; returns the losses."""
    model, opt, (adj, x, y) = build_trainer(config, seed, device)
    return [float(train_step(model, opt, x, adj, y)) for _ in range(steps)]
