"""Sharded sparse ops over the ranks of a `torch.distributed` process group
(counterpart of `dgsparse_tpu/dist/`, with its exports): row-sharded SpMM
and SDDMM (`shard.py`), the sharded GCN and GAT training steps (`gcn.py`,
`gat.py`) and the halo-exchange submanifold conv (`spconv.py`), on the
collectives of `comm.py`; `launch.run_ranks` starts the ranks.
"""

from dgsparse_tpu_torch.dist.spconv import (  # noqa: F401
    ShardedSpConv,
    shard_pointcloud,
    spconv_sharded,
)
from dgsparse_tpu_torch.dist.shard import (
    spmm_feature_sharded,
    ShardedCSR,
    pad_nodes,
    shard_csr,
    sddmm_sharded,
    spmm_sharded,
    spmm_sharded_2d,
)

__all__ = ["ShardedCSR", "shard_csr", "spmm_sharded", "sddmm_sharded",
           "ShardedSpConv", "shard_pointcloud", "spconv_sharded",
           "spmm_sharded_2d", "spmm_feature_sharded", "pad_nodes"]
