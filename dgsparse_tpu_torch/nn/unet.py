"""The sparse 3-D UNet of `examples/pointcloud_unet.py:49-60`: submanifold
blocks, a strided downsample, an inverse-conv upsample with a skip
connection and a dense head, for per-voxel semantic segmentation.

Widths 8 -> 32 -> 64 -> 32 (+ 32 skip) -> classes; submodules named as
flax names them (`enc1`, `down1`, `enc2`, `up1`, `head`), so
`load_flax_params` fills it from the JAX model's params.
"""

from typing import Dict, Optional

import torch
from torch import nn

from dgsparse_tpu_torch.nn._flax import init_like_flax_dense
from dgsparse_tpu_torch.nn.sparse_conv import (SparseConv3d, SparseConvBlock,
                                               SparseInverseConv3d)
from dgsparse_tpu_torch.ops.spconv import SparseConvTensor, SpConvPlan
from dgsparse_tpu_torch.utils import metrics


class PointCloudUNet(nn.Module):

    def __init__(self, in_channels: int = 8, classes: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc1 = SparseConvBlock(in_channels, 32, generator=generator)
        self.down1 = SparseConv3d(32, 64, stride=2, generator=generator)
        self.enc2 = SparseConvBlock(64, 64, generator=generator)
        self.up1 = SparseInverseConv3d(64, 32, generator=generator)
        self.head = nn.Linear(64, classes)
        init_like_flax_dense(self.head, generator)

    def plans(self, st: SparseConvTensor) -> Dict[str, SpConvPlan]:
        """The rulebook each conv runs on the cloud `st`, by layer name:
        those a forward builds and caches on st."""
        return {"enc1": self.enc1.SubMConv3d_0.plan(st),
                "down1": self.down1.plan(st),
                "enc2": self.enc2.SubMConv3d_0.plan(
                    self.down1.output_sites(st)),
                "up1": self.up1.plan(st)}

    def forward(self, x: torch.Tensor, st: SparseConvTensor) -> torch.Tensor:
        """Logits [n, classes] for the voxel features x [n, in_channels] at
        the sites of `st` (whose rulebooks it caches)."""
        with metrics.span("dgsparse.model.PointCloudUNet.forward",
                          nodes=x.shape[0]):
            e1 = self.enc1(st.replace(features=x))
            d1 = self.enc2(self.down1(e1))
            u1 = self.up1(d1.features, e1)
            return self.head(torch.cat([u1.features, e1.features], -1))
