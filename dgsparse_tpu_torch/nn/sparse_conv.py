"""Sparse 3-D convolution layers over SparseConvTensor (counterpart of
`dgsparse_tpu/nn/sparse_conv.py`).

Parameters keep the JAX layout and flax's names: `kernel` [k_vol, c_in,
c_out] and `bias` [c_out], drawn as flax's `he_normal` (variance 2/fan_in,
truncated normal, fan_in = k_vol * c_in) and zeros. PyTorch needs the input
width at construction, which flax infers. As in JAX, `param_dtype` is the
parameters' type and `compute_dtype` (None: the features' own) the type
that features, kernel and bias are cast to before the product; the output
comes out in it. bfloat16 runs the kernels' bf16 variants, which sum in
float32.
"""

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from dgsparse_tpu_torch.ops.spconv import (SparseConvTensor, SpConvPlan,
                                           _triple, inverse_plan, spconv)

Size3 = Union[int, Tuple[int, int, int]]


@torch.no_grad()
def he_normal_(kernel: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's he_normal for a kernel [k_vol, c_in, c_out]: a normal of
    variance 2 / (k_vol * c_in) truncated at two standard deviations."""
    fan_in = kernel.shape[0] * kernel.shape[1]
    std = math.sqrt(2.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(kernel, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class _SpConvLayer(nn.Module):
    """The parameters of a sparse conv layer and its product."""

    def __init__(self, in_channels: int, out_channels: int, k_vol: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(he_normal_(
            torch.empty(k_vol, in_channels, out_channels),
            generator).to(param_dtype))
        self.bias = nn.Parameter(torch.zeros(out_channels, dtype=param_dtype))
        self.compute_dtype = compute_dtype

    def _conv(self, features: torch.Tensor, plan) -> torch.Tensor:
        w, b = self.kernel, self.bias
        if self.compute_dtype is not None:
            cd = self.compute_dtype
            features, w, b = features.to(cd), w.to(cd), b.to(cd)
        return spconv(features, w, plan) + b


class SubMConv3d(_SpConvLayer):
    """Submanifold sparse conv: output sites == input sites."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Size3 = 3,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32):
        ks = _triple(kernel_size)
        super().__init__(in_channels, out_channels, math.prod(ks), generator,
                         compute_dtype, param_dtype)
        self.kernel_size = ks

    def plan(self, st: SparseConvTensor) -> SpConvPlan:
        """This conv's rulebook on the sites of `st` (cached on st)."""
        return st.plan_for(self.kernel_size, 1,
                           tuple(k // 2 for k in self.kernel_size))[0]

    def forward(self, st: SparseConvTensor) -> SparseConvTensor:
        return st.replace(features=self._conv(st.features, self.plan(st)))


class SparseConv3d(_SpConvLayer):
    """Strided sparse conv (downsampling): generates new output sites. The
    output tensor's coords, extent and plan cache are kept on the input's,
    so a network's later rulebooks at that level are built once too."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Size3 = 3, stride: Size3 = 2,
                 padding: Size3 = 1,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32):
        ks = _triple(kernel_size)
        super().__init__(in_channels, out_channels, math.prod(ks), generator,
                         compute_dtype, param_dtype)
        self.kernel_size, self.stride = ks, _triple(stride)
        self.padding = _triple(padding)

    def plan(self, st: SparseConvTensor) -> SpConvPlan:
        """This conv's rulebook on the sites of `st` (cached on st)."""
        return st.plan_for(self.kernel_size, self.stride, self.padding)[0]

    def output_sites(self, st: SparseConvTensor) -> SparseConvTensor:
        """The output's sites and extent, without features (cached on
        st)."""
        args = (self.kernel_size, self.stride, self.padding)
        key = ("out", args)
        if key not in st._plans:
            _, out_coords = st.plan_for(*args)
            # the true output extent (s + 2p - k) // stride + 1
            shape = tuple(max((s + 2 * p - k) // v + 1, 1) for s, k, v, p in
                          zip(st.spatial_shape, *args))
            st._plans[key] = SparseConvTensor(None, out_coords, shape,
                                              device=st.device)
        return st._plans[key]

    def forward(self, st: SparseConvTensor) -> SparseConvTensor:
        return self.output_sites(st).replace(
            features=self._conv(st.features, self.plan(st)))


class SparseInverseConv3d(_SpConvLayer):
    """Transposed sparse conv: scatters coarse features back to the exact
    fine sites of a cached encoder plan (the UNet decoder op). Takes the
    coarse features and the fine SparseConvTensor on which the encoder
    conv's (kernel_size, stride, padding) plan lives."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Size3 = 3,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels,
                         math.prod(_triple(kernel_size)), generator,
                         compute_dtype, param_dtype)

    def plan(self, fine_st: SparseConvTensor, kernel_size: Size3 = 3,
             stride: Size3 = 2, padding: Size3 = 1) -> SpConvPlan:
        """The inverse of the encoder conv's rulebook on `fine_st` (cached
        on fine_st)."""
        fwd_plan, _ = fine_st.plan_for(kernel_size, stride, padding)
        key = ("inv", _triple(kernel_size), _triple(stride), _triple(padding),
               str(fine_st.device))
        if key not in fine_st._plans:
            fine_st._plans[key] = inverse_plan(fwd_plan)
        return fine_st._plans[key]

    def forward(self, coarse_features: torch.Tensor,
                fine_st: SparseConvTensor, kernel_size: Size3 = 3,
                stride: Size3 = 2, padding: Size3 = 1) -> SparseConvTensor:
        plan = self.plan(fine_st, kernel_size, stride, padding)
        return fine_st.replace(features=self._conv(coarse_features, plan))


class SparseConvBlock(nn.Module):
    """SubM conv -> LayerNorm (flax's eps 1e-6) -> ReLU, the point-cloud
    block; its submodules carry flax's automatic names."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.SubMConv3d_0 = SubMConv3d(in_channels, out_channels,
                                       kernel_size, generator)
        self.LayerNorm_0 = nn.LayerNorm(out_channels, eps=1e-6)

    def forward(self, st: SparseConvTensor) -> SparseConvTensor:
        st = self.SubMConv3d_0(st)
        return st.replace(features=torch.relu(self.LayerNorm_0(st.features)))
