"""3-D submanifold and strided sparse convolution (spconv): the host
rulebook, its plan, the autograd op and SparseConvTensor.

Counterpart of `dgsparse_tpu/ops/spconv.py`, with its names and layouts at
the public functions: features [n_in, c_in], kernel [k_vol, c_in, c_out],
coords [n, 4] int (batch, x, y, z), kernel offsets enumerated x-major.

- The rulebook is built once per (coords, kernel, stride, padding) on the
  host (`build_rulebook`): under JAX's conditions (clouds of >= 2048
  voxels; strided, or submanifold with odd kernels at padding k // 2) by
  the native C++ builder (`native.py`, a voxel hash), else, and wherever
  that library did not load, in numpy (sorted keys and searchsorted in
  place of a hash table). Both give each offset's pairs by ascending
  output id, so the plan does not depend on the builder.
- `SpConvPlan` keeps the JAX plan's rulebook fields (the Q-padded
  imap/omap/widx stream, o2i/i2o, knnz/kpos/qkpos) and, in place of its
  TPU edge-tile plans and slot arrays, the layouts the Hopper kernels read
  (`kernels/spconv.py`): the pairs as a CSR over the outputs (`by_out`,
  the forward) and over the inputs (`by_in`, dX), and grouped by offset
  (`by_offset`, dW).
- `spconv` runs `spconv_pairs` over `by_out` with W forward and over
  `by_in` with Wᵀ for dX, and `spconv_dw` over `by_offset` for dW: the
  fused route. Under `separate_mid` (submanifold) the
  center tap is one plain product over all points (`torch.matmul`), as in
  the JAX package.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dgsparse_tpu_torch.kernels.spconv import (OffsetPairs, PairCSR,
                                               offset_pairs, pair_csr,
                                               spconv_dw, spconv_pairs)
from dgsparse_tpu_torch.utils import metrics


def _triple(x) -> Tuple[int, int, int]:
    if isinstance(x, (tuple, list)):
        assert len(x) == 3
        return tuple(int(v) for v in x)
    return (int(x),) * 3


@dataclasses.dataclass
class SpConvPlan:
    """Static rulebook for one (coords, kernel, stride, padding) combo.

    imap/omap: concatenated (input_id, output_id) pairs grouped by kernel
    offset, each offset's segment padded to a multiple of `quant` with
    (-1, 0) sentinels; widx gives the kernel-offset id per pair. kpos/qkpos
    are the raw/quantized exclusive scans of per-offset pair counts. o2i
    [k_vol, num_out] / i2o [k_vol, num_in] give the input (output) id per
    (offset, output (input)), -1 for none. Tensors sit on one device.
    """

    imap: torch.Tensor
    omap: torch.Tensor
    widx: torch.Tensor
    o2i: torch.Tensor
    i2o: torch.Tensor
    by_out: PairCSR          # destination = output id, source = input id
    by_in: PairCSR           # destination = input id, source = output id
    by_offset: OffsetPairs   # the kpos runs, for dW
    knnz: tuple
    kpos: tuple
    qkpos: tuple
    num_out: int
    num_in: int
    k_vol: int
    separate_mid: bool       # center tap computed as a dense matmul
    quant: int = 128

    @property
    def total_pairs(self) -> int:
        return int(self.kpos[-1])

    @property
    def device(self) -> torch.device:
        return self.widx.device

    def to(self, device) -> "SpConvPlan":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, PairCSR, OffsetPairs)):
                kw[f.name] = v.to(device)
        return dataclasses.replace(self, **kw)


def _encode(coords: np.ndarray, dims: np.ndarray) -> np.ndarray:
    """Pack (b, x, y, z) int coords into a single int64 key."""
    c = coords.astype(np.int64)
    return ((c[:, 0] * dims[0] + c[:, 1]) * dims[1] + c[:, 2]) * dims[2] \
        + c[:, 3]


def _offsets(ks):
    return [(i, j, k) for i in range(ks[0]) for j in range(ks[1])
            for k in range(ks[2])]


def _out_extent(spatial_shape, ks, st, pad):
    return [(spatial_shape[i] + 2 * pad[i] - ks[i]) // st[i] + 1
            for i in range(3)]


def build_rulebook(
    coords: np.ndarray,
    kernel_size=3,
    stride=1,
    padding=0,
    spatial_shape: Optional[Sequence[int]] = None,
    submanifold: Optional[bool] = None,
    quant: int = 128,
    device="cpu",
) -> Tuple[SpConvPlan, np.ndarray]:
    """Host-side rulebook builder (`dgsparse_tpu/ops/spconv.py::
    build_rulebook`): the native builder under JAX's conditions (see the
    module docstring), else numpy.

    coords: [nnz, 4] int (batch, x, y, z). Returns (plan on `device`,
    out_coords int32). Submanifold (stride 1) keeps out_coords == coords and
    marks the center tap for the dense-matmul path; a strided conv
    generates the downsampled unique output coords, sorted (b, x, y, z).
    """
    with metrics.span("dgsparse.spconv.rulebook", voxels=len(coords)):
        return _build_rulebook(coords, kernel_size, stride, padding,
                               spatial_shape, submanifold, quant, device)


def _build_rulebook(coords, kernel_size, stride, padding, spatial_shape,
                    submanifold, quant, device):
    coords = np.asarray(coords, np.int64)
    nnz = len(coords)
    ks, st, pad = _triple(kernel_size), _triple(stride), _triple(padding)
    k_vol = ks[0] * ks[1] * ks[2]
    if submanifold is None:
        submanifold = all(s == 1 for s in st)
    if spatial_shape is None:
        spatial_shape = tuple(int(coords[:, i + 1].max()) + 1
                              for i in range(3))
    dims = np.array([s + max(ks) + 2 for s in spatial_shape], np.int64)

    in_keys = _encode(coords, dims)
    in_order = np.argsort(in_keys)
    in_keys_sorted = in_keys[in_order]

    def lookup(keys: np.ndarray) -> np.ndarray:
        """Sorted-key probe (-1 miss)."""
        pos = np.searchsorted(in_keys_sorted, keys)
        pos = np.minimum(pos, len(in_keys_sorted) - 1)
        hit = in_keys_sorted[pos] == keys
        return np.where(hit, in_order[pos], -1).astype(np.int64)

    out_sp = _out_extent(spatial_shape, ks, st, pad)
    mid = (k_vol - 1) // 2
    separate_mid = bool(submanifold)
    nat = _native_rulebook(coords, ks, st, pad, spatial_shape, submanifold)
    if nat is not None:
        out_coords, imaps, omaps, knnz = nat
        return (_finalize_plan(imaps, omaps, knnz, k_vol, len(out_coords),
                               nnz, separate_mid, quant, device),
                out_coords.astype(np.int32))
    if submanifold:
        out_coords = coords.copy()
    else:
        # output sites: positions whose strided window anchored at
        # out * stride - padding covers at least one input voxel
        cand = []
        for off in _offsets(ks):
            v = coords[:, 1:4] + np.array(pad) - np.array(off)
            ok_mask = ((v % np.array(st)) == 0).all(1) & (v >= 0).all(1)
            o = v[ok_mask] // np.array(st)
            in_range = (o < np.array(out_sp)).all(1)
            cand.append(np.concatenate(
                [coords[ok_mask][in_range][:, :1], o[in_range]], 1))
        cand = np.concatenate(cand, 0)
        # keys over the output extent, so their order is (b, x, y, z)
        odims = np.array([s + 2 for s in out_sp], np.int64)
        _, first = np.unique(_encode(cand, odims), return_index=True)
        out_coords = cand[first]
    num_out = len(out_coords)

    imaps, omaps, knnz = [], [], []
    for kp, off in enumerate(_offsets(ks)):
        if separate_mid and kp == mid:
            knnz.append(0)
            imaps.append(np.empty(0, np.int32))
            omaps.append(np.empty(0, np.int32))
            continue
        # input coord = out * stride - padding + offset
        inc = out_coords[:, 1:4] * np.array(st) - np.array(pad) \
            + np.array(off)
        valid = (inc >= 0).all(1) & (inc < np.array(spatial_shape)).all(1)
        q = np.concatenate([out_coords[:, :1], inc], 1)[valid]
        out_ids = np.nonzero(valid)[0]
        in_ids = lookup(_encode(q, dims))
        hit = in_ids >= 0
        imaps.append(in_ids[hit].astype(np.int32))
        omaps.append(out_ids[hit].astype(np.int32))
        knnz.append(int(hit.sum()))
    return (_finalize_plan(imaps, omaps, knnz, k_vol, num_out, nnz,
                           separate_mid, quant, device),
            out_coords.astype(np.int32))


# the cloud size from which `build_rulebook` takes the native builder, as
# `dgsparse_tpu/ops/spconv.py:196, 249-250` does
NATIVE_MIN_VOXELS = 2048


def _native_rulebook(coords, ks, st, pad, spatial_shape, submanifold):
    """(out_coords, imaps, omaps, knnz) from the native builder under JAX's
    conditions, or None (a small cloud, a submanifold conv that is not
    centred, or no native library)."""
    from dgsparse_tpu_torch import native

    if len(coords) < NATIVE_MIN_VOXELS:
        return None
    c32 = coords.astype(np.int32)
    if not submanifold:
        return native.rulebook_strided(c32, ks, st, pad,
                                       tuple(spatial_shape))
    if all(k % 2 == 1 and p == k // 2 for k, p in zip(ks, pad)):
        nat = native.rulebook_subm(c32, ks, tuple(spatial_shape), True)
        return None if nat is None else (c32,) + nat
    return None


def plan_from_reference_rulebook(data: dict, quant: int = 128,
                                 device="cpu") -> SpConvPlan:
    """A SpConvPlan from a dgSPARSE sample-data rulebook dict (per-offset
    pair counts `knnz`, exclusive-scan `kpos`, the concatenated
    `imap`/`omap` streams, `k_vol`, `in_nnz`, `out_nnz`). A submanifold
    rulebook (in_nnz == out_nnz) with an identity center offset has that
    offset stripped and served by the dense center-tap product; any other
    center keeps its maps (`dgsparse_tpu/ops/spconv.py::
    plan_from_reference_rulebook`)."""
    knnz = np.asarray(data["knnz"], np.int64)
    kpos = np.asarray(data["kpos"], np.int64)
    imap = np.asarray(data["imap"], np.int64)
    omap = np.asarray(data["omap"], np.int64)
    k_vol = int(data["k_vol"])
    in_nnz = int(data["in_nnz"])
    out_nnz = int(data["out_nnz"])
    if len(kpos) != k_vol + 1 or int(kpos[-1]) != len(imap):
        raise ValueError("inconsistent rulebook: kpos does not index imap")
    separate_mid = in_nnz == out_nnz
    mid = (k_vol - 1) // 2
    imaps = [imap[kpos[k]:kpos[k] + knnz[k]].astype(np.int32)
             for k in range(k_vol)]
    omaps = [omap[kpos[k]:kpos[k] + knnz[k]].astype(np.int32)
             for k in range(k_vol)]
    knnz = [int(x) for x in knnz]
    if separate_mid and knnz[mid]:
        ident = np.arange(knnz[mid], dtype=np.int32)
        if knnz[mid] == in_nnz and np.array_equal(imaps[mid], ident) \
                and np.array_equal(omaps[mid], ident):
            imaps[mid] = np.empty(0, np.int32)
            omaps[mid] = np.empty(0, np.int32)
            knnz[mid] = 0
        else:
            separate_mid = False
    return _finalize_plan(imaps, omaps, knnz, k_vol, out_nnz, in_nnz,
                          separate_mid, quant, device)


def _finalize_plan(imaps, omaps, knnz, k_vol, num_out, nnz, separate_mid,
                   quant, device="cpu") -> SpConvPlan:
    # every (output, offset) has at most one input voxel, so the dense
    # per-offset maps hold the whole rulebook
    o2i = np.full((k_vol, max(num_out, 1)), -1, np.int32)
    i2o = np.full((k_vol, max(nnz, 1)), -1, np.int32)
    for kp in range(k_vol):
        o2i[kp, omaps[kp]] = imaps[kp]
        i2o[kp, imaps[kp]] = omaps[kp]

    # the quantized concatenation: every quant-aligned tile of the stream
    # belongs to one kernel offset
    imap_q, omap_q, widx_q = [], [], []
    kpos, qkpos = [0], [0]
    for kp in range(k_vol):
        n = knnz[kp]
        nq = -(-n // quant) * quant if n else 0
        im = np.full(nq, -1, np.int32)
        om = np.zeros(nq, np.int32)
        im[:n] = imaps[kp]
        om[:n] = omaps[kp]
        imap_q.append(im)
        omap_q.append(om)
        widx_q.append(np.full(nq, kp, np.int32))
        kpos.append(kpos[-1] + n)
        qkpos.append(qkpos[-1] + nq)

    # the kernels' layouts over the unpadded pairs
    pin = np.concatenate([np.asarray(m, np.int32) for m in imaps])
    pout = np.concatenate([np.asarray(m, np.int32) for m in omaps])
    pw = np.repeat(np.arange(k_vol, dtype=np.int32),
                   np.asarray(knnz, np.int64))
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return SpConvPlan(
        imap=as_t(np.concatenate(imap_q)),
        omap=as_t(np.concatenate(omap_q)),
        widx=as_t(np.concatenate(widx_q)),
        o2i=as_t(o2i),
        i2o=as_t(i2o),
        by_out=pair_csr(pout, pin, pw, num_out, device),
        by_in=pair_csr(pin, pout, pw, nnz, device),
        by_offset=offset_pairs(pin, pout, pw, k_vol, device),
        knnz=tuple(int(k) for k in knnz),
        kpos=tuple(kpos),
        qkpos=tuple(qkpos),
        num_out=num_out,
        num_in=nnz,
        k_vol=k_vol,
        separate_mid=separate_mid,
        quant=quant,
    )


def inverse_plan(plan: SpConvPlan) -> SpConvPlan:
    """Rulebook of the inverse (transposed) convolution, on the plan's
    device: in/out roles swap and kernel offsets mirror, so the inverse of
    a strided downsample scatters coarse features back to the exact fine
    sites the encoder saw."""
    k_vol = plan.k_vol
    i2o_np = plan.i2o.cpu().numpy()
    knnz, imaps, omaps = [], [], []
    mid = (k_vol - 1) // 2
    for kp in range(k_vol):
        mk = k_vol - 1 - kp
        if plan.separate_mid and kp == mid:
            knnz.append(0)
            imaps.append(np.empty(0, np.int32))
            omaps.append(np.empty(0, np.int32))
            continue
        outs = np.nonzero(i2o_np[mk] >= 0)[0].astype(np.int32)
        imaps.append(i2o_np[mk][outs])
        omaps.append(outs)
        knnz.append(len(outs))
    return _finalize_plan(imaps, omaps, knnz, k_vol, plan.num_in,
                          plan.num_out, plan.separate_mid, plan.quant,
                          plan.device)


def _dot(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b summed in float32, cast to `dtype` (JAX's jnp.dot with
    preferred_element_type=float32, then astype)."""
    return (a.float() @ b.float()).to(dtype)


class _SpConv(torch.autograd.Function):
    """The fused route: `spconv_pairs` forward and for dX, `spconv_dw` for
    dW, the center tap a dense product under `separate_mid`."""

    @staticmethod
    def forward(ctx, features, kernel, plan):
        ctx.plan = plan
        ctx.span = metrics.current()
        ctx.save_for_backward(features, kernel)
        dtype = features.dtype
        out = spconv_pairs(plan.by_out, features,
                           kernel.to(dtype)).to(dtype)
        if plan.separate_mid:
            out = out + _dot(features, kernel[(plan.k_vol - 1) // 2], dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        with metrics.backward_span(ctx.span,
                                   d_features=ctx.needs_input_grad[0],
                                   d_kernel=ctx.needs_input_grad[1]):
            return _SpConv._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        features, kernel = ctx.saved_tensors
        plan = ctx.plan
        mid = (plan.k_vol - 1) // 2
        dtype = features.dtype
        g = g.to(dtype).contiguous()
        d_features = d_kernel = None
        if ctx.needs_input_grad[0]:
            wt = kernel.to(dtype).transpose(1, 2).contiguous()
            d_features = spconv_pairs(plan.by_in, g, wt).to(dtype)
            if plan.separate_mid:
                d_features = d_features + _dot(g, kernel[mid].T, dtype)
        if ctx.needs_input_grad[1]:
            d_kernel = spconv_dw(plan.by_offset, features, g).to(kernel.dtype)
            if plan.separate_mid:
                d_kernel[mid] += _dot(features.T, g, kernel.dtype)
        return d_features, d_kernel, None


def spconv(features: torch.Tensor, kernel: torch.Tensor,
           plan: SpConvPlan) -> torch.Tensor:
    """Sparse conv: features [num_in, c_in], kernel [k_vol, c_in, c_out]
    -> [num_out, c_out] in the features' type (`dgsparse_tpu/ops/
    spconv.py::spconv`). Differentiable in features and kernel; dX runs only
    when the features need a gradient."""
    metrics.record("spconv", path="fused", pairs=plan.total_pairs,
                   c_in=kernel.shape[1], c_out=kernel.shape[2])
    if not metrics.enabled():
        return _SpConv.apply(features.contiguous(), kernel, plan)
    with metrics.span("dgsparse.op.spconv.fused.fwd",
                      pairs=plan.total_pairs, k_vol=plan.k_vol,
                      num_in=features.shape[0], c_in=kernel.shape[1],
                      c_out=kernel.shape[2], dtype=str(features.dtype)[6:]):
        return _SpConv.apply(features.contiguous(), kernel, plan)


class SparseConvTensor:
    """Features + voxel coords + cached rulebooks, carried through a network
    so that each rulebook is built once (`dgsparse_tpu/ops/spconv.py::
    SparseConvTensor`). Plans are built on the features' device."""

    def __init__(self, features: Optional[torch.Tensor], coords: np.ndarray,
                 spatial_shape: Sequence[int], device=None):
        self.features = features
        self.coords = np.asarray(coords, np.int32)
        self.spatial_shape = tuple(int(s) for s in spatial_shape)
        self._device = None if device is None else torch.device(device)
        self._plans = {}

    @property
    def device(self) -> torch.device:
        """The features' device, or for sites without features the one
        given at construction: where its plans are built."""
        return self._device if self.features is None else self.features.device

    def plan_for(self, kernel_size, stride, padding
                 ) -> Tuple[SpConvPlan, np.ndarray]:
        key = (_triple(kernel_size), _triple(stride), _triple(padding),
               str(self.device))
        if key not in self._plans:
            self._plans[key] = build_rulebook(
                self.coords, kernel_size, stride, padding,
                spatial_shape=self.spatial_shape, device=self.device)
        return self._plans[key]

    def replace(self, features: torch.Tensor, coords=None,
                spatial_shape=None) -> "SparseConvTensor":
        new = SparseConvTensor(
            features,
            self.coords if coords is None else coords,
            self.spatial_shape if spatial_shape is None else spatial_shape,
        )
        if coords is None and spatial_shape is None:
            new._plans = self._plans
        return new
