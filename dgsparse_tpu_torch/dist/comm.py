"""The collectives of the sharded ops, on `torch.distributed`: the port's
counterpart of what `shard_map` and the `lax` collectives give
`dgsparse_tpu/dist/`.

- `all_gather(x, group)`: the ranks' x concatenated on dim 0 in rank order
  (`lax.all_gather(..., tiled=True)`), differentiable; its backward is
  `reduce_scatter` of the gradient (sum), the `psum_scatter` JAX's
  autodiff derives.
- `all_reduce(tensors, group)`: each tensor summed over the ranks (`psum`),
  all of them in one collective; not differentiable (it sums parameter
  gradients and losses).
- `replicated(x, group)`: x itself, a value every rank holds alike (a
  parameter); its backward sums the gradient over the ranks, as JAX's
  autodiff sums the cotangent of a replicated `shard_map` input (`psum`).
- `neighbour_exchange(to_right, to_left, group)`: the two `ppermute`s of
  `dgsparse_tpu/dist/spconv.py:223-224`, differentiable; its backward is
  the reversed exchange. A rank with no neighbour on a side receives
  zeros there, as `ppermute` delivers.

`group` is a process group (None: the default one), for example one
dimension of a `DeviceMesh` (`mesh.get_group("graph")`).

Staging: gloo takes no CUDA tensor for these collectives, so where the
group's backend is gloo and a tensor lies on CUDA, the call waits for the
current stream, copies the tensor into pinned host memory, runs the
collective there and copies the result back. That depends on the backend
alone, is logged once per process and counted in `STAGED`, and the compute
stays on the card. NCCL takes CUDA tensors as they are.

Every call adds the elements of the operands this rank passes to
`VOLUMES`, under JAX's primitive names (`all_gather`, `psum`,
`psum_scatter`, `ppermute`), as `dgsparse_tpu/utils/testing.py::
collective_volumes` counts a traced jaxpr: per rank, both halo buffers of
an exchange included where a side has no neighbour.
`utils/testing.py::collective_volumes` reads it.
"""

import logging
import time
import warnings

import torch
import torch.distributed as dist

VOLUMES = {"all_gather": 0, "psum": 0, "psum_scatter": 0, "ppermute": 0}
# staged collectives: calls, and host seconds from the stream's end to the
# result back on the card (copies included)
STAGED = {"calls": 0, "seconds": 0.0}
_LOG = logging.getLogger(__name__)
_LOGGED = [False]


def reset_counters() -> None:
    for k in VOLUMES:
        VOLUMES[k] = 0
    STAGED.update(calls=0, seconds=0.0)


def _group(group):
    return dist.group.WORLD if group is None else group


def _count(name: str, *tensors) -> None:
    VOLUMES[name] += sum(t.numel() for t in tensors)


def _call(group, fn, *tensors):
    """fn(*tensors) -> tuple of tensors, run on host copies when the group
    is gloo and the tensors lie on CUDA (see the module docstring)."""
    device = tensors[0].device
    if device.type != "cuda" or dist.get_backend(group) != "gloo":
        return fn(*tensors)
    if not _LOGGED[0]:
        _LOGGED[0] = True
        _LOG.warning("gloo process group: CUDA tensors of collectives are "
                     "staged through pinned host memory")
    torch.cuda.current_stream(device).synchronize()
    t0 = time.perf_counter()
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            for t in tensors]
    out = tuple(t.to(device) for t in fn(*host))
    STAGED["calls"] += 1
    STAGED["seconds"] += time.perf_counter() - t0
    return out


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    def run(xs):
        out = xs.new_empty((dist.get_world_size(group) * xs.shape[0],)
                           + tuple(xs.shape[1:]))
        with warnings.catch_warnings():   # renamed *_single in torch 2.13
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, xs, group=group)
        return (out,)

    return _call(group, run, x.contiguous())[0]


def _reduce_scatter(g: torch.Tensor, group) -> torch.Tensor:
    def run(gs):
        out = gs.new_empty((gs.shape[0] // dist.get_world_size(group),)
                           + tuple(gs.shape[1:]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, gs, group=group)
        return (out,)

    _count("psum_scatter", g)
    return _call(group, run, g.contiguous())[0]


def _exchange(to_right: torch.Tensor, to_left: torch.Tensor, group):
    """(from_left, from_right): the left neighbour's to_right and the right
    neighbour's to_left, zeros where there is none."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)

    def run(right, left):
        from_left, from_right = torch.zeros_like(right), torch.zeros_like(left)
        ops = []
        for peer, send, recv in ((rank + 1, right, from_right),
                                 (rank - 1, left, from_left)):
            if 0 <= peer < world:
                peer = dist.get_global_rank(group, peer)
                ops += [dist.P2POp(dist.isend, send, peer, group),
                        dist.P2POp(dist.irecv, recv, peer, group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_left, from_right

    return _call(group, run, to_right.contiguous(), to_left.contiguous())


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count("all_gather", x)
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce([g], ctx.group)[0], None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, to_right, to_left, group):
        ctx.group = group
        _count("ppermute", to_right, to_left)
        return _exchange(to_right, to_left, group)

    @staticmethod
    def backward(ctx, g_from_left, g_from_right):
        # my to_right arrived as the right neighbour's from_left: its
        # gradient comes back leftwards, and the other side mirrors it
        _count("ppermute", g_from_right, g_from_left)
        g_to_left, g_to_right = _exchange(g_from_right, g_from_left,
                                          ctx.group)
        return g_to_right, g_to_left, None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """[world * n, ...]: every rank's x [n, ...] in rank order."""
    return _AllGather.apply(x, _group(group))


def all_reduce(tensors, group=None):
    """Each tensor of the list summed over the ranks (new tensors, no
    gradient), all of them through one flat collective."""
    group = _group(group)
    tensors = [t.detach() for t in tensors]
    _count("psum", *tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])

    def run(f):
        dist.all_reduce(f, group=group)
        return (f,)

    flat = _call(group, run, flat)[0]
    return [part.view_as(t) for part, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """x, with its gradient summed over the ranks in the backward."""
    return _Replicated.apply(x, _group(group))


def neighbour_exchange(to_right: torch.Tensor, to_left: torch.Tensor,
                       group=None):
    """(from_left, from_right): what the rank before this one sent right
    and what the rank after it sent left, zeros at the ends; the buffers
    have one shape on every rank."""
    return _Exchange.apply(to_right, to_left, _group(group))
