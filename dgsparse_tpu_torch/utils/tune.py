"""Empirical route selection for SUM/MEAN `spmm`: time the port's routes on
the device, keep the fastest, and persist the choice.

Counterpart of `dgsparse_tpu/utils/tune.py`, with its names. The
candidates are the routes the port really has, named by the `Algorithm`
that selects them:
- `XLA_SEGMENT`, the CSR kernel (`kernels/spmm_csr.py`), always;
- `PALLAS_ROW_TILE`, the hybrid tiers (`ops/hybrid.py`), when the storage
  has a hybrid plan and the reduction is SUM or MEAN.
PALLAS_EDGE_TILE and PALLAS_BELL run the same CSR kernel as XLA_SEGMENT in
the port, and MAX/MIN have one route, so none of them is timed twice.

On the card a candidate is timed with CUDA events (`utils/bench.py::
cuda_time`), on the CPU with the host clock; a candidate that fails
raises. The winner is kept in a JSON file, by default
`~/.cache/dgsparse_tpu_torch/tune.json`, or the path in
`DGSPARSE_TUNE_CACHE` (read at each use), written atomically through a
temporary file. An entry is keyed by (structure hash, width, reduction,
backend, forward or trained), the backend being "cpu" or the card's name,
so entries never cross packages or cards. `spmm` under AUTO consults the
forward entry (`lookup_key`) before the hybrid gate, so a tuned choice
holds in every later process.
"""

import functools
import json
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from dgsparse_tpu_torch.core.formats import SparseTensor, structure_hash
from dgsparse_tpu_torch.ops.types import Algorithm, ReduceOp, as_reduce
from dgsparse_tpu_torch.utils import metrics

_LOCK = threading.Lock()
_CACHE: Optional[dict] = None
_CACHE_FROM: Optional[str] = None


def cache_path() -> str:
    path = os.environ.get("DGSPARSE_TUNE_CACHE")
    if path is None:
        path = os.path.expanduser("~/.cache/dgsparse_tpu_torch/tune.json")
    return path


def structure_key(sparse: SparseTensor) -> str:
    """The sampled structure hash of `sparse`: the one its storage computed
    at construction, or (a transpose, which has none) computed now from a
    device-side sample of rowptr and col."""
    st = sparse.storage
    if st._tune_key is not None:
        return st._tune_key
    m, n = sparse.sparse_sizes()
    return structure_hash(m, n, sparse.nnz, st.rowptr(), st.col())


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def backend(device) -> str:
    """The entry key's backend: "cpu" or the card's name."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    return _card_name(device.index if device.index is not None
                      else torch.cuda.current_device())


def _entry_key(skey: str, feat: int, reduce: ReduceOp, with_grad: bool,
               device) -> str:
    return (f"{skey}|f{feat}|{reduce.value}|{backend(device)}|"
            f"{'trained' if with_grad else 'fwd'}")


def _load() -> dict:
    global _CACHE, _CACHE_FROM
    path = cache_path()
    cache = _CACHE
    if cache is not None and _CACHE_FROM == path:   # loaded: no lock
        return cache
    with _LOCK:
        if _CACHE is None or _CACHE_FROM != path:
            _CACHE_FROM = None
            try:
                with open(path) as f:
                    _CACHE = json.load(f)
            except (OSError, ValueError):
                _CACHE = {}
            _CACHE_FROM = path
        return _CACHE


def _store(key: str, alg: Algorithm, times: dict) -> None:
    cache = _load()
    path = cache_path()
    with _LOCK:
        cache[key] = {"alg": alg.name,
                      "times_us": {a.name: round(t * 1e6, 1)
                                   for a, t in times.items()}}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1)
        os.replace(tmp, path)


def _algorithm(hit: Optional[dict]) -> Optional[Algorithm]:
    if hit is None:
        return None
    try:
        return Algorithm[hit["alg"]]
    except KeyError:
        return None


def lookup_key(skey: Optional[str], feat: int, reduce, with_grad=False,
               device="cpu") -> Optional[Algorithm]:
    """The tuned route for (structure hash, width, reduction) on `device`'s
    backend, or None: a dict lookup, no device work (`spmm`'s AUTO, on
    every eager call; with nothing tuned it ends at the empty cache)."""
    if skey is None:
        return None
    cache = _load()
    alg = None if not cache else _algorithm(cache.get(
        _entry_key(skey, feat, as_reduce(reduce), with_grad, device)))
    metrics.count("tune.miss" if alg is None else "tune.hit")
    return alg


def cached_algorithm(sparse: SparseTensor, feat: int, reduce="sum",
                     with_grad: bool = False) -> Optional[Algorithm]:
    """The route tuned earlier for this structure, width and reduction on
    the storage's device, or None."""
    return lookup_key(structure_key(sparse), feat, reduce, with_grad,
                      sparse.device)


def _candidates(sparse: SparseTensor, reduce) -> list:
    """The routes `tune_spmm` times (see the module docstring)."""
    cands = [Algorithm.XLA_SEGMENT]
    if sparse.storage.ell_plan() is not None \
            and as_reduce(reduce) in (ReduceOp.SUM, ReduceOp.MEAN):
        cands.append(Algorithm.PALLAS_ROW_TILE)
    return cands


def _host_time(fn, *args, warmup: int, iters: int) -> float:
    """Seconds per call of fn(*args) on the host clock (`cuda_time`'s
    counterpart for tensors on the CPU)."""
    for _ in range(warmup):
        fn(*args)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def tune_spmm(sparse: SparseTensor, feat: int, reduce="sum",
              dtype=torch.float32, iters=(20, 60), with_grad: bool = False,
              seed: int = 0, use_cache: bool = True
              ) -> Tuple[Algorithm, dict]:
    """Time every candidate route of `spmm(sparse, [N, feat], reduce)` on
    the storage's device and return (best, {algorithm: seconds}); `iters`
    is (warm-up calls, timed calls). With `with_grad`, a call is forward
    and backward of JAX's loss vdot(out * out, ct), with the values and
    the dense input both requiring a gradient (so d_values runs too). The
    winner is persisted; with `use_cache`, an earlier entry is returned
    without timing."""
    from dgsparse_tpu_torch.ops.spmm import spmm
    from dgsparse_tpu_torch.utils.bench import cuda_time

    reduce = as_reduce(reduce)
    device = sparse.device
    key = _entry_key(structure_key(sparse), feat, reduce, with_grad, device)
    if use_cache:
        hit = _load().get(key)
        best = _algorithm(hit)
        if best is not None:
            return best, {Algorithm[a]: t / 1e6
                          for a, t in hit.get("times_us", {}).items()}

    m, n = sparse.sparse_sizes()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, feat)).astype(np.float32)
                         ).to(device, dtype)
    ct = torch.from_numpy(rng.standard_normal((m, feat)).astype(np.float32)
                          ).to(device, dtype)
    if with_grad:
        # one values leaf for every call: the hybrid tier values built for
        # it at the first (warm-up) call are kept
        v = sparse.values_or_ones().detach().clone().requires_grad_()
        sp = sparse.set_values(v)
        x.requires_grad_()

        def call(dense, alg):
            out = spmm(sp, dense, reduce, alg)
            torch.autograd.grad((out * out * ct).sum(), (v, dense))
    else:
        def call(dense, alg):
            with torch.no_grad():
                spmm(sparse, dense, reduce, alg)

    timer = cuda_time if device.type == "cuda" else _host_time
    times = {alg: timer(functools.partial(call, alg=alg), x,
                        warmup=iters[0], iters=iters[1])
             for alg in _candidates(sparse, reduce)}
    best = min(times, key=times.get)
    _store(key, best, times)
    return best, times


def tune_report(sparse: SparseTensor, feats=(32, 128), reduce="sum",
                with_grad: bool = False) -> str:
    """A table of the tuned routes' times across feature widths."""
    lines = []
    for f in feats:
        best, times = tune_spmm(sparse, f, reduce, with_grad=with_grad)
        row = ", ".join(f"{a.name}={t * 1e6:.0f}us"
                        for a, t in sorted(times.items(),
                                           key=lambda kv: kv[1]))
        lines.append(f"F={f} reduce={reduce} best={best.name}: {row}")
    return "\n".join(lines)
