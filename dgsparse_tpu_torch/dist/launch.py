"""Run a function on the ranks of a fresh process group, one process each.

`run_ranks(fn, world_size, backend, device, timeout_s, args)` spawns
`world_size` processes with the `spawn` start method (forking a process
whose JAX or CUDA has started threads can deadlock), joins them in one
process group through a `FileStore` in a temporary directory (no TCP port
to collide with another run) and calls fn(rank, world_size, device,
*args) in each. A rank's process starts from a fresh import: it loads
`fn` by its module path, so rank bodies live in modules that import no
JAX (`dist/cases.py`), and it inherits the environment (a
`DGSPARSE_TUNE_CACHE` set by the caller included). It loads the kernels
the caller built (`kernels/_build.py` writes each library atomically).

Each rank's result comes back as numpy (tensors converted, in dicts,
lists and tuples), with that rank's kernel launch counts of the whole
call (`kernels.launch_counts`) and whether JAX got imported there. A rank
that raises, dies or outlasts `timeout_s` makes `run_ranks` raise after
it stops every rank: it never returns part of the results. Several cards
take backend "nccl" and a device per rank; ranks that share one card take
"gloo" (NCCL refuses two ranks on one device), whose collectives stage
CUDA tensors through host memory (`dist/comm.py`). The ranks run on the
card unless the caller passes device="cpu", as the CPU tests do.
"""

import collections
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback

RankResult = collections.namedtuple("RankResult",
                                    "result launches jax_loaded")


def _to_numpy(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _rank_main(rank, world_size, backend, device, tmp, timeout_s, fn,
               results):
    try:
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        import torch
        import torch.distributed as dist

        from dgsparse_tpu_torch import kernels

        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            # ranks share the host's cores: PyTorch's own thread pools
            # oversubscribe them (a 50-row SpMM and its backward took 1.6 s
            # a rank on 8 threads, 3 ms on one, 4 ranks on 8 cores)
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"),
                                          world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            kernels.reset_launch_counts()
            out = fn(rank, world_size, device, *args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            payload = RankResult(_to_numpy(out), kernels.launch_counts(),
                                 "jax" in sys.modules)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, payload))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size: int, backend: str = "gloo", device="cuda",
              timeout_s: float = 120.0, args=()):
    """[RankResult] of fn(rank, world_size, device, *args) on each rank, in
    rank order; raises if any rank fails or the ranks do not all finish
    within `timeout_s` (which also bounds the process group's own waits).
    `device` is where every rank runs: the card ("cuda" is the current
    one, which ranks sharing a card all take) unless the caller passes
    "cpu"; raises on a host without a card (`entry.resolve_device`).
    """
    import multiprocessing

    import torch

    from dgsparse_tpu_torch.entry import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dgsparse_ranks_")
    # the arguments go through a file: a process's start blocks while its
    # pickle fills the pipe to a child still importing, one rank at a time
    with open(os.path.join(tmp, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(rank, world_size, backend, str(device), tmp, timeout_s, fn,
              results))
        for rank in range(world_size)]
    deadline = time.monotonic() + timeout_s
    done = {}
    try:
        for p in procs:
            p.start()
        while len(done) < world_size:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(done))} "
                    f"did not finish within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} died with exit code "
                        f"{procs[dead[0]].exitcode}") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            done[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [done[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.pid is None:
                continue       # never started: a start before it raised
            if p.is_alive():
                p.kill()
            p.join(5)
        results.close()
        results.cancel_join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
