"""CUDA-event timing for kernels on the card.

Counterpart of the timers in `dgsparse_tpu/utils/bench.py`. A time comes
only from the card: `cuda_time` raises when its tensors are not on CUDA.
"""

import torch


def cuda_time(fn, *args, warmup: int = 10, iters: int = 100) -> float:
    """Seconds per call of fn(*args): `warmup` calls, then `iters` calls
    between two CUDA events on the current stream, `synchronize`,
    elapsed time / iters."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or any(t.device.type != "cuda" for t in tensors):
        raise ValueError("cuda_time needs its tensor arguments on CUDA")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


def spmm_gflops(nnz: int, feat: int, seconds: float) -> float:
    """2*nnz*F/t (example/ge-spmm/spmm.cu:162-164)."""
    return 2.0 * nnz * feat / seconds / 1e9
