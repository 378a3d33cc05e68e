"""Checks and launch plumbing shared by the kernels' ctypes wrappers.

A wrapper checks device, type, shape and contiguity before it hands raw
pointers to a kernel, and raises when the C function returns a non-zero
`cudaError_t`: a refused launch never runs, and nothing falls back.
"""

import torch

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_device(device: torch.device, **tensors) -> None:
    """Every tensor given (None skipped) contiguous on one CUDA device."""
    if device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs tensors on a CUDA device, got {device}")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_dense(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def check_index(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 1:
        raise TypeError(f"{name} must be a 1-D int32 tensor")


def heads_of(values, feat: int) -> int:
    """Heads of per-edge values: None or [nnz] is one, [nnz, H] is H, and
    then H must divide the feature width."""
    if values is None or values.dim() == 1:
        return 1
    heads = values.shape[1]
    if values.dim() != 2 or heads == 0 or feat % heads:
        raise ValueError(
            f"values {tuple(values.shape)} must be [nnz] or [nnz, H] with H "
            f"dividing the feature width {feat}")
    return heads


def check_values(name: str, values, nnz: int) -> None:
    """Per-edge values (None skipped) in float32, one row per edge."""
    if values is not None and (values.dtype != torch.float32
                               or values.shape[0] != nnz):
        raise TypeError(f"{name} must be float32 with one row per edge")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")
