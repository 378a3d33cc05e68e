"""Hand-written CUDA kernels, their wrappers and plain PyTorch versions
(counterpart of dgsparse_tpu/kernels).

Each kernel module keeps a `LAUNCHES` dict; these two helpers read and
reset all of them at once.
"""


def _modules():
    from dgsparse_tpu_torch.kernels import sddmm_csr, spmm_csr, spmm_maxmin

    return spmm_csr, sddmm_csr, spmm_maxmin


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset, all modules."""
    return {k: v for m in _modules() for k, v in m.LAUNCHES.items()}


def reset_launch_counts() -> None:
    for m in _modules():
        m.reset_launch_counts()
