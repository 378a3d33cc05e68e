"""Hand-written CUDA kernels, their wrappers and plain PyTorch versions
(counterpart of dgsparse_tpu/kernels).

Each kernel module keeps a `LAUNCHES` dict; these two helpers read and
reset all of them at once.
"""


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset, all modules."""
    from dgsparse_tpu_torch.kernels import sddmm_csr, spmm_csr

    return {**spmm_csr.LAUNCHES, **sddmm_csr.LAUNCHES}


def reset_launch_counts() -> None:
    from dgsparse_tpu_torch.kernels import sddmm_csr, spmm_csr

    spmm_csr.reset_launch_counts()
    sddmm_csr.reset_launch_counts()
