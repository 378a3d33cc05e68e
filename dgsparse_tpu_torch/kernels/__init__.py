"""Hand-written CUDA kernels, their wrappers and plain PyTorch versions
(counterpart of dgsparse_tpu/kernels)."""
