"""Sparse formats and transforms (counterpart of dgsparse_tpu/core)."""
