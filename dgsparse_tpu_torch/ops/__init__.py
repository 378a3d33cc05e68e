"""Public sparse ops (counterpart of dgsparse_tpu/ops)."""
