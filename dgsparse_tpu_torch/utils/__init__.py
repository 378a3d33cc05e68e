"""Test generators and card timers (counterpart of dgsparse_tpu/utils)."""
