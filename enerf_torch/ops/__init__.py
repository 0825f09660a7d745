"""Kernels and tensor ops of the port (counterparts of enerf_tpu.ops)."""
