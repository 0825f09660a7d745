"""Data parallelism over torch.distributed (counterpart of enerf_tpu.parallel)."""
