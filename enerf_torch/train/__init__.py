"""Losses, optimizer state, train step and trainer (counterpart of enerf_tpu.train)."""
