"""Occupancy grid and march renderers (counterpart of enerf_tpu.render)."""
