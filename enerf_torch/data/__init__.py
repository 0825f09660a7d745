"""Synthetic data, poses, rays, event chains and providers (counterpart of enerf_tpu.data)."""
