"""Field models (counterpart of enerf_tpu.models)."""
