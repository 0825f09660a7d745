"""Shared helpers of the enerf_torch parity tests (JAX package vs port).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU (Pallas kernels in interpret mode, tests/conftest.py) and
the port runs its plain PyTorch path on CPU tensors.
"""

import numpy as np
import torch

# xdist runs several workers on one machine: one intra-op thread each
torch.set_num_threads(1)


def t(x, dtype=None):
    """numpy / JAX array -> CPU torch tensor (copy)."""
    a = np.array(x)
    out = torch.from_numpy(a)
    return out.to(dtype) if dtype is not None else out


def n(x):
    """torch tensor or JAX array -> numpy (float32 for bf16 tensors)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def params_np(params):
    """JAX param dict -> dict of numpy arrays (the convert.py input)."""
    return {k: np.asarray(v) for k, v in params.items()}


def unit_dirs(rng, count):
    d = rng.normal(size=(count, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)
