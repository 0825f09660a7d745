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


def carry_lpips_from_jax(monkeypatch):
    """Make the port's LPIPS use the JAX package's current weights (and lin
    heads, when calibrated), converted: the two packages then compute the
    same metric, and the port's label follows JAX's."""
    import enerf_tpu.train.lpips_jax as LJ
    from enerf_torch.train import lpips as TL

    nets = {}
    for net in ("alex", "vgg"):
        params, lins, calibrated = LJ._get_net(net)
        convs = TL.lpips_params_from_jax([(np.asarray(w), np.asarray(b)) for w, b in params])
        lins = None if lins is None else [torch.from_numpy(np.array(w)) for w in lins]
        nets[net] = (convs, lins, calibrated)
    monkeypatch.setattr(TL, "get_net", lambda net, device="cpu": nets[net])
