"""Device resolution for the port's entry points.

`None` means the card: the port exists to run on an H100, so an entry
point that finds no CUDA device raises instead of carrying on silently on
the CPU.  Tests and CPU runs pass `device="cpu"` explicitly.
"""

import torch


def resolve_device(device=None):
    """None -> cuda (raises without CUDA); anything else -> torch.device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "enerf_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
