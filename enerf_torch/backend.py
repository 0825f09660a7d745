"""Device resolution for the port's entry points.

`None` means the card: the port exists to run on an H100, so an entry
point that finds no CUDA device raises instead of carrying on silently on
the CPU.  Tests and CPU runs pass `device="cpu"` explicitly.  A rank of a
data-parallel job on one host passes its `local_rank` and gets a card of
its own.
"""

import torch


def resolve_device(device=None, local_rank=None):
    """None -> cuda (raises without CUDA); anything else -> torch.device.
    With `local_rank`, a CUDA device without an index becomes
    cuda:{local_rank} (raises if the host has no such card), made current."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "enerf_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if device.type == "cuda" and local_rank is not None:
        if device.index is None:
            device = torch.device("cuda", local_rank)
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {local_rank} wants {device}, but this host has "
                               f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(device)
    return device
