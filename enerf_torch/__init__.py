"""enerf-torch: the PyTorch + CUDA port of enerf-tpu for NVIDIA Hopper.

The package mirrors `enerf_tpu`'s module layout (config, ops, models,
render, train, data) so each function has a counterpart of the same name.
Plain tensor code is PyTorch; each Pallas kernel of the JAX package becomes
a hand-written Hopper kernel under `csrc/`, bound with ctypes and built at
first use (ops/cuda_build.py).

Device policy: entry points run on the card unless the caller asks for the
CPU (`device="cpu"`).  A kernel wrapper picks its implementation from the
device of the tensor it is given: the plain PyTorch version on a CPU
tensor, the kernel on a CUDA tensor, never a fallback.
"""

__version__ = "0.1.0"

