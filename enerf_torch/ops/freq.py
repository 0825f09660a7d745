"""NeRF sinusoidal frequency encoding.

Counterpart of enerf_tpu/ops/freq.py (reference encoding.py:5-43,
FreqEncoder): [x, sin(f_i x), cos(f_i x)] with the frequencies
2^0 .. 2^(MULTIRES-1), the input included.
"""

import numpy as np
import torch

MULTIRES = 6  # the field's only setting (3 -> 39 wide)


def freq_encode(x):
    """[..., D] -> [..., D * (2 * MULTIRES + 1)]."""
    out = [x]
    for f in 2.0 ** np.linspace(0.0, MULTIRES - 1, MULTIRES):
        out.append(torch.sin(x * float(f)))
        out.append(torch.cos(x * float(f)))
    return torch.cat(out, dim=-1)


def freq_output_dim(input_dim):
    return input_dim * (2 * MULTIRES + 1)
