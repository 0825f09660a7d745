"""Carry the JAX package's weights and occupancy state across, as numpy.

Parameter names and the [in, out] weight layout are the same in both
packages, so the conversion is 1:1.  Inputs are numpy arrays (e.g.
`{k: np.asarray(v) for k, v in jax_params.items()}`), so this module
needs nothing of JAX.
"""

import numpy as np
import torch

from enerf_torch.render.occupancy import OccupancyState


def params_from_jax(params_np, device="cpu"):
    """dict[str, np.ndarray] -> dict[str, torch.Tensor] (copies)."""
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in params_np.items()}


def occupancy_from_jax(density_grid, occ_bitfield, mean_density, iter_density,
                       device="cpu"):
    """The four OccupancyState fields (numpy) -> the port's OccupancyState."""
    return OccupancyState(
        density_grid=torch.tensor(np.asarray(density_grid, np.float32), device=device),
        occ_bitfield=torch.tensor(np.asarray(occ_bitfield, bool), device=device),
        mean_density=torch.tensor(np.asarray(mean_density, np.float32), device=device),
        iter_density=int(iter_density),
    )
