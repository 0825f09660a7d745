"""Carry the JAX package's weights, occupancy state and stub CLIP embedder
across, as numpy.

Parameter names and the [in, out] weight layout are the same in both
packages (the background net's bg_table and bg_w* too), so the conversion
is 1:1.  Inputs are numpy arrays (e.g.
`{k: np.asarray(v) for k, v in jax_params.items()}`), so this module
needs nothing of JAX.
"""

import numpy as np
import torch

from enerf_torch.render.occupancy import occupancy_state
from enerf_torch.train.clip_guidance import StubEmbedder


def params_from_jax(params_np, device="cpu"):
    """dict[str, np.ndarray] -> dict[str, torch.Tensor] (copies)."""
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in params_np.items()}


def occupancy_from_jax(density_grid, occ_bitfield, mean_density, iter_density,
                       device="cpu"):
    """The four OccupancyState fields (numpy) -> the port's OccupancyState
    (its packed bitfield made from them)."""
    return occupancy_state(
        density_grid=torch.tensor(np.asarray(density_grid, np.float32), device=device),
        occ_bitfield=torch.tensor(np.asarray(occ_bitfield, bool), device=device),
        mean_density=torch.tensor(np.asarray(mean_density, np.float32), device=device),
        iter_density=int(iter_density),
    )


def embedder_from_jax(proj, text_feat, device="cpu"):
    """The JAX StubEmbedder's projection [16 * 16 * channels, dim] and a text
    feature [dim] (numpy) -> (the port's StubEmbedder with that projection,
    the text feature as a tensor): both packages then compute the same
    loss_clip (their own draws come from different generators)."""
    proj = np.array(proj, np.float32)  # a writable copy
    emb = StubEmbedder(dim=proj.shape[1], channels=proj.shape[0] // 256, device=device,
                       proj=proj)
    return emb, torch.tensor(np.asarray(text_feat, np.float32), device=device)
