"""Multi-cascade occupancy grid: state and maintenance.

Counterpart of enerf_tpu/render/occupancy.py (reference renderer.py:86-126,
473-563): a 128^3 x cascade density grid with its bitfield; the update
queries the field at jittered cell centres, decays the grid as
max(0.95 * grid, new) and thresholds at min(mean density, density_thresh).
The first 16 updates query every cell, later ones half random cells and
half occupied cells.

`mark_untrained_grid` sets the cells no training camera sees to -1
(untrained), which the updates then leave alone.

The full update queries 2M cells per cascade; like the JAX package it runs
in 64 chunks (16 for the partial update) under no_grad, which bounds the
gathered block-grid rows to ~0.5 GB per chunk at 16 levels.
`iter_density` is a Python int, so choosing the branch costs no device sync.
Random draws come from a torch.Generator; tests inject the cell jitter
(`noise`).
"""

from typing import NamedTuple

import numpy as np
import torch

from enerf_torch.models.field import field_density

GRID_SIZE = 128
DENSITY_SCALE_STEP = 0.003383  # 2*sqrt(3)/1024, renderer.py:513


class OccupancyState(NamedTuple):
    density_grid: torch.Tensor  # [CAS, H^3] f32; -1 marks untrained cells
    occ_bitfield: torch.Tensor  # [CAS, H^3] bool
    mean_density: torch.Tensor  # scalar f32
    iter_density: int           # updates done so far


def num_cascades(bound):
    return 1 + int(np.ceil(np.log2(max(bound, 1.0))))


def ball_bitfield(radius=0.48, cascades=1, device="cpu"):
    """A centred ball occupying ~6% of cascade 0 (the trained-scene-like
    bitfield enerf_tpu's benchmarks and tests share)."""
    g = np.arange(GRID_SIZE)
    xs, ys, zs = np.meshgrid(g, g, g, indexing="ij")
    centers = 2.0 * np.stack([xs, ys, zs], -1) / (GRID_SIZE - 1) - 1.0
    bf = np.zeros((cascades, GRID_SIZE ** 3), bool)
    bf[0] = (np.linalg.norm(centers, axis=-1) < radius).reshape(-1)
    return torch.as_tensor(bf, device=device)


def init_occupancy(bound, device="cpu"):
    cas = num_cascades(bound)
    return OccupancyState(
        density_grid=torch.zeros(cas, GRID_SIZE ** 3, device=device),
        occ_bitfield=torch.zeros(cas, GRID_SIZE ** 3, dtype=torch.bool, device=device),
        mean_density=torch.zeros((), device=device),
        iter_density=0,
    )


def _cell_centers(coords, cas, bound):
    """coords: [N, 3] int cell coords -> world positions in the cascade."""
    H = GRID_SIZE
    xyz = 2.0 * coords.float() / (H - 1) - 1.0  # [-1, 1]
    cas_bound = min(2.0 ** cas, bound)
    half = cas_bound / H
    return xyz * (cas_bound - half), half


def _linear_coords(idx):
    """[N] linear cell index -> [N, 3] (x, y, z) coords."""
    H = GRID_SIZE
    return torch.stack([idx // (H * H), (idx // H) % H, idx % H], dim=-1)


@torch.no_grad()
def update_occupancy(params, static, occ, generator=None, *, density_scale=1.0,
                     density_thresh=0.01, decay=0.95, noise=None):
    """One occupancy maintenance step (reference update_extra_state).

    noise: optional [CAS, Q, 3] U[0, 1) draws for the cell jitter (Q = H^3
    for the full update, H^3/2 for the partial one); drawn from
    `generator` when not given, like the partial update's cell choice.
    """
    H = GRID_SIZE
    dev = occ.density_grid.device
    cas = occ.density_grid.shape[0]
    full = occ.iter_density < 16
    tmp = torch.full_like(occ.density_grid, -1.0)
    n_chunks = 64 if full else 16
    for c in range(cas):
        if full:
            cells = torch.arange(H ** 3, device=dev)
        else:
            N = H ** 3 // 4
            rand_idx = torch.randint(0, H ** 3, (N,), device=dev, generator=generator)
            # uniform-with-replacement over occupied cells by inverse CDF
            # (reference renderer.py:524-526)
            cdf = torch.cumsum((occ.density_grid[c] > 0.0).float(), 0)
            u = torch.rand(N, device=dev, generator=generator) * cdf[-1].clamp(min=1.0)
            occ_idx = torch.searchsorted(cdf, u, right=True).clamp(0, H ** 3 - 1)
            cells = torch.cat([rand_idx, occ_idx])
        u3 = (noise[c].to(dev) if noise is not None else
              torch.rand(cells.shape[0], 3, device=dev, generator=generator))
        xyz, half = _cell_centers(_linear_coords(cells), c, static.bound)
        xyz = xyz + (u3 * 2.0 - 1.0) * half
        sig = torch.cat([
            field_density(params, static, part)[0]
            for part in xyz.chunk(n_chunks)
        ]) * (density_scale * DENSITY_SCALE_STEP)
        tmp[c, cells] = sig
    return _finish_update(occ, tmp, density_thresh, decay)


def _finish_update(occ, tmp, density_thresh, decay):
    """EMA decay + threshold + bitfield from the fresh queries `tmp`
    (reference renderer.py:528-563); cells with tmp < 0 are untouched."""
    valid = (occ.density_grid >= 0.0) & (tmp >= 0.0)
    new_grid = torch.where(
        valid, torch.maximum(occ.density_grid * decay, tmp), occ.density_grid)
    mean_density = new_grid.clamp(min=0.0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    return OccupancyState(
        density_grid=new_grid,
        occ_bitfield=new_grid > thresh,
        mean_density=mean_density,
        iter_density=occ.iter_density + 1,
    )


@torch.no_grad()
def mark_untrained_grid(occ, poses, intrinsics, bound):
    """Mark cells seen by no camera as -1 (reference renderer.py:408-471).

    poses: [B, 4, 4] c2w (numpy or tensor); intrinsics: (fx, fy, cx, cy).
    The cells go in 64 chunks, as in the JAX package, so the [B, n, 3]
    camera-frame products stay small.
    """
    H = GRID_SIZE
    dev = occ.density_grid.device
    fx, fy, cx, cy = intrinsics
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    rot_t = poses[:, :3, :3].transpose(1, 2)  # world -> camera: R^T (p - t)
    trans = poses[:, None, :3, 3]
    coords = _linear_coords(torch.arange(H ** 3, device=dev))
    grid = occ.density_grid.clone()
    for c in range(grid.shape[0]):
        xyz, half = _cell_centers(coords, c, bound)
        covered = []
        for pts in xyz.chunk(64):
            cam = torch.einsum("bij,bnj->bni", rot_t, pts[None] - trans)  # [B, n, 3]
            mz = cam[..., 2] > 0
            mx = cam[..., 0].abs() < cx / fx * cam[..., 2] + half * 2
            my = cam[..., 1].abs() < cy / fy * cam[..., 2] + half * 2
            covered.append((mz & mx & my).any(dim=0))
        grid[c] = torch.where(torch.cat(covered), grid[c], -1.0)
    return occ._replace(density_grid=grid)
