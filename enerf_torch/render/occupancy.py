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
The update writes its results in place into the state's density grid,
bitfield, mean and packed bitfield (`occ_packed`, the 32-bit words the
march reads, packed once per update): a training window captured in a
CUDA graph reads those buffers at the addresses it was captured with.
The returned state holds the same tensors, with iter_density + 1.
Random draws come from a torch.Generator; tests inject the cell jitter
(`noise`).

`update_occupancy_sharded` is the data-parallel update: each rank queries
its share of the cells and one all_reduce merges the value and count
planes; its full phase equals the serial update bit for bit.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from enerf_torch.models.field import field_density

GRID_SIZE = 128
SUPER = 4  # cells per superblock side (the march's two-level skip)
DENSITY_SCALE_STEP = 0.003383  # 2*sqrt(3)/1024, renderer.py:513


class OccupancyState(NamedTuple):
    density_grid: torch.Tensor  # [CAS, H^3] f32; -1 marks untrained cells
    occ_bitfield: torch.Tensor  # [CAS, H^3] bool
    mean_density: torch.Tensor  # scalar f32
    iter_density: int           # updates done so far
    occ_packed: torch.Tensor    # [CAS * (H/4)^3, 2] int32: pack_bitfield(occ_bitfield)


def pack_bitfield(occ_bitfield, out=None):
    """[CAS, H^3] bool -> [CAS * (H/4)^3, 2] int32: each 4^3 superblock's 64
    cell bits as two 32-bit words (low word: cells 0..31), written into
    `out` when given."""
    H, HS = GRID_SIZE, GRID_SIZE // SUPER
    cas = occ_bitfield.shape[0]
    occ3 = occ_bitfield.reshape(cas, HS, SUPER, HS, SUPER, HS, SUPER)
    cells = occ3.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, 2, 32).to(torch.int64)
    shifts = torch.arange(32, device=cells.device, dtype=torch.int64)
    words = (cells << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    return words if out is None else out.copy_(words)


def occupancy_state(density_grid, occ_bitfield, mean_density, iter_density):
    """An OccupancyState with its packed bitfield made from occ_bitfield."""
    return OccupancyState(density_grid, occ_bitfield, mean_density, iter_density,
                          pack_bitfield(occ_bitfield))


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


def clone_occupancy(occ):
    """A copy of `occ` with tensors of its own (the update writes in place)."""
    return occ._replace(**{f: getattr(occ, f).clone() for f in occ._fields
                           if torch.is_tensor(getattr(occ, f))})


def init_occupancy(bound, device="cpu"):
    cas = num_cascades(bound)
    return occupancy_state(
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


def _resampled_cells(occ, c, n, generator):
    """n uniform random cells of cascade c and n occupied ones, uniform with
    replacement by inverse CDF (reference renderer.py:524-526)."""
    H3 = GRID_SIZE ** 3
    dev = occ.density_grid.device
    rand_idx = torch.randint(0, H3, (n,), device=dev, generator=generator)
    cdf = torch.cumsum((occ.density_grid[c] > 0.0).float(), 0)
    u = torch.rand(n, device=dev, generator=generator) * cdf[-1].clamp(min=1.0)
    occ_idx = torch.searchsorted(cdf, u, right=True).clamp(0, H3 - 1)
    return torch.cat([rand_idx, occ_idx])


def _query(params, static, cells, u3, c, n_chunks, density_scale):
    """The scaled densities at the centres of cascade c's `cells`, jittered
    by u3 [n, 3] in U[0, 1), in n_chunks field queries."""
    xyz, half = _cell_centers(_linear_coords(cells), c, static.bound)
    xyz = xyz + (u3 * 2.0 - 1.0) * half
    return torch.cat([
        field_density(params, static, part)[0]
        for part in xyz.chunk(n_chunks)
    ]) * (density_scale * DENSITY_SCALE_STEP)


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
    for c in range(cas):
        cells = (torch.arange(H ** 3, device=dev) if full else
                 _resampled_cells(occ, c, H ** 3 // 4, generator))
        u3 = (noise[c].to(dev) if noise is not None else
              torch.rand(cells.shape[0], 3, device=dev, generator=generator))
        tmp[c, cells] = _query(params, static, cells, u3, c, 64 if full else 16, density_scale)
    return _finish_update(occ, tmp, density_thresh, decay)


@torch.no_grad()
def update_occupancy_sharded(params, static, occ, generator=None, rank_generator=None, *,
                             mesh, density_scale=1.0, density_thresh=0.01, decay=0.95,
                             noise=None):
    """The data-parallel occupancy update (enerf_tpu's update_occupancy_sharded):
    each of the mesh's ranks queries its share of the cells, and one
    all_reduce SUM of the value and count planes merges them (a cell queried
    n times gets the mean of its n queries).

    The full phase (the first 16 updates) splits the serial update's 64
    query chunks over the ranks, with the serial update's jitter: `noise`
    [CAS, H^3, 3], or drawn from the shared `generator` as the serial update
    draws it.  Each query then sees the serial update's inputs, so the result
    equals update_occupancy's bit for bit (a mesh that does not divide 64
    queries one chunk per rank).  The resampling phase draws each rank's
    H^3 / 4 / world random and occupied cells and their jitter from
    `rank_generator`.  `mesh` needs rank, world_size and group."""
    H = GRID_SIZE
    dev = occ.density_grid.device
    cas = occ.density_grid.shape[0]
    W, r = mesh.world_size, mesh.rank
    full = occ.iter_density < 16
    if full and noise is None and generator is None:  # the global RNG differs per rank
        raise ValueError("the full phase draws its jitter from the shared generator: "
                         "pass `generator` (or `noise`)")
    if H ** 3 % (4 * W):
        raise ValueError(f"{W} ranks do not divide the {H}^3 / 4 resampled cells")
    n_chunks = 64 if 64 % W == 0 else W
    planes = torch.zeros(2, cas, H ** 3, device=dev)  # value, count
    for c in range(cas):
        if full:
            span = H ** 3 // W
            cells = torch.arange(r * span, (r + 1) * span, device=dev)
            u3 = (noise[c].to(dev) if noise is not None else
                  torch.rand(H ** 3, 3, device=dev, generator=generator))[r * span:(r + 1) * span]
            parts = n_chunks // W
        else:
            cells = _resampled_cells(occ, c, H ** 3 // 4 // W, rank_generator)
            u3 = torch.rand(cells.shape[0], 3, device=dev, generator=rank_generator)
            parts = max(16 // W, 1)
        sig = _query(params, static, cells, u3, c, parts, density_scale)
        planes[0, c].index_add_(0, cells, sig)
        planes[1, c].index_add_(0, cells, torch.ones_like(sig))
    dist.all_reduce(planes, group=mesh.group)
    val, cnt = planes
    tmp = torch.where(cnt > 0.0, val / cnt.clamp(min=1.0), -1.0)
    return _finish_update(occ, tmp, density_thresh, decay)


def _finish_update(occ, tmp, density_thresh, decay):
    """EMA decay + threshold + bitfield from the fresh queries `tmp`
    (reference renderer.py:528-563); cells with tmp < 0 are untouched.
    Written in place into occ's tensors (see the module docstring)."""
    valid = (occ.density_grid >= 0.0) & (tmp >= 0.0)
    new_grid = torch.where(
        valid, torch.maximum(occ.density_grid * decay, tmp), occ.density_grid)
    mean_density = new_grid.clamp(min=0.0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    occ.density_grid.copy_(new_grid)
    occ.mean_density.copy_(mean_density)
    torch.gt(new_grid, thresh, out=occ.occ_bitfield)
    pack_bitfield(occ.occ_bitfield, out=occ.occ_packed)
    return occ._replace(iter_density=occ.iter_density + 1)


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
