"""Ray/AABB intersection and the background sphere's polar coordinates.

Counterpart of enerf_tpu/ops/aabb.py (reference raymarching.cu:94-199):
slab test, miss -> FLT_MAX, near clamped to min_near.  Like the JAX
package, a box entirely behind the ray origin (far < min_near) is a miss.
`polar_from_ray` addresses the background net (bg_radius > 0).
"""

import functools

import torch

# FLT_MAX, matches the CUDA reference and enerf_tpu's _MISS
MISS = 3.4028234663852886e38


def near_far_from_aabb(rays_o, rays_d, aabb, min_near=0.2):
    """rays_o, rays_d: [..., 3]; aabb: [6] tensor (min xyz, max xyz).

    Returns nears, fars [...]; both FLT_MAX where the ray misses the box.
    """
    rd = 1.0 / rays_d  # inf on zero components, like the CUDA kernel
    t0 = (aabb[:3] - rays_o) * rd
    t1 = (aabb[3:] - rays_o) * rd
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = (near > far) | (far < min_near)
    near = near.clamp(min=min_near)
    miss_val = torch.full_like(near, MISS)
    return torch.where(miss, miss_val, near), torch.where(miss, miss_val, far)


@functools.lru_cache(maxsize=None)
def _aabb(bound, device):
    return torch.tensor([-bound, -bound, -bound, bound, bound, bound], dtype=torch.float32,
                        device=device)


def aabb_tensor(bound, device):
    """The [-bound, bound]^3 box as [6] f32 on `device`, made once per
    (bound, device): a copy from the host inside a training step would sync
    with it, which a captured CUDA graph cannot do.  Read-only."""
    return _aabb(float(bound), torch.device(device))


def polar_from_ray(rays_o, rays_d, radius):
    """Polar coordinates of the ray's exit through the background sphere of
    `radius` (reference raymarching.cu:165-199: the larger root, y up):
    [..., 2] = (2 theta / pi - 1, phi / pi) in [-1, 1]."""
    A = (rays_d * rays_d).sum(-1)
    B = (rays_o * rays_d).sum(-1)
    C = (rays_o * rays_o).sum(-1) - radius * radius
    t = (-B + torch.sqrt((B * B - A * C).clamp(min=0.0))) / A
    p = rays_o + t[..., None] * rays_d
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)
    phi = torch.atan2(z, x)
    return torch.stack([2.0 * theta / torch.pi - 1.0, phi / torch.pi], dim=-1)
