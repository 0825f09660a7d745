"""Ray/AABB intersection.

Counterpart of enerf_tpu/ops/aabb.py (reference raymarching.cu:94-158):
slab test, miss -> FLT_MAX, near clamped to min_near.  Like the JAX
package, a box entirely behind the ray origin (far < min_near) is a miss.
"""

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


def aabb_tensor(bound, device):
    b = float(bound)
    return torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=device)
