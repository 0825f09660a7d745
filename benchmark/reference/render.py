"""Plain PyTorch reference of the fixed-step volume renderer (torch-ngp
renderer.py `run` with cuda_ray off, no upsampling, no background net):
the slab test against [-bound, bound]^3 with near clamped to min_near (a
miss, or a box behind the origin, renders the empty span [min_near,
min_near]), num_steps samples from near to far, each jittered by
(u - 0.5) (far - near) / num_steps when training, positions clipped to the
box, and the compositing

  alpha_i = 1 - exp(-delta_i density_scale sigma_i)
  T_i     = prod_{j<i} (1 - alpha_j + 1e-15)
  image   = sum_i alpha_i T_i rgb_i + (1 - sum_i alpha_i T_i) bg
  depth   = sum_i alpha_i T_i clip((z_i - near) / (far - near), 0, 1)

with deltas the gaps between samples and (far - near) / num_steps last.
"""

import torch


def near_far(rays_o, rays_d, bound, min_near):
    inv = 1.0 / rays_d
    t0 = (-bound - rays_o) * inv
    t1 = (bound - rays_o) * inv
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    miss = (near > far) | (far < min_near)
    near = near.clamp(min=min_near)
    near = torch.where(miss, torch.full_like(near, min_near), near)
    far = torch.where(miss, torch.full_like(far, min_near), far)
    return near, far


def sample_points(rays_o, rays_d, bound, num_steps, min_near, jitter=None):
    """-> (positions [N, T, 3] clipped to the box, z [N, T], near, far)."""
    near, far = near_far(rays_o, rays_d, bound, min_near)
    t = torch.linspace(0.0, 1.0, num_steps, device=rays_o.device)
    z = near[:, None] + (far - near)[:, None] * t[None, :]
    if jitter is not None:
        z = z + (jitter - 0.5) * ((far - near)[:, None] / num_steps)
    xyz = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).clamp(-bound, bound)
    return xyz, z, near, far


def render(field, params, rays_o, rays_d, num_steps, min_near, density_scale, bg,
           jitter=None):
    """rays [N, 3] -> dict(image [N, C], depth [N]); bg a float or [N, C]."""
    N = rays_o.shape[0]
    xyz, z, near, far = sample_points(rays_o, rays_d, field.bound, num_steps, min_near, jitter)
    sigma, geo = field.density(params, xyz.reshape(-1, 3))
    dirs = rays_d[:, None, :].expand(N, num_steps, 3).reshape(-1, 3)
    rgb = field.color(params, dirs, geo).reshape(N, num_steps, -1)
    sigma = sigma.reshape(N, num_steps)
    deltas = torch.cat([z[:, 1:] - z[:, :-1], ((far - near) / num_steps)[:, None]], -1)
    alpha = 1.0 - torch.exp(-deltas * density_scale * sigma)
    one_m = 1.0 - alpha + 1e-15
    trans = torch.cumprod(torch.cat([torch.ones_like(one_m[:, :1]), one_m[:, :-1]], -1), -1)
    w = alpha * trans
    wsum = w.sum(-1)
    span = (far - near)[:, None].clamp(min=1e-6)
    depth = (w * ((z - near[:, None]) / span).clamp(0.0, 1.0)).sum(-1)
    image = (w[..., None] * rgb).sum(-2) + (1.0 - wsum)[:, None] * bg
    return {"image": image, "depth": depth}
