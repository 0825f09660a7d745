"""Fixed-step stratified volume renderer (the path every published config runs).

Counterpart of enerf_tpu/render/renderer.py (reference renderer.py:150-278,
`NeRFRenderer.run`, cuda_ray=False):
  - near/far from the AABB slab test, near clamped to min_near; a ray that
    misses gets the empty span [min_near, min_near];
  - z_vals = linspace(near, far, num_steps), with perturb a jitter of
    (u - 0.5) * (far - near) / num_steps per sample;
  - positions clipped to the box; optional PDF upsampling (renderer.py:
    196-228, sample_pdf :12-46), whose proposal carries no gradient;
  - deltas with a trailing (far - near) / num_steps, then `composite_rays`.

The random draws are tensors the caller passes (`jitter` [N, num_steps],
`u` [N, upsample_steps]) or draws from its torch.Generator, never keys, so
tests can hand in the JAX package's draws.  `field_fns` overrides
(density_fn, color_fn), as the golden tests do with an analytic field.
"""

import torch

from enerf_torch.models.field import field_color, field_density
from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
from enerf_torch.ops.composite import composite_rays


def sample_pdf(bins, weights, n_samples, det=False, u=None, generator=None):
    """Inverse-CDF sampling of new z values: bins [N, T], weights [N, T-1]
    -> [N, n_samples].  `u` [N, n_samples] in [0, 1) when not `det` (drawn
    from `generator` if not given)."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1).contiguous()  # [N, T]
    shape = (*cdf.shape[:-1], n_samples)
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           device=cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, device=cdf.device, generator=generator)
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def render_rays(params, static, rays_o, rays_d, *, num_steps=128, upsample_steps=0,
                bg_color=1.0, perturb=False, jitter=None, u=None, generator=None,
                train=True, min_near=0.2, density_scale=1.0, field_fns=None):
    """Render a flat batch of rays [N, 3] -> dict(image [N, C], depth [N],
    weights_sum [N]).  bg_color: float or a tensor broadcastable to [N, C]."""
    density_fn, color_fn = field_fns if field_fns is not None else (
        field_density, field_color)
    N = rays_o.shape[0]
    dev = rays_o.device
    bound = static.bound
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb_tensor(bound, dev), min_near)
    miss = nears >= 1e30
    nears = torch.where(miss, torch.full_like(nears, min_near), nears)
    fars = torch.where(miss, torch.full_like(fars, min_near), fars)

    t = torch.linspace(0.0, 1.0, num_steps, device=dev)
    z_vals = nears[:, None] + (fars - nears)[:, None] * t[None, :]  # [N, T]
    sample_dist = (fars - nears)[:, None] / num_steps
    if perturb:
        if jitter is None:
            jitter = torch.rand(N, num_steps, device=dev, generator=generator)
        z_vals = z_vals + (jitter - 0.5) * sample_dist

    def make_xyzs(z):
        return (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).clamp(-bound, bound)

    xyzs = make_xyzs(z_vals)
    sigmas, geo_feat = density_fn(params, static, xyzs.reshape(-1, 3))
    T_total = num_steps

    if upsample_steps > 0:
        with torch.no_grad():  # the proposal carries no gradient
            sig = sigmas.reshape(N, num_steps)
            deltas = torch.diff(z_vals, dim=-1)
            deltas = torch.cat([deltas, sample_dist.expand(N, 1)], -1)
            alphas = 1.0 - torch.exp(-deltas * density_scale * sig)
            one_m = 1.0 - alphas + 1e-15
            trans = torch.cumprod(
                torch.cat([torch.ones_like(one_m[..., :1]), one_m[..., :-1]], -1), -1)
            weights = alphas * trans
            z_mid = z_vals[..., :-1] + 0.5 * deltas[..., :-1]
            new_z = sample_pdf(z_mid, weights[:, 1:-1], upsample_steps, det=not train, u=u,
                               generator=generator)
        new_xyzs = make_xyzs(new_z)
        new_sigmas, new_geo = density_fn(params, static, new_xyzs.reshape(-1, 3))
        T_total = num_steps + upsample_steps
        z_vals = torch.cat([z_vals, new_z], 1)
        z_vals, order = torch.sort(z_vals, dim=1, stable=True)
        sigmas = torch.gather(
            torch.cat([sigmas.reshape(N, -1), new_sigmas.reshape(N, -1)], 1), 1,
            order).reshape(-1)
        G = geo_feat.shape[-1]
        geo_feat = torch.gather(
            torch.cat([geo_feat.reshape(N, num_steps, G),
                       new_geo.reshape(N, upsample_steps, G)], 1), 1,
            order[..., None].expand(N, T_total, G)).reshape(-1, G)

    deltas = torch.diff(z_vals, dim=-1)
    deltas = torch.cat([deltas, sample_dist.expand(N, 1)], -1)
    dirs = rays_d[:, None, :].expand(N, T_total, 3).reshape(-1, 3)
    rgbs = color_fn(params, static, dirs, geo_feat)
    C = rgbs.shape[-1]
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev).expand(N, C)
    out = composite_rays(sigmas.reshape(N, T_total), rgbs.reshape(N, T_total, C), deltas,
                         z_vals, nears, fars, bg, density_scale=density_scale)
    return {"image": out["image"], "depth": out["depth"], "weights_sum": out["weights_sum"]}


def render_rays_staged(params, static, rays_o, rays_d, *, max_ray_batch=4096, **kw):
    """Full-image rendering in chunks of max_ray_batch rays (reference
    renderer.py:579-594); per-ray noise tensors in `kw` (jitter, u, an
    [N, C] bg_color) are cut with the rays.  No host sync between chunks."""
    N = rays_o.shape[0]
    B = int(max_ray_batch)
    outs = []
    for s in range(0, N, B):
        ckw = {k: (v[s:s + B] if isinstance(v, torch.Tensor) and v.dim() >= 1
                   and v.shape[0] == N else v) for k, v in kw.items()}
        outs.append(render_rays(params, static, rays_o[s:s + B], rays_d[s:s + B], **ckw))
    return {k: torch.cat([o[k] for o in outs]) for k in ("image", "depth", "weights_sum")}
