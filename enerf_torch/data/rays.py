"""Ray generation from camera poses and intrinsics.

Counterpart of enerf_tpu/data/rays.py (reference utils.py:111-216):
pinhole back-projection with normalized directions, rays of random pixels
of one view (uniform, or weighted by a 128 x 128 error map), and
paired-pose rays for events sharing one pixel unprojection.
"""

import torch


def pixel_dirs_cam(xs, ys, intrinsics):
    """Pixel coords [...] -> normalized camera-frame directions [..., 3]
    (right-down-front); intrinsics = (fx, fy, cx, cy)."""
    fx, fy, cx, cy = intrinsics
    dirs = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], dim=-1)
    return dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)


def get_rays_full(pose, intrinsics, H, W):
    """All-pixel rays for one [>=3, 4] pose tensor: rays_o, rays_d [H*W, 3]."""
    dev = pose.device
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    dirs = pixel_dirs_cam(i.reshape(-1), j.reshape(-1), intrinsics)
    rays_d = dirs @ pose[:3, :3].T
    return pose[:3, 3].expand_as(rays_d), rays_d


def get_rays_sampled(pose, intrinsics, H, W, n_rays, generator=None, inds=None,
                     error_map=None, inds_coarse=None, jitter=None):
    """Rays of n_rays random pixels of one view (reference utils.py:111-174):
    dict(rays_o, rays_d [N, 3], inds [N] int64 flat pixel indices).

    Uniform pixels, or with `error_map` ([128 * 128] weights) a weighted draw
    of cells of the 128 x 128 grid, each jittered to a pixel of its cell;
    the result then also holds `inds_coarse` [N].  The draws (`inds`, or
    `inds_coarse` and `jitter` [2, N] in [0, 1)) come from `generator`
    unless handed in."""
    dev = pose.device
    out = {}
    if error_map is not None:
        if inds_coarse is None:
            inds_coarse = torch.multinomial(error_map + 1e-12, n_rays, replacement=True,
                                            generator=generator)
        if jitter is None:
            jitter = torch.rand(2, n_rays, device=dev, generator=generator)
        sx, sy = H / 128.0, W / 128.0
        ix = torch.div(inds_coarse, 128, rounding_mode="floor").to(torch.float32)
        iy = (inds_coarse % 128).to(torch.float32)
        ix = (ix * sx + jitter[0] * sx).long().clamp(0, H - 1)
        iy = (iy * sy + jitter[1] * sy).long().clamp(0, W - 1)
        inds = ix * W + iy
        out["inds_coarse"] = inds_coarse
    elif inds is None:
        inds = torch.randint(0, H * W, (n_rays,), device=dev, generator=generator)
    i = (inds % W).to(torch.float32)
    j = torch.div(inds, W, rounding_mode="floor").to(torch.float32)
    rays_d = pixel_dirs_cam(i, j, intrinsics) @ pose[:3, :3].T
    out.update(rays_o=pose[:3, 3].expand_as(rays_d), rays_d=rays_d, inds=inds)
    return out


def get_event_rays(xs, ys, c2w_before, c2w_at, intrinsics):
    """Paired-pose rays for events (reference utils.py:185-216).

    xs, ys: [N]; c2w_before / c2w_at: [N, 3, 4] per-event poses.
    Returns dict(rays_evs_o1/d1/o2/d2: [N, 3]).
    """
    dirs = pixel_dirs_cam(xs, ys, intrinsics)
    d1 = torch.einsum("nkd,nd->nk", c2w_before[..., :3, :3], dirs)
    d2 = torch.einsum("nkd,nd->nk", c2w_at[..., :3, :3], dirs)
    return {
        "rays_evs_o1": c2w_before[..., :3, 3],
        "rays_evs_d1": d1,
        "rays_evs_o2": c2w_at[..., :3, 3],
        "rays_evs_d2": d2,
    }
