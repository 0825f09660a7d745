"""Occupancy-accelerated ray-march renderer (static shapes, differentiable).

Counterpart of enerf_tpu/render/march.py (reference raymarching.cu:314-490
and renderer.py:281-401):
  - dt_min = 2*sqrt(3)/max_steps, dt_max = 2*sqrt(3)*2^(C-1)/H
  - dt = clamp(t * dt_gamma, dt_min, dt_max)
  - mip level = max(mip_from_pos, mip_from_dt); mip_bound = min(2^lvl, bound)
  - occupied cell -> emit samples; empty -> DDA skip to the next cell (or
    4^3 superblock) boundary, quantized to dt steps
Samples fill a fixed [N, S] buffer with a validity mask.

The JAX while_loops become Python loops that stop once no ray is active:
each skip iteration and each inference window costs one `.any().item()`
host sync.  `march_rays.host_syncs` counts them.
"""

import torch

from enerf_torch.models.field import field_forward, field_forward_fused
from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
from enerf_torch.render.occupancy import GRID_SIZE

SQRT3 = 1.7320508075688772
SUPER = 4  # cells per superblock dim (two-level empty-space skip)
SKIP_ITERS = 64  # empty-space jumps per emitted sample block, at most


def _mip_from_val(v, cascades):
    """frexp-based mip level: smallest l with v < 2^l (v in (0, inf))."""
    exp = torch.ceil(torch.log2(v.clamp(min=1e-30)))
    exp = torch.where(v >= torch.exp2(exp), exp + 1.0, exp)
    return exp.clamp(0, cascades - 1).to(torch.int64)


def pack_bitfield(occ_bitfield):
    """[CAS, H^3] bool -> [CAS * (H/4)^3, 2] int64: each 4^3 superblock's 64
    cell bits as two 32-bit words (low word: cells 0..31)."""
    H, HS = GRID_SIZE, GRID_SIZE // SUPER
    cas = occ_bitfield.shape[0]
    occ3 = occ_bitfield.reshape(cas, HS, SUPER, HS, SUPER, HS, SUPER)
    cells = occ3.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, 2, 32).to(torch.int64)
    shifts = torch.arange(32, device=cells.device, dtype=torch.int64)
    return (cells << shifts).sum(-1)


def emit_k(max_steps):
    """Samples emitted per lookup when dt is constant (dt_gamma == 0)."""
    return max(1, min(4, int(round(max_steps / (SQRT3 * GRID_SIZE)))))


def _any(mask):
    march_rays.host_syncs += 1
    return bool(mask.any().item())


def _march(rays_o, rays_d, occ_packed, nears, fars, t0, *, num_samples,
           max_steps, cascades, bound, dt_gamma):
    H = GRID_SIZE
    HS = H // SUPER
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cascades - 1)) / H
    inv_d = 1.0 / rays_d
    sign_d = torch.sign(rays_d)
    live0 = nears < 1e30

    def lookup(t):
        """occupancy + skip distance at parameter t.  All [N]."""
        pos = (rays_o + t[:, None] * rays_d).clamp(-bound, bound)
        dt = (t * dt_gamma).clamp(dt_min, dt_max)
        mx = pos.abs().amax(dim=-1)
        lvl = torch.maximum(_mip_from_val(mx, cascades),
                            _mip_from_val(dt * H * 0.5, cascades))
        mip_bound = torch.exp2(lvl.float()).clamp(max=bound)
        nxyz = (0.5 * (pos / mip_bound[:, None] + 1.0) * H).to(torch.int32)
        nxyz = nxyz.clamp(0, H - 1).to(torch.int64)
        sxyz = torch.div(nxyz, SUPER, rounding_mode="floor")
        scell = (lvl * (HS * HS * HS) + sxyz[:, 0] * (HS * HS)
                 + sxyz[:, 1] * HS + sxyz[:, 2])
        rows = occ_packed[scell]  # [N, 2] — the only gather
        lx = nxyz - sxyz * SUPER
        b = lx[:, 0] * (SUPER * SUPER) + lx[:, 1] * SUPER + lx[:, 2]
        word = torch.where(b < 32, rows[:, 0], rows[:, 1])
        occ = ((word >> (b % 32)) & 1) != 0
        occ_s = (rows[:, 0] | rows[:, 1]) != 0

        def boundary(nc, block):
            # DDA distance to the next (super)voxel boundary, normalized by
            # (H-1) for both granularities (raymarching.cu:389-396)
            nb = (((nc.float() * block + 0.5 * block + 0.5 * block * sign_d)
                   / (H - 1) * 2.0 - 1.0) * mip_bound[:, None] - pos) * inv_d
            return t + nb.amin(dim=-1).clamp(min=0.0)

        tt = torch.where(occ_s, boundary(nxyz, 1), boundary(sxyz, SUPER))
        return occ, dt, tt

    def find_cell(t, live):
        """Empty-space skip until every ray has found an occupied cell or
        died (at most SKIP_ITERS jumps).  Returns (t, found, dt, cell exit)."""
        found = torch.zeros_like(live)
        dtf = torch.full_like(t, dt_min)
        ttf = t
        for _ in range(SKIP_ITERS):
            is_live = live & (t < fars) & ~found
            if not _any(is_live):
                break
            occ, dt, tt = lookup(t)
            emit = is_live & occ
            dtf = torch.where(emit, dt, dtf)
            ttf = torch.where(emit, tt, ttf)
            if dt_gamma == 0.0:
                n_skip = torch.ceil((tt - t).clamp(min=0.0) / dt_min)
                t_skip = t + n_skip.clamp(min=1.0) * dt_min
            else:
                t_skip = torch.maximum(tt, t + dt)
            t = torch.where(is_live & ~occ, t_skip, t)
            found = found | emit
        return t, found, dtf, ttf

    t, live = t0, live0
    K = emit_k(max_steps)
    if dt_gamma == 0.0 and K > 1:
        ks = torch.arange(K, dtype=torch.float32, device=t.device)[:, None]  # [K, 1]
        ts, dts, valid = [], [], []
        for _ in range(-(-num_samples // K)):
            t_f, found, _, tt_f = find_cell(t, live)
            n_cell = torch.ceil((tt_f - t_f).clamp(min=0.0) / dt_min).clamp(min=1.0)
            ts_k = t_f[None, :] + ks * dt_min                      # [K, N]
            valid_k = found[None, :] & (ks < n_cell[None, :]) & (ts_k < fars[None, :])
            ts.append(ts_k)
            dts.append(torch.where(valid_k, dt_min, 0.0))
            valid.append(valid_k)
            t = torch.where(found, t_f + n_cell.clamp(max=float(K)) * dt_min, t_f)
            live = live & (t < fars)

        def cat(xs):
            return torch.cat(xs, 0).T[:, :num_samples]

        return cat(ts), cat(dts), cat(valid), t

    ts, dts, valid = [], [], []
    for _ in range(num_samples):
        t_f, found, dt_f, _ = find_cell(t, live)
        ts.append(t_f)
        dts.append(torch.where(found, dt_f, 0.0))
        valid.append(found)
        t = torch.where(found, t_f + dt_f, t_f)
        live = live & (t < fars)
    return (torch.stack(ts, 1), torch.stack(dts, 1), torch.stack(valid, 1), t)


@torch.no_grad()
def march_rays(rays_o, rays_d, occ_bitfield, nears, fars, *, jitter=None,
               num_samples=64, max_steps=1024, cascades=1, bound=1.0,
               dt_gamma=0.0, perturb=False):
    """March N rays through the occupancy grid.

    rays_o, rays_d: [N, 3]; occ_bitfield: [CAS, H^3] bool; nears, fars: [N]
    (FLT_MAX for misses).  With perturb, each ray's start moves by
    dt_min * jitter, jitter [N] in [0, 1) (the caller's random draw).

    Returns ts, dts [N, S] f32 and valid [N, S] bool.
    """
    t0 = nears
    if perturb:
        t0 = nears + (2.0 * SQRT3 / max_steps) * jitter
    ts, dts, valid, _ = _march(
        rays_o, rays_d, pack_bitfield(occ_bitfield), nears, fars, t0,
        num_samples=num_samples, max_steps=max_steps, cascades=cascades,
        bound=bound, dt_gamma=dt_gamma)
    return ts, dts, valid


march_rays.host_syncs = 0  # `.any().item()` syncs taken by march loops


def _field_fn(static):
    return field_forward_fused if static.use_fused_head else field_forward


def composite_from_march(params, static, rays_o, rays_d, ts, dts, valid, nears,
                         fars, *, bg_color=1.0, density_scale=1.0,
                         compact_frac=None, return_weights=False):
    """Field evaluation + compositing of precomputed march samples.

    compact_frac: evaluate the field only on each ray's first
    S_eff = S * compact_frac valid samples, packed by a stable per-ray sort
    (valid samples beyond the budget are dropped, like the reference's
    capped stream compaction).  bg_color: float or [N, C] tensor.
    """
    N, num_samples = ts.shape
    bound = static.bound
    if compact_frac is not None:
        S_eff = max(int(num_samples * compact_frac), 1)
        key = (~valid).to(torch.uint8)
        order = torch.sort(key, dim=1, stable=True).indices[:, :S_eff]
        ts = torch.gather(ts, 1, order)
        dts = torch.gather(dts, 1, order)
        valid = torch.gather(valid, 1, order)
        num_samples = S_eff

    xyzs = (rays_o[:, None, :] + rays_d[:, None, :] * ts[..., None]).clamp(-bound, bound)
    dirs = rays_d[:, None, :].expand_as(xyzs)
    sigmas, rgbs = _field_fn(static)(params, static, xyzs.reshape(-1, 3),
                                     dirs.reshape(-1, 3))
    C = rgbs.shape[-1]
    sigmas = torch.where(valid, sigmas.reshape(N, num_samples), 0.0)
    rgbs = rgbs.reshape(N, num_samples, C)

    alphas = 1.0 - torch.exp(-dts * density_scale * sigmas)
    one_m = 1.0 - alphas + 1e-15
    trans = torch.cumprod(
        torch.cat([torch.ones_like(one_m[..., :1]), one_m[..., :-1]], -1), -1)
    weights = alphas * trans
    weights_sum = weights.sum(-1)
    depth_t = (weights * ts).sum(-1)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=ts.device)
    bg = bg.expand(N, C)
    image = (weights[..., None] * rgbs).sum(-2) + (1.0 - weights_sum)[:, None] * bg
    near_safe = torch.where(nears < 1e30, nears, 0.0)
    far_safe = torch.where(fars < 1e30, fars, 1.0)
    depth = (depth_t - near_safe).clamp(min=0.0) / (far_safe - near_safe).clamp(min=1e-6)
    out = {"image": image, "depth": depth, "weights_sum": weights_sum}
    if return_weights:
        out["weights"], out["ts"], out["dts"] = weights, ts, dts
    return out


def render_rays_march(params, static, occ_bitfield, rays_o, rays_d, *,
                      num_samples=64, max_steps=1024, bg_color=1.0,
                      perturb=False, jitter=None, min_near=0.2,
                      density_scale=1.0, dt_gamma=0.0, compact_frac=None,
                      return_weights=False):
    """Occupancy-march render: near/far, march, composite.
    Returns dict(image=[N, C], depth=[N], weights_sum=[N])."""
    nears, fars = near_far_from_aabb(rays_o, rays_d,
                                     aabb_tensor(static.bound, rays_o.device), min_near)
    ts, dts, valid = march_rays(
        rays_o, rays_d, occ_bitfield, nears, fars, jitter=jitter,
        num_samples=num_samples, max_steps=max_steps,
        cascades=occ_bitfield.shape[0], bound=static.bound, dt_gamma=dt_gamma,
        perturb=perturb)
    return composite_from_march(
        params, static, rays_o, rays_d, ts, dts, valid, nears, fars,
        bg_color=bg_color, density_scale=density_scale,
        compact_frac=compact_frac, return_weights=return_weights)


@torch.no_grad()
def render_rays_infer(params, static, occ_bitfield, rays_o, rays_d, *,
                      block=16, max_steps=1024, bg_color=1.0, min_near=0.2,
                      density_scale=1.0, dt_gamma=0.0, occ_packed=None):
    """Alive-ray inference renderer (reference raymarching.cu:701-938,
    renderer.py:344-401): march the alive rays one [N, block] window at a
    time, composite incrementally, retire a ray once its transmittance drops
    below 1e-4, stop when every ray is dead (one host sync per window).
    Returns dict(image=[N, C], depth=[N], weights_sum=[N])."""
    N = rays_o.shape[0]
    dev = rays_o.device
    cascades = occ_bitfield.shape[0]
    nears, fars = near_far_from_aabb(rays_o, rays_d,
                                     aabb_tensor(static.bound, dev), min_near)
    if occ_packed is None:
        occ_packed = pack_bitfield(occ_bitfield)
    k = 1 if dt_gamma != 0.0 else emit_k(max_steps)
    B = max(1, -(-block // k)) * k  # whole emission blocks: no gaps
    max_iters = -(-max_steps // B)
    field = _field_fn(static)
    C = static.out_dim_color

    t = nears
    T = torch.ones(N, device=dev)
    rgb = torch.zeros(N, C, device=dev)
    dep = torch.zeros(N, device=dev)
    for _ in range(max_iters):
        live = (T > 1e-4) & (t < fars)
        if not _any(live):
            break
        # dead rays start at/after far so the marcher emits nothing
        t_start = torch.where(live, t, torch.maximum(t, fars))
        ts, dts, valid, t_end = _march(
            rays_o, rays_d, occ_packed, t_start, fars, t_start, num_samples=B,
            max_steps=max_steps, cascades=cascades, bound=static.bound,
            dt_gamma=dt_gamma)
        xyzs = (rays_o[:, None, :] + rays_d[:, None, :] * ts[..., None]).clamp(
            -static.bound, static.bound)
        dirs = rays_d[:, None, :].expand_as(xyzs)
        sigmas, rgbs = field(params, static, xyzs.reshape(-1, 3), dirs.reshape(-1, 3))
        sigmas = torch.where(valid, sigmas.reshape(N, B), 0.0)
        rgbs = rgbs.reshape(N, B, C)
        alphas = 1.0 - torch.exp(-dts * density_scale * sigmas)
        one_m = 1.0 - alphas + 1e-15
        trans_in = torch.cumprod(
            torch.cat([torch.ones_like(one_m[..., :1]), one_m[..., :-1]], -1), -1)
        w = T[:, None] * trans_in * alphas
        rgb = rgb + (w[..., None] * rgbs).sum(-2)
        dep = dep + (w * ts).sum(-1)
        T = T * one_m.prod(-1)
        t = torch.where(live, t_end, t)

    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev).expand(N, C)
    near_safe = torch.where(nears < 1e30, nears, 0.0)
    far_safe = torch.where(fars < 1e30, fars, 1.0)
    depth = (dep - near_safe).clamp(min=0.0) / (far_safe - near_safe).clamp(min=1e-6)
    return {"image": rgb + T[:, None] * bg, "depth": depth, "weights_sum": 1.0 - T}
