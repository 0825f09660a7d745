"""Occupancy-accelerated ray-march renderer (static shapes, differentiable).

Counterpart of enerf_tpu/render/march.py (reference raymarching.cu:314-490
and renderer.py:281-401):
  - dt_min = 2*sqrt(3)/max_steps, dt_max = 2*sqrt(3)*2^(C-1)/H
  - dt = clamp(t * dt_gamma, dt_min, dt_max)
  - mip level = max(mip_from_pos, mip_from_dt); mip_bound = min(2^lvl, bound)
  - occupied cell -> emit samples; empty -> DDA skip to the next cell (or
    4^3 superblock) boundary, quantized to dt steps
Samples fill a fixed [N, S] buffer with a validity mask.

The march runs as kernel M1 (csrc/march_rays.cu) on CUDA tensors: one
thread per ray walks JAX's while_loop of skips inside its scan of emission
blocks in registers, with no host sync, so a training step can be
captured in a CUDA graph.  M1's pre-pass (`march_prepass`) folds the
bitfield into the superblock mask and the DDA exit table the kernel keeps
in shared memory; `render_rays_infer` makes it once a call for all its
windows.  On CPU tensors the march runs the plain version `_march`, Python
loops over the whole batch that stop once no ray is active: each skip
iteration costs one host sync (which also counts the lookups it makes,
`march_rays.lookups`, and each ray's, `march_rays.ray_lookups`).  The
march reads the bitfield packed into 32-bit words
(occupancy.pack_bitfield), which the occupancy update keeps beside the
bool bitfield.  `march_rays_pair` marches both renders of a ray pair in
one call.
`march_rays.launches` counts M1's launches, `march_prepass.launches` its
pre-pass's, `march_rays.host_syncs` the syncs of the plain version's
loops and of the inference renderer's windows.
"""

import ctypes

import numpy as np
import torch

from enerf_torch.models.field import background, field_forward, field_forward_fused
from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
from enerf_torch.ops.composite import transmittance
from enerf_torch.render.occupancy import GRID_SIZE, SUPER

SQRT3 = 1.7320508075688772
SKIP_ITERS = 64  # empty-space jumps per emitted sample block, at most
HS3 = (GRID_SIZE // SUPER) ** 3  # superblocks a cascade
EXIT_ROW = GRID_SIZE + GRID_SIZE // SUPER  # exit-table entries a (level, sign)
M1_THREADS = 64  # M1's threads a block: 1-2% faster than 32 on the H100 at every shape


def _mip_from_val(v, cascades):
    """frexp-based mip level: smallest l with v < 2^l (v in (0, inf))."""
    exp = torch.ceil(torch.log2(v.clamp(min=1e-30)))
    exp = torch.where(v >= torch.exp2(exp), exp + 1.0, exp)
    return exp.clamp(0, cascades - 1).to(torch.int64)


def num_cascades_of(occ_packed):
    """The cascades of a packed bitfield [CAS * (H/4)^3, 2]."""
    return occ_packed.shape[0] // HS3


def emit_k(max_steps):
    """Samples emitted per lookup when dt is constant (dt_gamma == 0)."""
    return max(1, min(4, int(round(max_steps / (SQRT3 * GRID_SIZE)))))


def _count(mask):
    """The set entries of `mask`: one host sync, counted."""
    march_rays.host_syncs += 1
    return int(mask.sum().item())


def _march(rays_o, rays_d, occ_packed, nears, fars, t0, *, num_samples,
           max_steps, cascades, bound, dt_gamma):
    H = GRID_SIZE
    HS = H // SUPER
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cascades - 1)) / H
    inv_d = 1.0 / rays_d
    sign_d = torch.sign(rays_d)
    live0 = nears < 1e30
    ray_lookups = torch.zeros(rays_o.shape[0], dtype=torch.int32, device=rays_o.device)
    march_rays.ray_lookups = ray_lookups

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
            active = _count(is_live)
            if not active:
                break
            march_rays.lookups += active
            ray_lookups.add_(is_live)
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


def _lib():
    from enerf_torch.ops.cuda_build import load_library
    lib = load_library("march_rays")
    if lib.march_rays_launch.argtypes is None:
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.march_rays_launch.argtypes = [vp] * 11 + [i32] * 6 + [f32] * 5 + [vp]
        lib.march_prepass_launch.argtypes = [vp, vp, i32, f32, f32, vp]
        lib.mip_check_launch.argtypes = [vp, vp]
        for fn in (lib.march_rays_launch, lib.march_prepass_launch, lib.mip_check_launch):
            fn.restype = ctypes.c_int
    return lib


def _inv_hm1():
    """1 / (H - 1) as ATen's scalar divide uses it: the host's float32 reciprocal."""
    return np.float32(1.0) / np.float32(GRID_SIZE - 1)


def _check_packed(occ_packed, cascades, dev):
    if (occ_packed.dtype != torch.int32 or occ_packed.device != dev
            or occ_packed.shape != (cascades * HS3, 2) or not occ_packed.is_contiguous()):
        raise ValueError(f"the march takes the packed bitfield [{cascades} * {HS3}, 2] int32 "
                         f"on the rays' device, got {tuple(occ_packed.shape)} "
                         f"{occ_packed.dtype} on {occ_packed.device}")


def march_aux_reference(occ_packed, cascades, bound):
    """Plain version of M1's pre-pass: [CAS * (1024 + 3 * 160)] int32, the
    superblock mask (bit s of word w: superblock 32 w + s, cascade-major,
    holds an occupied cell), then the DDA exit table as float32 bits,
    [level][sign + 1][j]: ((c * block + block / 2 + sgn * block / 2)
    * (1 / (H - 1)) * 2 - 1) * mip_bound for cell j (block 1) when j < 128,
    superblock j - 128 (block 4) above, rounded after each operation as the
    plain march's boundary() rounds on the card."""
    dev = occ_packed.device
    any_bit = (occ_packed != 0).any(-1).reshape(-1, 32).to(torch.int64)
    words = (any_bit << torch.arange(32, device=dev, dtype=torch.int64)).sum(-1)
    mask = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    j = torch.arange(EXIT_ROW, device=dev)
    cell = j < GRID_SIZE
    block = torch.where(cell, 1.0, float(SUPER))
    c = torch.where(cell, j, j - GRID_SIZE).float()
    sgn = torch.tensor([-1.0, 0.0, 1.0], device=dev)[:, None]
    part = (c * block + 0.5 * block) + sgn * (0.5 * block)
    part = part * torch.tensor(_inv_hm1(), device=dev) * 2.0 - 1.0     # [3, EXIT_ROW]
    mip_bound = torch.exp2(torch.arange(cascades, device=dev).float()).clamp(max=bound)
    table = part[None] * mip_bound[:, None, None]                      # [CAS, 3, EXIT_ROW]
    return torch.cat([mask, table.reshape(-1).view(torch.int32)])


def march_prepass(occ_packed, cascades, bound):
    """M1's pre-pass on the card: march_aux_reference's words from the
    packed bitfield, one thread a superblock.  The march makes it per
    launch unless its caller hands it in (`aux`), as the inference
    renderer does once a call."""
    dev = occ_packed.device
    if not occ_packed.is_cuda:
        raise ValueError("the march pre-pass runs on CUDA tensors")
    _check_packed(occ_packed, cascades, dev)
    aux = torch.empty(cascades * (HS3 // 32 + 3 * EXIT_ROW), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().march_prepass_launch(
            occ_packed.data_ptr(), aux.data_ptr(), cascades, float(np.float32(bound)),
            float(_inv_hm1()), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"march pre-pass launch failed: cudaError {err}")
    march_prepass.launches += 1
    return aux


march_prepass.launches = 0


def mip_check(device="cuda"):
    """The card's exhaustive check of M1's bit arithmetic: mismatches of the
    exponent mip level against ceil(log2) + exp2f on every non-negative
    float32 for 1-4 cascades, of x * 2^-l against x / 2^l on every float32
    for l = 1-3, and of exp2f(l) against 2^l for l = 0-3 (each 0 when M1 is
    exact)."""
    out = torch.zeros(3, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        err = _lib().mip_check_launch(out.data_ptr(),
                                      torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mip check launch failed: cudaError {err}")
    return dict(zip(("level", "division", "exp2"), out.tolist()))


def launch_kernel(rays_o, rays_d, occ_packed, nears, fars, t0, *, num_samples, max_steps,
                  cascades, bound, dt_gamma, aux=None):
    """Launch M1 on CUDA tensors -> (ts, dts [N, S] f32, valid [N, S] bool,
    t_end [N] f32), what `_march` returns on the same inputs.  rays [N, 3],
    nears / fars / t0 [N] f32; occ_packed [CAS * (H/4)^3, 2] int32; aux:
    march_prepass(occ_packed, cascades, bound), made here when not given."""
    N = rays_o.shape[0]
    dev = rays_o.device
    f32 = [rays_o, rays_d, nears, fars, t0]
    if not all(x.is_cuda and x.device == dev and x.dtype == torch.float32 for x in f32):
        raise ValueError("the march kernel takes float32 rays, nears, fars and t0 on one "
                         "CUDA device")
    if rays_o.shape != (N, 3) or rays_d.shape != (N, 3) or any(
            x.shape != (N,) for x in (nears, fars, t0)):
        raise ValueError(f"the march kernel takes rays [N, 3] and nears / fars / t0 [N], got "
                         f"{[tuple(x.shape) for x in f32]}")
    _check_packed(occ_packed, cascades, dev)
    if aux is None:
        aux = march_prepass(occ_packed, cascades, bound)
    elif aux.shape != (cascades * (HS3 // 32 + 3 * EXIT_ROW),) or aux.device != dev:
        raise ValueError(f"the march kernel's aux is march_prepass's output, got "
                         f"{tuple(aux.shape)} on {aux.device}")
    rays_o, rays_d, nears, fars, t0 = (x.contiguous() for x in f32)
    ts = torch.empty(N, num_samples, device=dev)
    dts = torch.empty(N, num_samples, device=dev)
    valid = torch.empty(N, num_samples, dtype=torch.bool, device=dev)
    t_end = torch.empty(N, device=dev)
    dt_min = np.float32(2.0 * SQRT3 / max_steps)
    dt_max = np.float32(2.0 * SQRT3 * (2 ** (cascades - 1)) / GRID_SIZE)
    k = emit_k(max_steps) if dt_gamma == 0.0 else 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().march_rays_launch(
            rays_o.data_ptr(), rays_d.data_ptr(), occ_packed.data_ptr(), aux.data_ptr(),
            nears.data_ptr(), fars.data_ptr(), t0.data_ptr(), ts.data_ptr(), dts.data_ptr(),
            valid.data_ptr(), t_end.data_ptr(), N, num_samples, k, int(dt_gamma == 0.0),
            cascades, M1_THREADS, float(dt_min), float(dt_max), float(np.float32(dt_gamma)),
            float(np.float32(bound)),
            # ATen divides by a Python scalar as a product with its float
            # reciprocal, computed on the host in float32
            float(np.float32(1.0) / dt_min), stream)
    if err != 0:
        raise RuntimeError(f"march kernel launch failed: cudaError {err}")
    march_rays.launches += 1
    return ts, dts, valid, t_end


def march(rays_o, rays_d, occ_packed, nears, fars, t0, *, num_samples, max_steps, cascades,
          bound, dt_gamma, aux=None):
    """(ts, dts, valid, t_end) of the march from t0: M1 on CUDA tensors, the
    plain version `_march` on CPU tensors (which needs no `aux`)."""
    kw = dict(num_samples=num_samples, max_steps=max_steps, cascades=cascades, bound=bound,
              dt_gamma=dt_gamma)
    if rays_o.is_cuda:
        return launch_kernel(rays_o, rays_d, occ_packed, nears, fars, t0, aux=aux, **kw)
    return _march(rays_o, rays_d, occ_packed, nears, fars, t0, **kw)


@torch.no_grad()
def march_rays(rays_o, rays_d, occ_packed, nears, fars, *, jitter=None,
               num_samples=64, max_steps=1024, cascades=1, bound=1.0,
               dt_gamma=0.0, perturb=False):
    """March N rays through the occupancy grid: kernel M1 on CUDA tensors,
    the plain version on CPU tensors.

    rays_o, rays_d: [N, 3]; occ_packed: the packed bitfield
    [CAS * (H/4)^3, 2] int32 (occupancy.pack_bitfield); nears, fars: [N]
    (FLT_MAX for misses).  With perturb, each ray's start moves by
    dt_min * jitter, jitter [N] in [0, 1) (the caller's random draw).

    Returns ts, dts [N, S] f32 and valid [N, S] bool.
    """
    t0 = nears
    if perturb:
        t0 = nears + (2.0 * SQRT3 / max_steps) * jitter
    ts, dts, valid, _ = march(
        rays_o, rays_d, occ_packed, nears, fars, t0, num_samples=num_samples,
        max_steps=max_steps, cascades=cascades, bound=bound, dt_gamma=dt_gamma)
    return ts, dts, valid


march_rays.launches = 0    # M1 launches (CUDA path only)
march_rays.host_syncs = 0  # host syncs: the plain version's skips, the infer windows
march_rays.lookups = 0     # the plain version's (ray, lookup) pairs: M1's operation count
march_rays.ray_lookups = None  # [N] int32: each ray's lookups in the plain version's last call


@torch.no_grad()
def march_rays_pair(rays_o, rays_d, occ_packed, nears, fars, *, jitter, **kw):
    """march_rays of both renders of a ray pair in one march (one M1
    launch): each of rays_o, rays_d, nears, fars and jitter is a pair (the
    first render's, the second's).  Returns ((ts, dts, valid), (ts, dts,
    valid)), each ray's what a march of its render alone gives."""
    n = rays_o[0].shape[0]
    ts, dts, valid = march_rays(*(torch.cat(x) for x in (rays_o, rays_d)), occ_packed,
                                *(torch.cat(x) for x in (nears, fars)),
                                jitter=torch.cat(jitter), **kw)
    return tuple((ts[s], dts[s], valid[s]) for s in (slice(None, n), slice(n, None)))


def _field_fn(static):
    return field_forward_fused if static.use_fused_head else field_forward


def composite_from_march(params, static, rays_o, rays_d, ts, dts, valid, nears,
                         fars, *, bg_color=1.0, density_scale=1.0,
                         compact_frac=None, return_weights=False):
    """Field evaluation + compositing of precomputed march samples.

    compact_frac: evaluate the field only on each ray's first
    S_eff = S * compact_frac valid samples, packed by a stable per-ray sort
    (valid samples beyond the budget are dropped, like the reference's
    capped stream compaction).  bg_color: float or [N, C] tensor; with the
    background net (bg_radius > 0) its colour instead.
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
    weights = alphas * transmittance(1.0 - alphas + 1e-15)
    weights_sum = weights.sum(-1)
    depth_t = (weights * ts).sum(-1)
    bg = background(params, static, rays_o, rays_d, bg_color, C)
    image = (weights[..., None] * rgbs).sum(-2) + (1.0 - weights_sum)[:, None] * bg
    near_safe = torch.where(nears < 1e30, nears, 0.0)
    far_safe = torch.where(fars < 1e30, fars, 1.0)
    depth = (depth_t - near_safe).clamp(min=0.0) / (far_safe - near_safe).clamp(min=1e-6)
    out = {"image": image, "depth": depth, "weights_sum": weights_sum}
    if return_weights:
        out["weights"], out["ts"], out["dts"] = weights, ts, dts
    return out


def render_rays_march(params, static, occ_packed, rays_o, rays_d, *,
                      num_samples=64, max_steps=1024, bg_color=1.0,
                      perturb=False, jitter=None, min_near=0.2,
                      density_scale=1.0, dt_gamma=0.0, compact_frac=None,
                      return_weights=False):
    """Occupancy-march render: near/far, march, composite.
    Returns dict(image=[N, C], depth=[N], weights_sum=[N])."""
    nears, fars = near_far_from_aabb(rays_o, rays_d,
                                     aabb_tensor(static.bound, rays_o.device), min_near)
    ts, dts, valid = march_rays(
        rays_o, rays_d, occ_packed, nears, fars, jitter=jitter,
        num_samples=num_samples, max_steps=max_steps,
        cascades=num_cascades_of(occ_packed), bound=static.bound, dt_gamma=dt_gamma,
        perturb=perturb)
    return composite_from_march(
        params, static, rays_o, rays_d, ts, dts, valid, nears, fars,
        bg_color=bg_color, density_scale=density_scale,
        compact_frac=compact_frac, return_weights=return_weights)


@torch.no_grad()
def render_rays_infer(params, static, occ_packed, rays_o, rays_d, *,
                      block=16, max_steps=1024, bg_color=1.0, min_near=0.2,
                      density_scale=1.0, dt_gamma=0.0):
    """Alive-ray inference renderer (reference raymarching.cu:701-938,
    renderer.py:344-401): march the alive rays one [N, block] window at a
    time (one march launch a window: M1 on CUDA tensors), composite
    incrementally, retire a ray once its transmittance drops below 1e-4,
    stop when every ray is dead; then what is left transmitted shows
    bg_color, or the background net's colour.  The check whether any ray
    is alive is this renderer's one host sync a window (counted in
    march_rays.host_syncs), at most max_iters = ceil(max_steps / block)
    windows (64 at the defaults) a call; JAX's while_loop makes that check
    on the device.  occ_packed: the packed bitfield; on the card M1's
    pre-pass runs once a call, for all its windows.
    Returns dict(image=[N, C], depth=[N], weights_sum=[N])."""
    N = rays_o.shape[0]
    dev = rays_o.device
    cascades = num_cascades_of(occ_packed)
    nears, fars = near_far_from_aabb(rays_o, rays_d,
                                     aabb_tensor(static.bound, dev), min_near)
    aux = march_prepass(occ_packed, cascades, static.bound) if rays_o.is_cuda else None
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
        if not _count(live):
            break
        # dead rays start at/after far so the marcher emits nothing
        t_start = torch.where(live, t, torch.maximum(t, fars))
        ts, dts, valid, t_end = march(
            rays_o, rays_d, occ_packed, t_start, fars, t_start, num_samples=B,
            max_steps=max_steps, cascades=cascades, bound=static.bound,
            dt_gamma=dt_gamma, aux=aux)
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

    bg = background(params, static, rays_o, rays_d, bg_color, C)
    near_safe = torch.where(nears < 1e30, nears, 0.0)
    far_safe = torch.where(fars < 1e30, fars, 1.0)
    depth = (dep - near_safe).clamp(min=0.0) / (far_safe - near_safe).clamp(min=1e-6)
    return {"image": rgb + T[:, None] * bg, "depth": depth, "weights_sum": 1.0 - T}
