"""Parity of the port's march, compositing, inference renderer and
occupancy upkeep with enerf_tpu, on the same bitfield, noise and weights."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t, unit_dirs

from enerf_tpu.models import field as jfield
from enerf_tpu.ops.aabb import near_far_from_aabb as jnear_far
from enerf_tpu.render import march as jmarch, occupancy as jocc
from enerf_torch.convert import occupancy_from_jax, params_from_jax
from enerf_torch.models import field as tfield
from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
from enerf_torch.render import march as tmarch, occupancy as tocc

BOX = np.asarray([-1, -1, -1, 1, 1, 1], np.float32)


def rays(count, seed=0):
    """Rays from a shell of radius ~2.5 aimed near the centre."""
    rng = np.random.default_rng(seed)
    o = unit_dirs(rng, count) * rng.uniform(2.0, 3.0, (count, 1)).astype(np.float32)
    target = rng.uniform(-0.5, 0.5, (count, 3)).astype(np.float32)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def fields(fused=True):
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
              encoding="blockgrid", use_fused_head=fused)
    sj = jfield.FieldStatic(**kw)
    st = tfield.FieldStatic(**kw)
    pj = jfield.init_field_params(jax.random.PRNGKey(3), sj)
    rng = np.random.default_rng(3)
    pj["hash_table"] = jnp.asarray(
        rng.uniform(-1.0, 1.0, pj["hash_table"].shape).astype(np.float32))
    return sj, st, pj, params_from_jax(params_np(pj))


def march_both(o, d, bitfield, dt_gamma, num_samples=64):
    nj, fj = jnear_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(BOX), 0.2)
    rng = jax.random.PRNGKey(5)
    out_j = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bitfield),
                              nj, fj, rng, num_samples=num_samples, max_steps=1024,
                              cascades=1, bound=1.0, dt_gamma=dt_gamma, perturb=True)
    jitter = np.asarray(jax.random.uniform(rng, (o.shape[0],)))  # JAX's own draw
    nt, ft = near_far_from_aabb(t(o), t(d), aabb_tensor(1.0, "cpu"), 0.2)
    out_t = tmarch.march_rays(t(o), t(d), tocc.pack_bitfield(t(bitfield)), nt, ft,
                              jitter=t(jitter), num_samples=num_samples, max_steps=1024,
                              cascades=1, bound=1.0, dt_gamma=dt_gamma, perturb=True)
    return out_j, out_t, (nj, fj), (nt, ft)


@pytest.mark.parametrize("dt_gamma", [0.0, 1.0 / 256])
def test_march_rays_matches_jax(dt_gamma):
    """dt_gamma = 0 takes the EMIT_K block-emission path, > 0 the
    one-lookup-per-sample path."""
    o, d = rays(256)
    bitfield = np.asarray(jocc.ball_bitfield())
    (tsj, dtsj, vj), (tst, dtst, vt), _, _ = march_both(o, d, bitfield, dt_gamma)
    assert n(vt).sum() > 1000  # rays do cross the ball
    # the cell math is integer and the t arithmetic is the same f32 ops in
    # the same order: the sample sets are identical
    vt, vj = n(vt), np.asarray(vj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(n(tst)[vt], np.asarray(tsj)[vj], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(dtst), np.asarray(dtsj), rtol=1e-6, atol=1e-7)
    # An invalid slot holds the t where the march stopped (weight 0).  With
    # dt_gamma > 0 the jitted JAX march may contract o + t*d into an FMA, so
    # the last skip past `far` can land one step apart; dt_gamma = 0
    # quantizes skips to dt_min and matches everywhere.
    if dt_gamma == 0.0:
        np.testing.assert_allclose(n(tst), np.asarray(tsj), rtol=1e-6, atol=1e-6)


def test_composite_from_march_with_compaction_matches_jax():
    sj, st, pj, pt = fields()
    o, d = rays(128, seed=1)
    bitfield = np.asarray(jocc.ball_bitfield(radius=0.6))
    (tsj, dtsj, vj), _, (nj, fj), (nt, ft) = march_both(o, d, bitfield, 0.0, 32)
    bg = np.random.default_rng(4).uniform(size=(128, 1)).astype(np.float32)
    out_j = jmarch.composite_from_march(
        pj, sj, jnp.asarray(o), jnp.asarray(d), tsj, dtsj, vj, nj, fj,
        bg_color=jnp.asarray(bg), compact_frac=0.5, return_weights=True)
    out_t = tmarch.composite_from_march(
        pt, st, t(o), t(d), t(tsj), t(dtsj), t(vj), nt, ft, bg_color=t(bg),
        compact_frac=0.5, return_weights=True)
    assert n(out_t["weights_sum"]).max() > 0.05  # the field is visible
    # f32 field + compositing: the fused-head forward tolerance
    for k in ("image", "depth", "weights_sum", "weights", "ts", "dts"):
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_render_rays_infer_matches_jax():
    sj, st, pj, pt = fields()
    o, d = rays(96, seed=2)
    bitfield = np.asarray(jocc.ball_bitfield(radius=0.6))
    out_j = jmarch.render_rays_infer(pj, sj, jnp.asarray(bitfield), jnp.asarray(o),
                                     jnp.asarray(d), block=16, max_steps=1024)
    out_t = tmarch.render_rays_infer(pt, st, tocc.pack_bitfield(t(bitfield)), t(o), t(d), block=16,
                                     max_steps=1024)
    assert n(out_t["weights_sum"]).max() > 0.05
    # The same samples composited over up to 64 windows.  Inside JAX's
    # jitted while_loop the sample positions o + t*d may be FMA-contracted,
    # which moves a position by an ulp and can flip a block-grid floor():
    # measured 3.6e-5 on weights_sum here, held at 1e-4.
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k]), rtol=0,
                                   atol=1e-4, err_msg=k)


def _jax_full_update_noise(key, cas):
    """The cell-jitter draws update_occupancy's full update makes from `key`."""
    H3 = jocc.GRID_SIZE ** 3
    _, k = jax.random.split(key)
    out, rng = [], k
    for _ in range(cas):
        rng, kc = jax.random.split(rng)
        keys = jax.random.split(kc, 64)
        out.append(np.concatenate([np.asarray(jax.random.uniform(kk, (H3 // 64, 3)))
                                   for kk in keys]))
    return np.stack(out)


def test_update_occupancy_full_matches_jax():
    sj, st, pj, pt = fields(fused=False)
    key = jax.random.PRNGKey(7)
    occ_j = jocc.update_occupancy(pj, sj, jocc.init_occupancy(1.0), key)
    noise = _jax_full_update_noise(key, 1)
    occ_t = tocc.update_occupancy(pt, st, tocc.init_occupancy(1.0), noise=t(noise))
    assert occ_t.iter_density == int(occ_j.iter_density) == 1

    # Reference: JAX's field_density at the same jittered cell centres,
    # computed op by op (no jit around the position math), then JAX's
    # _finish_update.  f32 field queries; JAX's block_encode is itself jitted
    # and its 125-cell row reductions are less exact (test_torch_ops.py):
    # measured 2.8e-5 relative at worst, held at 1e-4.
    H = jocc.GRID_SIZE
    idx = np.arange(H ** 3)
    coords = np.stack([idx // (H * H), (idx // H) % H, idx % H], -1).astype(np.float32)
    half = np.float32(1.0 / H)
    xyz = (np.float32(2.0) * coords / np.float32(H - 1) - np.float32(1.0)) * (np.float32(1.0) - half)
    xyz = xyz + (noise[0] * np.float32(2.0) - np.float32(1.0)) * half
    sig = np.concatenate([np.asarray(jfield.field_density(pj, sj, jnp.asarray(c))[0])
                          for c in np.array_split(xyz, 64)]) * np.float32(jocc.DENSITY_SCALE_STEP)
    ref = jocc._finish_update(jocc.init_occupancy(1.0), jnp.asarray(sig[None]), 0.01, 0.95)
    np.testing.assert_allclose(n(occ_t.density_grid), np.asarray(ref.density_grid),
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(float(occ_t.mean_density), float(ref.mean_density), rtol=1e-5)
    grid = np.asarray(ref.density_grid)
    thresh = min(float(ref.mean_density), 0.01)
    clear = np.abs(grid - thresh) > 1e-5 * thresh  # away from the threshold
    np.testing.assert_array_equal(n(occ_t.occ_bitfield)[clear],
                                  np.asarray(ref.occ_bitfield)[clear])

    # Against JAX's own jitted update: its position math may be
    # FMA-contracted, moving a query point by an ulp; where that flips a
    # block-grid floor() the cell's density changes (measured: 3e-5 of the
    # cells beyond 1e-4 relative).  All other cells agree to 1e-4.
    g_j = np.asarray(occ_j.density_grid)
    rel = np.abs(n(occ_t.density_grid) - g_j) / np.abs(g_j)
    assert (rel > 1e-4).mean() < 1e-4
    np.testing.assert_allclose(float(occ_t.mean_density), float(occ_j.mean_density), rtol=1e-4)


def test_finish_update_matches_jax():
    rng = np.random.default_rng(8)
    H3 = jocc.GRID_SIZE ** 3
    grid = rng.uniform(0, 0.02, (1, H3)).astype(np.float32)
    grid[:, :1000] = -1.0  # untrained cells stay untouched
    tmp = rng.uniform(0, 0.02, (1, H3)).astype(np.float32)
    tmp[:, rng.integers(0, H3, 5000)] = -1.0  # cells not queried
    occ_j = jocc.OccupancyState(jnp.asarray(grid), jnp.asarray(grid > 0),
                                jnp.zeros(()), jnp.asarray(20, jnp.int32))
    new_j = jocc._finish_update(occ_j, jnp.asarray(tmp), 0.01, 0.95)
    occ_t = occupancy_from_jax(grid, grid > 0, 0.0, 20)
    new_t = tocc._finish_update(occ_t, t(tmp), 0.01, 0.95)
    np.testing.assert_array_equal(n(new_t.density_grid), np.asarray(new_j.density_grid))
    # a 2M-element f32 mean, summed in another order
    np.testing.assert_allclose(float(new_t.mean_density), float(new_j.mean_density),
                               rtol=1e-5)
    np.testing.assert_array_equal(n(new_t.occ_bitfield), np.asarray(new_j.occ_bitfield))
    assert new_t.iter_density == 21


def test_update_occupancy_partial_branch_runs():
    """Past 16 updates: half random, half occupied cells (draws from a
    torch.Generator cannot match JAX's; the step after is held by
    test_finish_update_matches_jax)."""
    sj, st, pj, pt = fields(fused=False)
    grid = np.random.default_rng(9).uniform(0, 0.02, (1, jocc.GRID_SIZE ** 3))
    occ = occupancy_from_jax(grid, grid > 0.01, 0.01, 20)
    new = tocc.update_occupancy(pt, st, occ, torch.Generator().manual_seed(0))
    assert new.iter_density == 21
    g = n(new.density_grid)
    assert np.isfinite(g).all() and (g >= 0.95 * grid.astype(np.float32) - 1e-9).all()
