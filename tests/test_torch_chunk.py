"""The port's training window (train/chunk.py) against enerf_tpu's
make_train_chunk, and against the port's own per-step path, on the CPU.

JAX's window runs jitted; the test reproduces its key splits
(enerf_tpu/train/chunk.py:82, :111-112, :137) to draw each step's batch
with JAX's own samplers (`_event_sample_jit`, `_frames_sample_jit`, the
error map evolving as JAX's window evolves it), the steps' noise and the
occupancy update's jitter, and hands them to the port's window.  Held:
  - events with the occupancy update, K = 4 (the march composites JAX's
    march samples, as tests/test_torch_train.py does), and frames with the
    error map, K = 2: the window's mean loss terms at test_torch_train.py's
    1e-4, the params within 2 lr K of JAX's and 2.5e-2 of the window's
    update by norm, the error map at 1e-3, the occupancy grid at
    test_torch_render.py's bound;
  - the window on the CPU equals the occupancy update followed by K calls
    of the per-step path on the same draws, bit for bit;
  - the plain march's final t against JAX's return_final_t;
  - the compositing's capturable cumprod against autograd's, bit for bit.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t
from torch_march_parity import per_render

from enerf_tpu.data import provider as jprov, synthetic as jsyn
from enerf_tpu.models import field as jfield
from enerf_tpu.ops import hashgrid as jh
from enerf_tpu.ops.aabb import near_far_from_aabb as jnear_far
from enerf_tpu.render import march as jmarch, occupancy as jocc
from enerf_tpu.train import chunk as jchunk, state as jstate, step as jstep
from enerf_torch.convert import params_from_jax
from enerf_torch.data import provider as tprov
from enerf_torch.models import field as tfield
from enerf_torch.ops import hashgrid as th
from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
from enerf_torch.render import march as tmarch, occupancy as tocc
from enerf_torch.train import chunk as tchunk, state as tstate, step as tstep

LR, ITERS = 0.005, 1000


def _full_update_noise(key, cas=1):
    """The cell jitter update_occupancy's full update draws from `key`."""
    H3 = jocc.GRID_SIZE ** 3
    _, k = jax.random.split(key)
    out, rng = [], k
    for _ in range(cas):
        rng, kc = jax.random.split(rng)
        out.append(np.concatenate([np.asarray(jax.random.uniform(kk, (H3 // 64, 3)))
                                   for kk in jax.random.split(kc, 64)]))
    return np.stack(out)


# ------------------------------------------------------------------ events

def _events_setup():
    """The --ff -O field (block grid, fused head) at a small width, a 16 x 16
    synthetic event scene and JAX's event provider over it."""
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
              encoding="blockgrid", use_fused_head=True, density_bias=3.0)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    pj["hash_table"] = jnp.asarray(np.random.default_rng(1).uniform(
        -1e-2, 1e-2, pj["hash_table"].shape).astype(np.float32))
    common = dict(min_near=0.2, density_scale=1.0, C_thres=0.2, event_only=True,
                  use_luma=False, linlog=True, out_dim_color=1, march_samples=16,
                  max_steps=1024, dt_gamma=0.0, compact_frac=0.5, share_march=False,
                  w_opacity=0.01, w_distortion=0.01)
    ss_j = jstep.StepStatics(field_static=sj, num_steps=64, upsample_steps=0,
                             weight_loss_rgb=1.0, negative_event_sampling=False, w_no_ev=1.0,
                             use_march=True, **common)
    ss_t = tstep.StepStatics(field_static=st, use_march=True, **common)
    data = jsyn.simulate_events(H=16, W=16, n_frames=8, C=0.2)
    prov = jprov.EventProvider(data["events"], data["frame_ts"], data["poses"],
                               data["intrinsics"], 16, 16, batch_size_evs=64)
    return ss_j, ss_t, pj, prov


def _jax_event_window(ss_j, pj, prov, key, K):
    """JAX's window, and the draws its steps make: the occupancy jitter,
    each step's batch (its sampler on its key) and noise."""
    arrs, statics = prov.sampler_bundle()
    # the window donates its state: JAX's copy of the params
    state_j, opt = jstate.init_train_state(jax.tree.map(jnp.copy, pj), LR, ITERS)
    chunk = jchunk.make_train_chunk(ss_j, opt, "events", statics, chunk_len=K)
    new_j, occ_j, _, aux_j = chunk(state_j, jocc.init_occupancy(1.0), arrs, None, key)
    key, k_occ = jax.random.split(key)  # chunk.py:82
    batches, noises, march_keys = [], [], {}
    for k in jax.random.split(key, K):  # chunk.py:137
        k1, k2 = jax.random.split(k)  # chunk.py:111-112
        batch = jprov._event_sample_jit(k1, arrs, **statics)
        batches.append(({name: t(v) for name, v in batch.items()}, None))
        N = batch["pols"].shape[0]
        k_bg, kj1, kj2 = jax.random.split(k2, 7)[:3]  # event_loss_fn's draws
        noise = {"bg": t(jax.random.uniform(k_bg, (1, 1))),
                 "jitter1": t(jax.random.uniform(kj1, (N,))),
                 "jitter2": t(jax.random.uniform(kj2, (N,)))}
        march_keys[id(noise["jitter1"])], march_keys[id(noise["jitter2"])] = kj1, kj2
        noises.append(noise)
    return (new_j, occ_j, aux_j), (_full_update_noise(k_occ), batches, noises, march_keys)


def _jax_march(monkeypatch, march_keys, bitfield):
    """Both packages composite JAX's march samples (test_torch_train.py):
    the port's march reads JAX's bitfield and draws."""
    def jax_march(rays_o, rays_d, occ_bitfield, nears, fars, *, jitter, **kw):
        out = jmarch.march_rays(*(jnp.asarray(n(a)) for a in (rays_o, rays_d)),
                                jnp.asarray(bitfield), *(jnp.asarray(n(a)) for a in (nears, fars)),
                                march_keys[id(jitter)], **kw)
        return tuple(t(a) for a in out)

    monkeypatch.setattr(tmarch, "march_rays", jax_march)
    monkeypatch.setattr(tstep, "march_rays", jax_march)
    monkeypatch.setattr(tstep, "march_rays_pair", per_render(jax_march))


@pytest.fixture(scope="module")
def event_window():
    """JAX's K = 4 event window with the occupancy update, and its draws."""
    ss_j, ss_t, pj, prov = _events_setup()
    return ss_t, pj, 4, _jax_event_window(ss_j, pj, prov, jax.random.PRNGKey(5), 4)


def test_event_window_matches_jax_chunk(event_window, monkeypatch):
    ss_t, pj, K, ((new_j, occ_j, aux_j), (occ_noise, batches, noises, keys)) = event_window
    _jax_march(monkeypatch, keys, np.asarray(occ_j.occ_bitfield))
    state_t = tstate.TrainState(params_from_jax(params_np(pj)), LR, ITERS)
    chunk = tchunk.make_train_chunk(ss_t, "events", chunk_len=K)
    occ_t, aux_t = chunk(state_t, tocc.init_occupancy(1.0), None, batches=batches,
                         noises=noises, occ_noise=t(occ_noise))
    assert state_t.step == K and int(state_t.count) == K and occ_t.iter_density == 1
    # the occupancy update: test_torch_render.py's cross-package bound
    g_j, g_t = np.asarray(occ_j.density_grid), n(occ_t.density_grid)
    assert (np.abs(g_t - g_j) > 1e-4 * np.abs(g_j)).mean() < 1e-4
    # the window's means of the loss terms: f32 renders, 1e-4 relative
    for k in ("loss", "loss_evs", "loss_opacity", "loss_distortion", "ws_mean"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-4, err_msg=k)
    # params: each entry within 2 lr x K of JAX's (a step whose update took
    # the other sign moves an entry 2 lr apart at most), and each leaf's
    # difference within 2.5e-2 of the window's update by norm.  Over K steps
    # the packages' march samples drift apart (JAX's jitted window may
    # contract o + t d into an FMA and move a block-grid floor(),
    # test_torch_train.py), and Adam normalizes the small gradients that
    # differ most: measured 1.9e-2 on the table, 0.7e-2 or less elsewhere
    p0 = params_np(pj)
    for k, pj_new in new_j.params.items():
        pj_new, pt_new = np.asarray(pj_new), n(state_t.params[k])
        assert np.abs(pt_new - pj_new).max() <= 2 * K * LR * (1 + 1e-4), k
        assert np.linalg.norm(pt_new - pj_new) <= 2.5e-2 * np.linalg.norm(pj_new - p0[k]), k


def test_event_window_equals_update_then_per_step_path(event_window):
    """The window on the CPU is the occupancy update and K per-step calls,
    bit for bit, on the same draws (the port's own plain march)."""
    ss_t, pj, K, (_, (occ_noise, batches, noises, _)) = event_window
    a = tstate.TrainState(params_from_jax(params_np(pj)), LR, ITERS)
    b = tstate.TrainState(params_from_jax(params_np(pj)), LR, ITERS)
    chunk = tchunk.make_train_chunk(ss_t, "events", chunk_len=K)
    occ_a, aux = chunk(a, tocc.init_occupancy(1.0), None, batches=batches, noises=noises,
                       occ_noise=t(occ_noise))
    occ_b = tocc.update_occupancy(b.params, ss_t.field_static, tocc.init_occupancy(1.0),
                                  noise=t(occ_noise))
    losses = []
    for (batch, _), noise in zip(batches, noises):
        losses.append(tstep.train_step_events(b, batch, ss_t, occ_b.occ_packed,
                                              noise=noise)["loss"])
    assert a.step == b.step == K
    for d_a, d_b in ((a.params, b.params), (a.ema_params, b.ema_params),
                     (a.exp_avg, b.exp_avg), (a.exp_avg_sq, b.exp_avg_sq)):
        for k in d_a:
            assert torch.equal(d_a[k], d_b[k]), k
    assert torch.equal(a.count, b.count)
    for f in ("density_grid", "occ_bitfield", "occ_packed", "mean_density"):
        assert torch.equal(getattr(occ_a, f), getattr(occ_b, f)), f
    assert float(aux["loss"]) == pytest.approx(float(torch.stack(losses).mean()), rel=1e-6)


# ------------------------------------------------------------------ frames

def _frames_setup():
    """The published configs' path at a small width: the hash grid (finest
    level 64 cells, test_torch_frames_mode.py), 16 fixed steps."""
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    grid = dict(num_levels=4, level_dim=2, log2_hashmap_size=13, desired_resolution=64)
    sj.grid_meta, st.grid_meta = jh.HashGridMeta(**grid), th.HashGridMeta(**grid)
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    pj["hash_table"] = jnp.asarray(np.random.default_rng(1).uniform(
        -0.5, 0.5, pj["hash_table"].shape).astype(np.float32))
    common = dict(min_near=0.2, density_scale=1.0, C_thres=0.2, event_only=False,
                  use_luma=False, linlog=True, out_dim_color=1, num_steps=16)
    ss_j = jstep.StepStatics(field_static=sj, upsample_steps=0, weight_loss_rgb=1.0,
                             negative_event_sampling=False, w_no_ev=1.0, **common)
    ss_t = tstep.StepStatics(field_static=st, **common)
    data = jsyn.simulate_events(H=24, W=20, n_frames=6, C=0.2)
    return ss_j, ss_t, pj, data["frames"], data["poses"], data["intrinsics"]


def test_frames_window_with_the_error_map_matches_jax_chunk():
    ss_j, ss_t, pj, images, poses, intr = _frames_setup()
    K, R = 2, 96
    pj_prov = jprov.FramesProvider(images, poses, intr, num_rays=R, error_map=True)
    arrs, statics = pj_prov.sampler_bundle()
    emap0 = np.random.default_rng(2).uniform(0.1, 1, (6, 128 * 128)).astype(np.float32)
    state_j, opt = jstate.init_train_state(jax.tree.map(jnp.copy, pj), LR, ITERS)
    chunk_j = jchunk.make_train_chunk(ss_j, opt, "frames", statics, chunk_len=K,
                                      use_occ=False)
    key = jax.random.PRNGKey(9)
    new_j, _, emap_j, aux_j = chunk_j(state_j, None, arrs, jnp.asarray(emap0), key)

    # JAX's window unrolled: each step's batch drawn from the map as it is
    # then, its noise, and the map's update with JAX's per-ray loss
    batches, noises, emap = [], [], jnp.asarray(emap0)
    st_unrolled = jstate.init_train_state(pj, LR, ITERS)[0]
    for k in jax.random.split(key, K):
        k1, k2 = jax.random.split(k)
        batch, fi, ic = jprov._frames_sample_jit(k1, arrs["poses"], arrs["images"], emap,
                                                 arrs["intrinsics"], **statics)
        (loss, aux), grads = jax.value_and_grad(jstep.frames_loss_fn, has_aux=True)(
            st_unrolled.params, ss_j, batch, k2, None)
        st_unrolled = jstate.apply_updates(st_unrolled, grads, opt)
        emap = emap.at[fi, ic].set(0.1 * emap[fi, ic] + 0.9 * aux["per_ray_loss"])
        cells = (torch.full((R,), int(fi), dtype=torch.int64), t(ic).long())
        batches.append(({name: t(v) for name, v in batch.items()}, cells))
        k_bg, k_r = jax.random.split(k2)  # frames_loss_fn's draws
        k_pert, _ = jax.random.split(k_r)
        noises.append({"bg_frames": t(jax.random.uniform(k_bg, (R, 1))),
                       "jitter_frames": t(jax.random.uniform(k_pert, (R, 16)))})

    pt_prov = tprov.FramesProvider(images, poses, intr, num_rays=R, error_map=True)
    pt_prov.error_map = t(emap0)
    state_t = tstate.TrainState(params_from_jax(params_np(pj)), LR, ITERS)
    chunk_t = tchunk.make_train_chunk(ss_t, "frames", chunk_len=K, use_occ=False,
                                      error_map=True)
    occ, aux_t = chunk_t(state_t, None, pt_prov, batches=batches, noises=noises)
    assert occ is None and state_t.step == K
    for k in ("loss", "loss_frames"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-4, err_msg=k)
    # the map: per-ray losses of f32 renders (test_torch_frames_mode.py's
    # 1e-3 relative), the cells JAX's window touched and no other
    got, ref = n(pt_prov.error_map), np.asarray(emap_j)
    assert (got != emap0).any() and ((got != emap0) == (ref != emap0)).all()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6)
    for k, pj_new in new_j.params.items():
        pj_new, pt_new = np.asarray(pj_new), n(state_t.params[k])
        assert np.abs(pt_new - pj_new).max() <= 2 * K * LR * (1 + 1e-4), k
        close = np.abs(pt_new - pj_new) <= 1e-5 + 1e-5 * np.abs(pj_new)
        assert close.mean() > 0.99, (k, close.mean())
    # the unrolled window is JAX's window
    for k, v in new_j.params.items():
        np.testing.assert_allclose(np.asarray(st_unrolled.params[k]), np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------------------- march

@pytest.mark.parametrize("dt_gamma", [0.0, 1.0 / 256])
def test_plain_march_final_t_matches_jax(dt_gamma):
    rng = np.random.default_rng(4)
    o = rng.normal(size=(256, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    bitfield = np.asarray(jocc.ball_bitfield())
    box = jnp.asarray([-1, -1, -1, 1, 1, 1], jnp.float32)
    nj, fj = jnear_far(jnp.asarray(o), jnp.asarray(d), box, 0.2)
    key = jax.random.PRNGKey(3)
    ts_j, _, valid_j, t_end_j = jmarch.march_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(bitfield), nj, fj, key, num_samples=16,
        max_steps=1024, cascades=1, bound=1.0, dt_gamma=dt_gamma, perturb=True,
        return_final_t=True)
    nt, ft = near_far_from_aabb(t(o), t(d), aabb_tensor(1.0, "cpu"), 0.2)
    t0 = nt + (2.0 * tmarch.SQRT3 / 1024) * t(jax.random.uniform(key, (256,)))
    _, _, valid_t, t_end_t = tmarch._march(
        t(o), t(d), tocc.pack_bitfield(t(bitfield)), nt, ft, t0, num_samples=16,
        max_steps=1024, cascades=1, bound=1.0, dt_gamma=dt_gamma)
    np.testing.assert_array_equal(n(valid_t), np.asarray(valid_j))
    assert n(valid_t).sum() > 500
    # test_torch_render.py's bound on the march's t values.  With dt_gamma
    # > 0 JAX's jitted o + t d may be an FMA, so a ray's last skip past its
    # far can land one step apart: there both stopped beyond far
    te_t, te_j, far = n(t_end_t), np.asarray(t_end_j), np.asarray(fj)
    apart = ~np.isclose(te_t, te_j, rtol=1e-6, atol=1e-6)
    if dt_gamma == 0.0:
        assert not apart.any()
    assert ((te_t[apart] >= far[apart]) & (te_j[apart] >= far[apart])).all()
    assert apart.mean() < 0.02


def test_transmittance_backward_is_autograds_without_a_host_read():
    """The compositing's exclusive cumprod (a capturable backward) gives
    autograd's own gradient bit for bit on factors 1 - alpha + 1e-15."""
    from enerf_torch.ops.composite import transmittance
    rng = np.random.default_rng(6)
    alphas = rng.uniform(0, 1, (64, 33)).astype(np.float32)
    alphas[:, 5] = 1.0  # opaque samples: the factor is 1e-15, not 0
    one_m = (1.0 - t(alphas) + 1e-15).requires_grad_(True)
    g = t(rng.normal(size=(64, 33)).astype(np.float32))
    ours = transmittance(one_m)
    ref = torch.cumprod(torch.cat([torch.ones_like(one_m[..., :1]), one_m[..., :-1]], -1), -1)
    assert torch.equal(ours, ref)
    g_ours, = torch.autograd.grad(ours, one_m, g)
    g_ref, = torch.autograd.grad(ref, one_m, g)
    assert torch.equal(g_ours, g_ref)
