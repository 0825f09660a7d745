"""Parity of the port's losses, data path and one full train_step_events
with enerf_tpu, on the same batch, noise and weights."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t, unit_dirs

from enerf_tpu.data import events as jevents, rays as jrays, synthetic as jsyn
from enerf_tpu.models import field as jfield
from enerf_tpu.render import march as jmarch, occupancy as jocc
from enerf_tpu.train import losses as jlosses, state as jstate, step as jstep
from enerf_torch.convert import params_from_jax
from enerf_torch.data import events as tevents, rays as trays, synthetic as tsyn
from enerf_torch.models import field as tfield
from enerf_torch.render import march as tmarch
from enerf_torch.train import losses, state as tstate, step as tstep

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


# ------------------------------------------------------------------ losses

def test_event_loss_golden():
    """utils.py:482-573 event-loss math from preset renders (test_golden.py's
    event-pair cases, same tolerances)."""
    g = np.load(os.path.join(GOLDEN, "event_loss.npz"))
    pols = t(g["pols"])[..., None]
    delta = (losses.log_intensity(t(g["img2"]), False, True)
             - losses.log_intensity(t(g["img1"]), False, True))
    np.testing.assert_allclose(n(delta), g["cthres_delta_linlog"], atol=1e-5)
    le = float(losses.event_loss(delta, pols, C_thres=0.2))
    np.testing.assert_allclose(le, g["cthres_loss_evs"], rtol=1e-5)
    np.testing.assert_allclose(float(losses.event_loss(delta, pols, -1, event_only=True)),
                               g["norm_loss_evs"], rtol=1e-5)
    np.testing.assert_allclose(float(losses.event_loss(delta, pols, -1, event_only=False)),
                               g["norm_rgb_loss_evs"], rtol=1e-5)


def test_luma_linlog_golden():
    g = np.load(os.path.join(GOLDEN, "event_utils.npz"))
    np.testing.assert_allclose(n(losses.rgb_to_luma(t(g["rgb"]), esim=True)),
                               g["luma_esim"], atol=1e-6)
    np.testing.assert_allclose(n(losses.rgb_to_luma(t(g["rgb"]), esim=False)),
                               g["luma_709"], atol=1e-6)
    np.testing.assert_allclose(n(losses.lin_log(t(g["vals"]))), g["linlog"], atol=1e-6)


@pytest.mark.parametrize("use_luma,linlog", [(False, True), (True, True), (True, False)])
def test_log_intensity_and_losses_match_jax(use_luma, linlog):
    rng = np.random.default_rng(0)
    C = 3 if use_luma else 1
    img = rng.uniform(0, 1, (1, 300, C)).astype(np.float32)
    pol = rng.choice([-2.0, -1.0, 1.0, 3.0], (1, 300, 1)).astype(np.float32)
    lj = jlosses.log_intensity(jnp.asarray(img), use_luma, linlog)
    lt = losses.log_intensity(t(img), use_luma, linlog)
    np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-6, atol=1e-6)
    for c_thres, eo in ((0.2, True), (-1, True), (-1, False)):
        np.testing.assert_allclose(
            float(losses.event_loss(lt, t(pol), c_thres, eo)),
            float(jlosses.event_loss(lj, jnp.asarray(pol), c_thres, eo)), rtol=1e-5)


@pytest.mark.parametrize("count", [6, 7])
def test_implicit_C_nanmedian_averages_middle_pair(count):
    """jnp.nanmedian averages the two middle values of an even count;
    torch.nanmedian would return the lower one."""
    rng = np.random.default_rng(count)
    pol = rng.choice([-1.0, 1.0], count).astype(np.float32)
    pol[:2] = (1.0, -1.0)
    delta = rng.normal(size=count).astype(np.float32)
    ref = jlosses.estimate_implicit_C(jnp.asarray(pol), jnp.asarray(delta))
    got = losses.estimate_implicit_C(t(pol), t(delta))
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, equal_nan=True,
                                   err_msg=k)
    x = t(np.asarray([1.0, 4.0, np.nan, 2.0, 3.0], np.float32))
    assert float(losses.nanmedian(x)) == 2.5


# --------------------------------------------------------------------- data

def test_rays_match_jax():
    intr = jsyn.default_intrinsics(24, 32)
    pose = jsyn.circle_pose(0.3).astype(np.float32)
    oj, dj = jrays.get_rays_full(jnp.asarray(pose), intr, 24, 32)
    ot, dt = trays.get_rays_full(t(pose), intr, 24, 32)
    np.testing.assert_allclose(n(ot), np.asarray(oj), atol=1e-6)
    np.testing.assert_allclose(n(dt), np.asarray(dj), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(0)
    xs, ys = (rng.uniform(0, 32, 50).astype(np.float32) for _ in range(2))
    p1 = np.repeat(pose[None, :3], 50, 0)
    p2 = np.repeat(jsyn.circle_pose(0.31).astype(np.float32)[None, :3], 50, 0)
    rj = jrays.get_event_rays(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(p1),
                              jnp.asarray(p2), intr)
    rt = trays.get_event_rays(t(xs), t(ys), t(p1), t(p2), intr)
    for k in rj:
        np.testing.assert_allclose(n(rt[k]), np.asarray(rj[k]), rtol=1e-6, atol=1e-6)


def test_synthetic_copy_and_event_chains_match_jax():
    dj = jsyn.simulate_events(H=16, W=16, n_frames=8, C=0.2,
                              cache_dir=os.environ.get("ENERF_SYN_CACHE"))
    dt = tsyn.simulate_events(H=16, W=16, n_frames=8, C=0.2)
    np.testing.assert_array_equal(dt["events"], dj["events"])
    np.testing.assert_array_equal(dt["frames"], dj["frames"])
    cj, tsj = jevents.build_event_chains(dj["events"])
    ct, tst = tevents.build_event_chains(dt["events"])
    np.testing.assert_array_equal(tst, tsj)
    for k in ("xs", "ys", "ts", "pols", "cum_pols", "num_successors",
              "group_offset", "group_count"):
        np.testing.assert_array_equal(n(getattr(ct, k)), np.asarray(getattr(cj, k)), err_msg=k)
    np.testing.assert_array_equal(ct.frame_bounds, np.asarray(cj.frame_bounds))
    np.testing.assert_array_equal(ct.pixel_bounds, np.asarray(cj.pixel_bounds))
    # sampling with JAX's own draws
    for accumulate in (False, True):
        key = jax.random.PRNGKey(3)
        sj = jevents.sample_event_batch(key, cj, 0, 200, accumulate=accumulate,
                                        acc_max_num_evs=2 if accumulate else 0)
        lo, hi = (cj.frame_bounds if accumulate else cj.pixel_bounds)[0]
        k1, k2 = jax.random.split(key)
        draws = (np.asarray(jax.random.randint(k1, (200,), 0, max(int(hi - lo), 1))),
                 np.asarray(jax.random.uniform(k2, (200,))))
        st = tevents.sample_event_batch(ct, 0, 200, accumulate=accumulate,
                                        acc_max_num_evs=2 if accumulate else 0,
                                        draws=draws)
        for k in sj:
            np.testing.assert_array_equal(n(st[k]), np.asarray(sj[k]), err_msg=k)


# ---------------------------------------------------------------- train step

def _step_setup(share):
    # density_bias 3 (sigma ~ 20 at init) makes the renders half opaque, so
    # the density path carries gradients well above rounding
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
              encoding="blockgrid", use_fused_head=True, density_bias=3.0)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    # a table of U(+-1e-2), so the encoding carries gradients
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    rng = np.random.default_rng(1)
    pj["hash_table"] = jnp.asarray(
        rng.uniform(-1e-2, 1e-2, pj["hash_table"].shape).astype(np.float32))
    common = dict(min_near=0.2, density_scale=1.0, C_thres=0.2, event_only=True,
                  use_luma=False, linlog=True, out_dim_color=1,
                  march_samples=32, max_steps=1024, dt_gamma=0.0, compact_frac=0.5,
                  share_march=share, w_opacity=0.01, w_distortion=0.01)
    ss_j = jstep.StepStatics(field_static=sj, num_steps=64, upsample_steps=0,
                             weight_loss_rgb=1.0, negative_event_sampling=False,
                             w_no_ev=1.0, use_march=True, **common)
    ss_t = tstep.StepStatics(field_static=st, use_march=True, **common)
    N = 96
    o1 = unit_dirs(rng, N) * 2.5
    tgt = rng.uniform(-0.4, 0.4, (N, 3)).astype(np.float32)
    d1 = tgt - o1
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    o2 = o1 + rng.normal(scale=0.2, size=(N, 3)).astype(np.float32)
    d2 = d1 + rng.normal(scale=0.1, size=(N, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    batch = {"rays_evs_o1": o1, "rays_evs_d1": d1, "rays_evs_o2": o2,
             "rays_evs_d2": d2.astype(np.float32),
             "pols": rng.choice([-1.0, 1.0], N).astype(np.float32)}
    return ss_j, ss_t, pj, batch


@pytest.mark.parametrize("share", [False, True])
def test_train_step_events_matches_jax(share, monkeypatch):
    ss_j, ss_t, pj, batch = _step_setup(share)
    occ = np.asarray(jocc.ball_bitfield(radius=0.6))
    key = jax.random.PRNGKey(11)
    k_bg, k1, k2 = jax.random.split(key, 7)[:3]  # the draws event_loss_fn makes
    N = batch["pols"].shape[0]
    noise = {"bg": t(jax.random.uniform(k_bg, (1, 1))),
             "jitter1": t(jax.random.uniform(k1, (N,))),
             "jitter2": t(jax.random.uniform(k2, (N,)))}

    # Both steps composite the samples of JAX's march (march parity is held
    # by test_torch_render.py).  Inside its jit JAX may contract multiply-
    # adds into FMAs, so a sample can sit one ulp away; at the 2032-cell
    # level that can flip a block-grid floor() and move the sample's whole
    # table-gradient contribution to another row, which is not what this
    # test is about.
    march_keys = {id(noise["jitter1"]): k1, id(noise["jitter2"]): k2}

    def jax_march(rays_o, rays_d, occ_bitfield, nears, fars, *, jitter,
                  generator=None, **kw):
        out = jmarch.march_rays(*(jnp.asarray(n(a)) for a in
                                  (rays_o, rays_d, occ_bitfield, nears, fars)),
                                march_keys[id(jitter)], **kw)
        return tuple(t(a) for a in out)

    monkeypatch.setattr(tmarch, "march_rays", jax_march)
    monkeypatch.setattr(tstep, "march_rays", jax_march)
    # JAX: train_step_events' body, unjitted, to read the gradients too
    state_j, opt = jstate.init_train_state(pj, 0.005, 1000)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, aux_j), g_j = jax.value_and_grad(jstep.event_loss_fn, has_aux=True)(
        state_j.params, ss_j, bj, key, jnp.asarray(occ))
    new_j = jstate.apply_updates(state_j, g_j, opt)

    state_t = tstate.TrainState(params_from_jax(params_np(pj)), 0.005, 1000)
    aux_t = tstep.train_step_events(state_t, {k: t(v) for k, v in batch.items()},
                                    ss_t, t(occ), noise=noise)
    assert state_t.step == 1
    # losses through f32 renders, log-intensity x255 amplifies their
    # rounding: 1e-4 relative
    for k in ("loss_evs", "loss_opacity", "loss_distortion", "ws_mean"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(aux_t["loss"]), float(loss_j), rtol=1e-4)
    lr = 0.005
    for k, gj in g_j.items():
        gj = np.asarray(gj)
        gt = n(state_t.params[k].grad)
        scale = np.abs(gj).max()
        assert scale > 0, k
        # gradients: f32 backward through the same samples; the event pair's
        # two renders cancel in every gradient, so it is held at 1e-3 of the
        # tensor's largest entry rather than elementwise-relative
        tol = 1e-3
        np.testing.assert_allclose(gt, gj, rtol=0, atol=tol * scale, err_msg=k)
        # Adam's first step moves each entry by lr * g/|g|: equal where the
        # gradient is clear of that error, at most 2 lr apart elsewhere
        pj_new, pt_new = np.asarray(new_j.params[k]), n(state_t.params[k])
        clear = np.abs(gj) > 2 * tol * scale
        np.testing.assert_allclose(pt_new[clear], pj_new[clear], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        assert np.abs(pt_new - pj_new).max() <= 2 * lr * (1 + 1e-4), k
        ej, et = np.asarray(new_j.ema_params[k]), n(state_t.ema_params[k])
        np.testing.assert_allclose(et[clear], ej[clear], rtol=1e-5, atol=1e-7, err_msg=k)
        assert np.abs(et - ej).max() <= 2 * lr * (1 + 1e-4), k
