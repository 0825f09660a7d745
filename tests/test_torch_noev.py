"""Parity of the port's no-event pair with enerf_tpu: the device pose
interpolation, the no-event pixel arrays, and train_step_events with the
no-event hinge, on the same inputs, noise and weights."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t, unit_dirs
from torch_march_parity import per_render, unpack_bitfield

from enerf_tpu.data import poses as jposes, provider as jprov, synthetic as jsyn
from enerf_tpu.models import field as jfield
from enerf_tpu.render import march as jmarch, occupancy as jocc
from enerf_tpu.train import losses as jlosses, state as jstate, step as jstep
from enerf_torch.convert import params_from_jax
from enerf_torch.data import poses as tposes, provider as tprov
from enerf_torch.models import field as tfield
from enerf_torch.render import march as tmarch
from enerf_torch.render.occupancy import pack_bitfield
from enerf_torch.train import losses as tlosses, state as tstate, step as tstep

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _keyframes():
    d = jsyn.simulate_events(H=16, W=16, n_frames=8, C=0.2,
                             cache_dir=os.environ.get("ENERF_SYN_CACHE"))
    quats = jposes.mat_to_quat_np(d["poses"][:, :3, :3]).astype(np.float32)
    return (d["frame_ts"].astype(np.float32), quats,
            d["poses"][:, :3, 3].astype(np.float32), d)


def test_interp_pose_device_matches_jax():
    ts, quats, trans, _ = _keyframes()
    rng = np.random.default_rng(0)
    # inside the keyframes, on them, and past both ends (clamped)
    tq = np.concatenate([rng.uniform(ts[0], ts[-1], 300), ts,
                         [ts[0] - 0.1, ts[-1] + 0.1]]).astype(np.float32)
    pj = jposes.interp_pose_device(jnp.asarray(ts), jnp.asarray(quats), jnp.asarray(trans),
                                   jnp.asarray(tq))
    pt = tposes.interp_pose_device(t(ts), t(quats), t(trans), t(tq))
    assert pt.shape == (len(tq), 3, 4)
    # the same f32 operations in the same order: one f32 ulp of a pose entry
    np.testing.assert_allclose(n(pt), np.asarray(pj), rtol=0, atol=1e-6)
    q0, q1 = quats[rng.integers(0, 8, 50)], quats[rng.integers(0, 8, 50)]
    q1[:5] = q0[:5]  # theta = 0: the linear branch
    u = rng.uniform(size=50).astype(np.float32)
    np.testing.assert_allclose(n(tposes.slerp_device(t(q0), t(q1), t(u))),
                               np.asarray(jposes.slerp_device(jnp.asarray(q0), jnp.asarray(q1),
                                                              jnp.asarray(u))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(tposes.quat_to_mat(t(q0))),
                               np.asarray(jposes.quat_to_mat(jnp.asarray(q0))), rtol=0, atol=1e-6)


def test_device_slerp_rotations_match_host_golden():
    """The device slerp's rotations against the reference's scipy Slerp
    (golden slerp.npz); its translations are a cubic Hermite, not scipy's
    spline, so only the rotations are held (f32: 1e-5)."""
    g = np.load(os.path.join(GOLDEN, "slerp.npz"))
    quats = jposes.mat_to_quat_np(g["rots"]).astype(np.float32)
    pt = tposes.interp_pose_device(t(g["tss"].astype(np.float32)), t(quats),
                                   t(g["trans"].astype(np.float32)),
                                   t(g["tq"].astype(np.float32)))
    np.testing.assert_allclose(n(pt)[:, :3, :3], g["rots_out"], rtol=0, atol=1e-5)


def test_no_event_arrays_and_device_poses_match_jax():
    _, _, _, d = _keyframes()
    args = (d["events"], d["frame_ts"], d["poses"], d["intrinsics"], d["H"], d["W"])
    pj = jprov.EventProvider(*args, batch_size_evs=64, negative_event_sampling=True,
                             precompute_evs_poses=False)
    pt = tprov.EventProvider(*args, batch_size_evs=64, negative_event_sampling=True,
                             precompute_evs_poses=False)
    assert pt.poses_evs is None
    for k in ("noev_coords", "noev_count", "noev_t0", "noev_t1",
              "key_ts", "key_quats", "key_trans"):
        np.testing.assert_array_equal(n(getattr(pt, k)), np.asarray(getattr(pj, k)), err_msg=k)
    assert n(pt.noev_count).min() > 0
    idx = np.arange(0, int(pt.chains.ts.shape[0]), 7)
    np.testing.assert_allclose(n(pt._event_poses(t(idx))),
                               np.asarray(pj._event_poses(jnp.asarray(idx))), rtol=0, atol=1e-6)
    batch = pt.train_step_batch(torch.Generator().manual_seed(0))
    for k in ("o1", "d1", "o2", "d2"):
        v = n(batch[f"rays_no_evs_{k}"])
        assert v.shape == (32, 3) and np.isfinite(v).all(), k
    pt.use_no_ev = False  # the trainer's epoch gate
    assert "rays_no_evs_o1" not in pt.train_step_batch(torch.Generator().manual_seed(0))


def test_no_event_loss_matches_jax():
    rng = np.random.default_rng(1)
    delta = rng.normal(scale=0.3, size=(200, 1)).astype(np.float32)
    for c_thres, w in ((0.2, 1.0), (-1.0, 0.7)):
        np.testing.assert_allclose(float(tlosses.no_event_loss(t(delta), c_thres, w)),
                                   float(jlosses.no_event_loss(jnp.asarray(delta), c_thres, w)),
                                   rtol=1e-6)


def _pair(rng, count):
    o1 = unit_dirs(rng, count) * 2.5
    tgt = rng.uniform(-0.4, 0.4, (count, 3)).astype(np.float32)
    d1 = tgt - o1
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    o2 = o1 + rng.normal(scale=0.2, size=(count, 3)).astype(np.float32)
    d2 = d1 + rng.normal(scale=0.1, size=(count, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    return o1, d1.astype(np.float32), o2, d2.astype(np.float32)


@pytest.mark.parametrize("share", [False, True])
def test_train_step_with_no_event_pair_matches_jax(share, monkeypatch):
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
              encoding="blockgrid", use_fused_head=True, density_bias=3.0)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    rng = np.random.default_rng(2)
    # a table of U(+-0.5) and C = 0.005: the field varies enough across a
    # pair for the hinge to be active even when both renders share a march
    # (their log intensities then differ by ~0.01)
    pj["hash_table"] = jnp.asarray(
        rng.uniform(-0.5, 0.5, pj["hash_table"].shape).astype(np.float32))
    common = dict(min_near=0.2, density_scale=1.0, C_thres=0.005, event_only=True,
                  use_luma=False, linlog=True, out_dim_color=1, march_samples=32,
                  max_steps=1024, dt_gamma=0.0, compact_frac=0.5, share_march=share,
                  negative_event_sampling=True, w_no_ev=0.7)
    ss_j = jstep.StepStatics(field_static=sj, num_steps=64, upsample_steps=0,
                             weight_loss_rgb=1.0, use_march=True, **common)
    ss_t = tstep.StepStatics(field_static=st, use_march=True, **common)
    N, Mn = 96, 48
    batch = dict(zip(("rays_evs_o1", "rays_evs_d1", "rays_evs_o2", "rays_evs_d2"),
                     _pair(rng, N)))
    batch.update(zip(("rays_no_evs_o1", "rays_no_evs_d1", "rays_no_evs_o2", "rays_no_evs_d2"),
                     _pair(rng, Mn)))
    batch["pols"] = rng.choice([-1.0, 1.0], N).astype(np.float32)
    occ = np.asarray(jocc.ball_bitfield(radius=0.6))
    key = jax.random.PRNGKey(11)
    k_bg, k1, k2, k3, k4, k5 = jax.random.split(key, 7)[:6]  # event_loss_fn's draws
    noise = {"bg": t(jax.random.uniform(k_bg, (1, 1))),
             "jitter1": t(jax.random.uniform(k1, (N,))),
             "jitter2": t(jax.random.uniform(k2, (N,))),
             "bg_no_ev": t(jax.random.uniform(k3, (1, 1))),
             "jitter_no_ev1": t(jax.random.uniform(k4, (Mn,))),
             "jitter_no_ev2": t(jax.random.uniform(k5, (Mn,)))}
    march_keys = {id(noise[k]): kk for k, kk in (("jitter1", k1), ("jitter2", k2),
                                                  ("jitter_no_ev1", k4), ("jitter_no_ev2", k5))}

    # composite JAX's march samples, as tests/test_torch_train.py does (an
    # FMA-contracted sample position can flip a block-grid floor())
    def jax_march(rays_o, rays_d, occ_bitfield, nears, fars, *, jitter, **kw_):
        out = jmarch.march_rays(*(jnp.asarray(n(a)) for a in
                                  (rays_o, rays_d, unpack_bitfield(occ_bitfield), nears, fars)),
                                march_keys[id(jitter)], **kw_)
        return tuple(t(a) for a in out)

    monkeypatch.setattr(tmarch, "march_rays", jax_march)
    monkeypatch.setattr(tstep, "march_rays", jax_march)
    monkeypatch.setattr(tstep, "march_rays_pair", per_render(jax_march))
    state_j, opt = jstate.init_train_state(pj, 0.005, 1000)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, aux_j), g_j = jax.value_and_grad(jstep.event_loss_fn, has_aux=True)(
        state_j.params, ss_j, bj, key, jnp.asarray(occ))
    state_t = tstate.TrainState(params_from_jax(params_np(pj)), 0.005, 1000)
    aux_t = tstep.train_step_events(state_t, {k: t(v) for k, v in batch.items()},
                                    ss_t, pack_bitfield(t(occ)), noise=noise)
    assert float(aux_t["loss_no_evs"]) > 0  # the hinge is active
    # tolerances of tests/test_torch_train.py: losses 1e-4 relative,
    # gradients 1e-3 of each tensor's largest entry
    for k in ("loss_evs", "loss_no_evs"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(aux_t["loss"]), float(loss_j), rtol=1e-4)
    for k, gj in g_j.items():
        gj = np.asarray(gj)
        scale = np.abs(gj).max()
        assert scale > 0, k
        np.testing.assert_allclose(n(state_t.params[k].grad), gj, rtol=0, atol=1e-3 * scale,
                                   err_msg=k)
