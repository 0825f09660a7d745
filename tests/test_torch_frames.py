"""Parity of the port's default training path with enerf_tpu: sampled frame
rays, the frame loss, mark_untrained_grid, one full event_only=0 hash-grid
fixed-step train_step_events with the noise handed in, the remat modes,
the synthetic provider with frames, hash-grid checkpoints both ways and the
march_warmup phases of the trainer."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t, unit_dirs

from enerf_tpu.data import provider as jprov, rays as jrays, synthetic as jsyn
from enerf_tpu.models import field as jfield
from enerf_tpu.ops import hashgrid as jh
from enerf_tpu.render import occupancy as jocc
from enerf_tpu.train import checkpoints as jckpt, state as jstate, step as jstep
from enerf_torch.config import build_config
from enerf_torch.convert import params_from_jax
from enerf_torch.data import provider as tprov, rays as trays
from enerf_torch.models import field as tfield
from enerf_torch.ops import hashgrid as th
from enerf_torch.render import march as tmarch, occupancy as tocc
from enerf_torch.train import checkpoints as tckpt, state as tstate, step as tstep
from enerf_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_get_rays_sampled_matches_jax():
    intr = jsyn.default_intrinsics(24, 32)
    pose = jsyn.circle_pose(0.2).astype(np.float32)
    key = jax.random.PRNGKey(4)
    rj = jrays.get_rays_sampled(key, jnp.asarray(pose), intr, 24, 32, 300)
    rt = trays.get_rays_sampled(t(pose), intr, 24, 32, 300, inds=t(rj["inds"]).long())
    np.testing.assert_array_equal(n(rt["inds"]), np.asarray(rj["inds"]))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(n(rt[k]), np.asarray(rj[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    drawn = trays.get_rays_sampled(t(pose), intr, 24, 32, 300,
                                   generator=torch.Generator().manual_seed(0))["inds"]
    assert drawn.shape == (300,) and 0 <= int(drawn.min()) and int(drawn.max()) < 24 * 32


def _statics(upsample=0, encoding="hashgrid", **extra):
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
              encoding=encoding)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    if encoding == "hashgrid":
        # finest level 64 cells: inside its jit JAX may contract o + t * d
        # into an FMA, and an ulp of a position moves the trilinear weights
        # by ulp * resolution; at 2048 cells that alone reaches 1e-3 of a
        # gradient's scale (test_addresses_match_jax holds that effect)
        grid = dict(num_levels=4, level_dim=2, log2_hashmap_size=13, desired_resolution=64)
        sj.grid_meta, st.grid_meta = jh.HashGridMeta(**grid), th.HashGridMeta(**grid)
        assert st.grid_meta.is_hashed.sum() == 3
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    rng = np.random.default_rng(1)
    # a table of U(+-0.5): encodings, densities and gradients well above rounding
    pj["hash_table"] = jnp.asarray(
        rng.uniform(-0.5, 0.5, pj["hash_table"].shape).astype(np.float32))
    common = dict(min_near=0.2, density_scale=1.0, C_thres=0.2, event_only=False,
                  use_luma=False, linlog=True, out_dim_color=1, num_steps=32,
                  upsample_steps=upsample, weight_loss_rgb=0.7, w_opacity=0.01, **extra)
    ss_j = jstep.StepStatics(field_static=sj, negative_event_sampling=False, w_no_ev=1.0,
                             **common)
    ss_t = tstep.StepStatics(field_static=st, **common)
    return ss_j, ss_t, pj


def _batch(rng, N=64, Nf=48, alpha=False):
    o1 = unit_dirs(rng, N) * 2.5
    d1 = rng.uniform(-0.4, 0.4, (N, 3)).astype(np.float32) - o1
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    o2 = o1 + rng.normal(scale=0.2, size=(N, 3)).astype(np.float32)
    d2 = d1 + rng.normal(scale=0.1, size=(N, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    of = np.repeat(unit_dirs(rng, 1) * 2.5, Nf, 0)
    df = rng.uniform(-0.6, 0.6, (Nf, 3)).astype(np.float32) - of
    df /= np.linalg.norm(df, axis=-1, keepdims=True)
    df[:3] = -df[:3]  # rays that miss the box
    images = rng.uniform(0, 1, (Nf, 2 if alpha else 1)).astype(np.float32)
    return {"rays_evs_o1": o1, "rays_evs_d1": d1, "rays_evs_o2": o2.astype(np.float32),
            "rays_evs_d2": d2.astype(np.float32), "pols": rng.choice([-1.0, 1.0], N).astype(
                np.float32), "rays_o": of.astype(np.float32), "rays_d": df, "images": images}


def _render_noise(key, n_rays, ss):
    """The draws render_rays makes from its key: jitter, and u with upsampling."""
    k_pert, k_pdf = jax.random.split(key)
    out = {"jitter": t(jax.random.uniform(k_pert, (n_rays, ss.num_steps)))}
    if ss.upsample_steps:
        out["u"] = t(jax.random.uniform(k_pdf, (n_rays, ss.upsample_steps)))
    return out


def _jax_noise(key, ss, N, Nf):
    """The draws event_loss_fn and frames_loss_fn make from `key`."""
    k_bg, k1, k2, _, _, _, kf = jax.random.split(key, 7)
    k_bgf, k_r = jax.random.split(kf)
    noise = {"bg": t(jax.random.uniform(k_bg, (1, 1))),
             "bg_frames": t(jax.random.uniform(k_bgf, (Nf, 1)))}
    for name, k, count in (("1", k1, N), ("2", k2, N), ("_frames", k_r, Nf)):
        noise.update({f"{v}{name}": x for v, x in _render_noise(k, count, ss).items()})
    return noise


@pytest.mark.parametrize("alpha", [False, True])
def test_frames_loss_fn_matches_jax(alpha):
    ss_j, ss_t, pj = _statics()
    batch = _batch(np.random.default_rng(2), alpha=alpha)
    key = jax.random.PRNGKey(5)
    fb = {k: batch[k] for k in ("rays_o", "rays_d", "images")}
    loss_j, aux_j = jstep.frames_loss_fn(pj, ss_j, {k: jnp.asarray(v) for k, v in fb.items()},
                                        key)
    k_bg, k_r = jax.random.split(key)
    noise = {"bg_frames": t(jax.random.uniform(k_bg, (48, 1))),
             "jitter_frames": _render_noise(k_r, 48, ss_t)["jitter"]}
    pt = params_from_jax(params_np(pj))
    loss_t, aux_t = tstep.frames_loss_fn(pt, ss_t, {k: t(v) for k, v in fb.items()}, noise)
    assert float(loss_t) > 0.01
    # f32 renders; JAX's FMA-moved grid weights (test_torch_hashgrid.py)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(n(aux_t["per_ray_loss"]), np.asarray(aux_j["per_ray_loss"]),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_mark_untrained_grid_matches_jax(bound):
    intr = jsyn.default_intrinsics(32, 32, fovy_deg=20.0)  # narrow: cells go unseen
    poses = np.stack([jsyn.circle_pose(s) for s in (0.0, 0.1, 0.3)]).astype(np.float32)
    occ_j = jocc.mark_untrained_grid(jocc.init_occupancy(bound), poses, intr, bound)
    occ_t = tocc.mark_untrained_grid(tocc.init_occupancy(bound), poses, intr, bound)
    gj, gt = np.asarray(occ_j.density_grid), n(occ_t.density_grid)
    assert gt.shape == gj.shape == (tocc.num_cascades(bound), tocc.GRID_SIZE ** 3)
    marked = gj == -1.0
    assert 0.01 < marked.mean() < 0.99
    # a cell on a frustum plane can fall either side by an ulp of the
    # camera-frame product: counted and bounded
    assert (marked != (gt == -1.0)).mean() < 1e-5
    assert set(np.unique(gt)) <= {0.0, -1.0}
    # cells already marked or trained keep their values
    occ2 = tocc.mark_untrained_grid(occ_t._replace(density_grid=occ_t.density_grid + 0.5),
                                    poses[:1], intr, bound)
    g2 = n(occ2.density_grid)
    assert ((g2 == -1.0) | (g2 == gt + 0.5)).all() and (g2 == -1.0).sum() >= (gt == -1.0).sum()


@pytest.mark.parametrize("upsample", [0, 8])
def test_train_step_with_frames_matches_jax(upsample):
    ss_j, ss_t, pj = _statics(upsample)
    batch = _batch(np.random.default_rng(3))
    key = jax.random.PRNGKey(11)
    noise = _jax_noise(key, ss_t, 64, 48)
    state_j, opt = jstate.init_train_state(pj, 0.005, 1000)
    (loss_j, aux_j), g_j = jax.value_and_grad(jstep.event_loss_fn, has_aux=True)(
        state_j.params, ss_j, {k: jnp.asarray(v) for k, v in batch.items()}, key, None)
    new_j = jstate.apply_updates(state_j, g_j, opt)
    state_t = tstate.TrainState(params_from_jax(params_np(pj)), 0.005, 1000)
    aux_t = tstep.train_step_events(state_t, {k: t(v) for k, v in batch.items()}, ss_t, None,
                                    noise=noise)
    assert state_t.step == 1 and float(aux_t["loss_frames"]) > 0.01
    for k in ("loss_evs", "loss_frames", "loss_opacity", "ws_mean"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(aux_t["loss"]), float(loss_j), rtol=1e-4)
    for k, gj in g_j.items():
        gj = np.asarray(gj)
        gt = n(state_t.params[k].grad)
        scale = np.abs(gj).max()
        assert scale > 0, k
        # f32 backward through the same samples.  The gradients reaching the
        # table through the density (hash_table, sigma_w0) sum terms that
        # cancel: the port's own f32 result differs from its float64 one by
        # up to 4.8e-3 of the scale there (measured), so those two are held
        # at 3e-2 of the scale per entry and 5e-3 in L2; the rest at 1e-3
        tol = 3e-2 if k in ("hash_table", "sigma_w0") else 1e-3
        np.testing.assert_allclose(gt, gj, rtol=0, atol=tol * scale, err_msg=k)
        assert np.linalg.norm(gt - gj) <= 5e-3 * np.linalg.norm(gj), k
        clear = np.abs(gj) > 2 * tol * scale
        np.testing.assert_allclose(n(state_t.params[k])[clear], np.asarray(new_j.params[k])[clear],
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("encoding", ["hashgrid", "blockgrid"])
def test_remat_modes_give_the_same_gradients(encoding, monkeypatch):
    """remat_fixed 0, 1 and 2 compute the same step; 1 re-runs the table
    gathers in the backward, 2 keeps the encodings and does not."""
    _, ss_t, pj = _statics(4, encoding)
    batch = {k: t(v) for k, v in _batch(np.random.default_rng(4)).items()}
    noise = _jax_noise(jax.random.PRNGKey(6), ss_t, 64, 48)
    gathers = []
    if encoding == "hashgrid":
        real = th.encode_from_address
        monkeypatch.setattr(th, "encode_from_address",
                            lambda *a: gathers.append(1) or real(*a))
    else:
        from enerf_torch.ops import blockgrid as tb
        real = tb._encode_chunk
        monkeypatch.setattr(tb, "_encode_chunk", lambda *a: gathers.append(1) or real(*a))
    grads, counts = {}, {}
    for mode in (0, 1, 2):
        gathers.clear()
        state = tstate.TrainState(params_from_jax(params_np(pj)), 0.005, 1000)
        aux = tstep.train_step_events(state, batch, ss_t._replace(remat_fixed=mode), None,
                                      noise=noise)
        grads[mode] = {k: p.grad.clone() for k, p in state.params.items()}
        counts[mode] = len(gathers)
        assert np.isfinite(float(aux["loss"]))
    # three renders, each encoding twice (num_steps, then the upsampled points)
    assert counts[0] == 6 and counts[1] == 12 and counts[2] == 6, counts
    for mode in (1, 2):
        for k, g0 in grads[0].items():
            torch.testing.assert_close(grads[mode][k], g0, rtol=1e-6, atol=0, msg=k)


def _cfg(tmp, *extra):
    return build_config([
        "--config", os.path.join(REPO, "configs", "synthetic_demo.txt"), "--event_only", "0",
        "--H", "24", "--W", "24", "--syn_frames", "12", "--num_levels", "2",
        "--batch_size_evs", "64", "--num_rays", "48", "--num_steps", "16", "--log_every", "1",
        "--val_idxs", "0", "--val_idxs", "5", "--outdir", str(tmp), *extra])


def test_synthetic_provider_with_frames_matches_jax(tmp_path):
    cfg = _cfg(tmp_path)
    train, val = tprov.make_providers(cfg, device="cpu")
    train_j, _ = jprov.make_providers(cfg)
    np.testing.assert_array_equal(n(train.frames), np.asarray(train_j.frames))
    np.testing.assert_array_equal(train.train_poses, train_j.train_poses)
    np.testing.assert_array_equal(n(train.frame_poses), np.asarray(train_j.frame_poses))
    assert (train.frame_H, train.frame_W, train.num_rays) == (24, 24, 48)
    assert len(val.val_views()) == 2
    batch = train.train_step_batch(torch.Generator().manual_seed(0))
    assert batch["rays_o"].shape == batch["rays_d"].shape == (48, 3)
    assert batch["images"].shape == (48, 1) and batch["rays_evs_o1"].shape == (64, 3)
    # with the frame and pixels handed in: JAX's rays and ground truth
    key = jax.random.PRNGKey(3)
    rj = jrays.get_rays_sampled(key, train_j.frame_poses[4], train_j.intrinsics, 24, 24, 48)
    got = train._frame_rays(None, fi=torch.tensor([4]), inds=t(rj["inds"]).long())
    np.testing.assert_allclose(n(got["rays_d"]), np.asarray(rj["rays_d"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(got["rays_o"]), np.asarray(rj["rays_o"]), atol=1e-6)
    np.testing.assert_array_equal(n(got["images"]),
                                  np.asarray(train_j.frames[4][rj["inds"]]))
    # event-only training serves no frames and has no frame poses to mark
    train1, _ = tprov.make_providers(_cfg(tmp_path, "--event_only", "1"), device="cpu")
    assert train1.frames is None and not hasattr(train1, "train_poses")
    assert "rays_o" not in train1.train_step_batch(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_hashgrid_checkpoint_round_trip(tmp_path, direction):
    """A hash-grid run's state (params named hash_table, no occupancy) in
    the JAX file layout, read by the other package."""
    sj = jfield.FieldStatic(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10)
    pj = jfield.init_field_params(jax.random.PRNGKey(2), sj)
    st = tfield.FieldStatic(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10)
    assert st.encoding == sj.encoding == "hashgrid"
    tmpl_t = tstate.TrainState(tfield.init_field_params(st, 7), 5e-3, 100)
    assert {k: tuple(v.shape) for k, v in tmpl_t.params.items()} == {
        k: tuple(v.shape) for k, v in pj.items()}
    state_j, opt = jstate.init_train_state(pj, 5e-3, 100)
    rng = np.random.default_rng(0)
    if direction == "jax_to_port":
        for _ in range(2):
            state_j = jstate.apply_updates(state_j, {
                k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                for k, v in pj.items()}, opt)
        path = jckpt.save_checkpoint(str(tmp_path / "j_ep0001"), state_j, None, 1)
        state_t, occ, meta = tckpt.load_checkpoint(path, tmpl_t, None)
        assert occ is None and state_t.step == 2 and meta["epoch"] == 1
        for k, p in state_t.params.items():
            np.testing.assert_array_equal(n(p), np.asarray(state_j.params[k]), err_msg=k)
            np.testing.assert_array_equal(n(state_t.opt.state[p]["exp_avg"]),
                                          np.asarray(state_j.opt_state[0].mu[k]))
    else:
        state_t = tstate.TrainState(params_from_jax(params_np(pj)), 5e-3, 100)
        for _ in range(3):
            for p in state_t.params.values():
                p.grad = t(rng.normal(size=p.shape).astype(np.float32))
            state_t.apply_updates()
        path = tckpt.save_checkpoint(str(tmp_path / "t_ep0002"), state_t, None, 2)
        loaded, occ, meta = jckpt.load_checkpoint(path, state_j, None)
        assert occ is None and int(loaded.step) == 3 and meta["epoch"] == 2
        for k, p in state_t.params.items():
            np.testing.assert_array_equal(np.asarray(loaded.params[k]), n(p), err_msg=k)
            np.testing.assert_array_equal(np.asarray(loaded.ema_params[k]),
                                          n(state_t.ema_params[k]))


def test_trainer_march_warmup_marks_cells_then_marches(tmp_path):
    """--ff -O --event_only 0 --march_warmup 2: the frame poses mark the
    untrained cells, the warm steps render fixed-step (no march), the next
    step marches; loss_frames is logged at every step."""
    cfg = _cfg(tmp_path, "--ff", "-O", "--march_warmup", "2", "--march_samples", "16")
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    assert tr.static.encoding == "blockgrid" and tr.ss.use_march
    train, _ = tprov.make_providers(cfg, device="cpu")
    train.train_poses = train.train_poses[:1]  # one camera: many cells unseen
    train.steps_per_epoch = 2
    tmarch.march_rays.host_syncs = 0
    tr.train(train, max_epoch=1)
    assert tmarch.march_rays.host_syncs == 0  # both steps warm: no march
    marked = float((tr.occupancy.density_grid == -1.0).float().mean())
    assert 0.0 < marked < 1.0
    tr.train(train, max_epoch=2)  # steps 2-3: the march
    assert tmarch.march_rays.host_syncs > 0
    lf = [aux["loss_frames"] for _, aux in tr.history]
    assert len(lf) == 4 and np.isfinite(lf).all() and min(lf) > 0
    assert tr.occupancy.iter_density == 1  # the update before step 0


def test_trainer_default_path_cpu_run(tmp_path):
    """The published configs' path: hash grid, no occupancy grid, fixed-step
    training with the frame term, evaluation through the staged renderer."""
    cfg = _cfg(tmp_path, "--eval_interval", "1")
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    assert tr.static.encoding == "hashgrid" and tr.occupancy is None
    assert not tr.ss.use_march and tr.static.compute_dtype == torch.bfloat16
    train, val = tprov.make_providers(cfg, device="cpu")
    train.steps_per_epoch = 3
    tr.train(train, val, max_epoch=1)
    assert tr.state.step == 3
    losses = [aux["loss_frames"] for _, aux in tr.history]
    assert len(losses) == 3 and np.isfinite(losses).all() and min(losses) > 0
    ev = tr.last_eval
    assert np.isfinite(ev["psnr"]) and np.isfinite(ev["ssim"])
    assert "psnr_corrected" not in ev  # frames fix the scale: no affine correction
    v = val.val_views()[0]
    img, depth = tr.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
    assert img.shape == (24, 24, 1) and 0.0 <= img.min() and img.max() <= 1.0 + 1e-6
    corr = tr.affine_corrected([img], [v["gt"]])
    assert np.isfinite(corr["psnr_corrected"])
    resumed = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"), use_checkpoint="latest")
    assert resumed.occupancy is None and resumed.state.step == 3
    for k, p in tr.state.params.items():
        assert torch.equal(resumed.state.params[k], p), k
