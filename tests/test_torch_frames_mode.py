"""Parity of the port's frames mode (events=0) with enerf_tpu: error-map
pixel sampling, FramesProvider batches and the error map's update, one
train_step_frames on the fixed-step hash grid and on --ff -O (the march,
the block grid and the fused head), the synthetic frames providers, the
trainer with the error map, the CLI on a tiny esim config, the frame
selection and check_supported."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t, unit_dirs
from torch_march_parity import unpack_bitfield

from enerf_tpu.data import provider as jprov, rays as jrays, synthetic as jsyn
from enerf_tpu.models import field as jfield
from enerf_tpu.ops import hashgrid as jh
from enerf_tpu.render import march as jmarch, occupancy as jocc
from enerf_tpu.train import state as jstate, step as jstep
from enerf_torch import __main__ as tmain
from enerf_torch.config import build_config, check_supported
from enerf_torch.convert import params_from_jax
from enerf_torch.data import provider as tprov, rays as trays
from enerf_torch.models import field as tfield
from enerf_torch.ops import fused_mlp, hashgrid as th
from enerf_torch.render import march as tmarch
from enerf_torch.render.occupancy import pack_bitfield
from enerf_torch.train import state as tstate, step as tstep
from enerf_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _errmap_draws(key, n_rays):
    """The jitters get_rays_sampled draws from its key with an error map."""
    _, k2, k3 = jax.random.split(key, 3)
    return torch.stack([t(jax.random.uniform(k2, (n_rays,))),
                        t(jax.random.uniform(k3, (n_rays,)))])


@pytest.mark.parametrize("H,W", [(32, 32), (48, 40)])
def test_error_map_sampling_matches_jax(H, W):
    intr = jsyn.default_intrinsics(H, W)
    pose = jsyn.circle_pose(0.3).astype(np.float32)
    emap = np.random.default_rng(H).uniform(0, 1, 128 * 128).astype(np.float32)
    key = jax.random.PRNGKey(7)
    rj = jrays.get_rays_sampled(key, jnp.asarray(pose), intr, H, W, 300,
                                error_map=jnp.asarray(emap))
    rt = trays.get_rays_sampled(t(pose), intr, H, W, 300, error_map=t(emap),
                                inds_coarse=t(rj["inds_coarse"]).long(),
                                jitter=_errmap_draws(key, 300))
    np.testing.assert_array_equal(n(rt["inds"]), np.asarray(rj["inds"]))
    np.testing.assert_array_equal(n(rt["inds_coarse"]), np.asarray(rj["inds_coarse"]))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(n(rt[k]), np.asarray(rj[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    # drawn from a generator: only the weighted cells, each pixel inside its cell
    sparse = np.zeros(128 * 128, np.float32)
    sparse[[5, 128 * 60 + 77, 128 * 127 + 127]] = (1.0, 2.0, 3.0)
    drawn = trays.get_rays_sampled(t(pose), intr, H, W, 500, torch.Generator().manual_seed(0),
                                   error_map=t(sparse))
    cells = n(drawn["inds_coarse"])
    assert set(np.unique(cells)) <= {5, 128 * 60 + 77, 128 * 127 + 127}
    for pix, cell, size in ((n(drawn["inds"]) // W, cells // 128, H),
                            (n(drawn["inds"]) % W, cells % 128, W)):
        s = size / 128.0
        assert (np.floor(cell * s) <= pix).all()
        assert (pix <= np.minimum(np.floor((cell + 1) * s), size - 1)).all()


def _frames_data(F=6, H=24, W=20, C=1):
    rng = np.random.default_rng(F)
    images = rng.uniform(0, 1, (F, H, W, C)).astype(np.float32)
    poses = np.stack([jsyn.circle_pose(s) for s in np.linspace(0, 0.5, F)])
    return images, poses, jsyn.default_intrinsics(H, W)


@pytest.mark.parametrize("error_map", [False, True])
def test_frames_provider_batches_match_jax(error_map):
    images, poses, intr = _frames_data()
    pj = jprov.FramesProvider(images, poses, intr, num_rays=200, error_map=error_map)
    pt = tprov.FramesProvider(images, poses, intr, num_rays=200, error_map=error_map)
    assert pt.steps_per_epoch == pj.steps_per_epoch and pt.stereo_views is None
    np.testing.assert_array_equal(pt.train_poses, pj.train_poses)
    if error_map:  # a non-uniform map in both, so the weighted draw matters
        emap = np.random.default_rng(2).uniform(0.1, 1, (6, 128 * 128)).astype(np.float32)
        pj.error_map, pt.error_map = jnp.asarray(emap), t(emap)
    for step in range(3):
        key = jax.random.PRNGKey(step)
        bj, fi, inds_coarse = jprov._frames_sample_jit(
            key, pj.poses, pj.images, pj.error_map, intr, num_rays=200, H=24, W=20,
            use_emap=error_map)
        pj._last_fi, pj._last_inds_coarse = fi, inds_coarse
        k1, k2 = jax.random.split(key)
        draws = {"fi": torch.tensor([int(fi)])}
        if error_map:
            draws.update(inds_coarse=t(inds_coarse).long(), jitter=_errmap_draws(k2, 200))
        else:
            draws["inds"] = t(jax.random.randint(k2, (200,), 0, 24 * 20)).long()
        bt = pt.train_step_batch(None, **draws)
        for k in ("rays_o", "rays_d", "images"):
            np.testing.assert_allclose(n(bt[k]), np.asarray(bj[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        if not error_map:
            continue
        loss = np.random.default_rng(step).uniform(0, 1, 200).astype(np.float32)
        old = n(pt.error_map).copy()
        pj.update_error_map(jnp.asarray(loss))
        pt.update_error_map(t(loss))
        got, ref = n(pt.error_map), np.asarray(pj.error_map)
        cells = n(pt._last_inds_coarse)
        uniq, counts = np.unique(cells, return_counts=True)
        once = np.isin(cells, uniq[counts == 1])
        fi = int(fi)
        assert once.sum() > 150 and (got != old).sum() >= len(uniq) - 1
        np.testing.assert_allclose(got[fi, cells[once]], ref[fi, cells[once]], rtol=1e-6)
        np.testing.assert_allclose(got[fi, cells[once]], 0.1 * old[fi, cells[once]]
                                   + 0.9 * loss[once], rtol=1e-6)
        # a cell drawn twice keeps one of its rays' updates (the order is unspecified)
        for c in uniq[counts > 1]:
            cand = 0.1 * old[fi, c] + 0.9 * loss[cells == c]
            assert np.isclose(got[fi, c], cand, rtol=1e-6).any()
        untouched = np.ones_like(got, bool)
        untouched[fi, cells] = False
        np.testing.assert_array_equal(got[untouched], old[untouched])
        pt.error_map = t(ref)  # both continue from JAX's map


def _hashgrid_setup():
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    # finest level 64 cells (test_torch_frames.py: JAX's FMA-moved weights)
    grid = dict(num_levels=4, level_dim=2, log2_hashmap_size=13, desired_resolution=64)
    sj.grid_meta, st.grid_meta = jh.HashGridMeta(**grid), th.HashGridMeta(**grid)
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    pj["hash_table"] = jnp.asarray(np.random.default_rng(1).uniform(
        -0.5, 0.5, pj["hash_table"].shape).astype(np.float32))
    return sj, st, pj, {}


def _march_setup():
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
              encoding="blockgrid", use_fused_head=True, density_bias=3.0)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    pj["hash_table"] = jnp.asarray(np.random.default_rng(1).uniform(
        -1e-2, 1e-2, pj["hash_table"].shape).astype(np.float32))
    march = dict(use_march=True, march_samples=32, max_steps=1024, dt_gamma=0.0,
                 compact_frac=0.5)
    return sj, st, pj, march


def _frames_batch(rng, N=64):
    o = np.repeat(unit_dirs(rng, 1) * 2.5, N, 0)
    d = rng.uniform(-0.6, 0.6, (N, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:3] = -d[:3]  # rays that miss the box
    return {"rays_o": o.astype(np.float32), "rays_d": d.astype(np.float32),
            "images": rng.uniform(0, 1, (N, 1)).astype(np.float32)}


@pytest.mark.parametrize("renderer", ["fixed", "fixed_upsample", "march"])
def test_train_step_frames_matches_jax(renderer, monkeypatch):
    sj, st, pj, march = _march_setup() if renderer == "march" else _hashgrid_setup()
    upsample = 8 if renderer == "fixed_upsample" else 0
    common = dict(min_near=0.2, density_scale=1.0, C_thres=0.2, event_only=False,
                  use_luma=False, linlog=True, out_dim_color=1, num_steps=32,
                  upsample_steps=upsample, weight_loss_rgb=1.0, **march)
    ss_j = jstep.StepStatics(field_static=sj, negative_event_sampling=False, w_no_ev=1.0,
                             **common)
    ss_t = tstep.StepStatics(field_static=st, **common)
    batch = _frames_batch(np.random.default_rng(3))
    N = batch["rays_o"].shape[0]
    key = jax.random.PRNGKey(11)
    k_bg, k_r = jax.random.split(key)  # the draws frames_loss_fn makes
    noise = {"bg_frames": t(jax.random.uniform(k_bg, (N, 1)))}
    occ = None
    if renderer == "march":
        occ = np.asarray(jocc.ball_bitfield(radius=0.6))
        noise["jitter_frames"] = t(jax.random.uniform(k_r, (N,)))

        # both packages composite JAX's march samples (ROADMAP §3: JAX's
        # FMAs can move a sample by an ulp and flip a block-grid floor())
        def jax_march(rays_o, rays_d, occ_bitfield, nears, fars, *, jitter, generator=None,
                      **kw):
            assert jitter is noise["jitter_frames"]
            out = jmarch.march_rays(*(jnp.asarray(n(a)) for a in
                                      (rays_o, rays_d, unpack_bitfield(occ_bitfield), nears,
                                       fars)), k_r, **kw)
            return tuple(t(a) for a in out)

        monkeypatch.setattr(tmarch, "march_rays", jax_march)
    else:
        k_pert, k_pdf = jax.random.split(k_r)
        noise["jitter_frames"] = t(jax.random.uniform(k_pert, (N, 32)))
        if upsample:
            noise["u_frames"] = t(jax.random.uniform(k_pdf, (N, upsample)))
    # JAX: train_step_frames' body, unjitted, to read the gradients too
    state_j, opt = jstate.init_train_state(pj, 0.005, 1000)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    occ_j = None if occ is None else jnp.asarray(occ)
    (loss_j, aux_j), g_j = jax.value_and_grad(jstep.frames_loss_fn, has_aux=True)(
        state_j.params, ss_j, bj, key, occ_j)
    new_j = jstate.apply_updates(state_j, g_j, opt)

    state_t = tstate.TrainState(params_from_jax(params_np(pj)), 0.005, 1000)
    fused_mlp.fused_field_head.launches = 0
    aux_t = tstep.train_step_frames(state_t, {k: t(v) for k, v in batch.items()}, ss_t,
                                    None if occ is None else pack_bitfield(t(occ)), noise=noise)
    assert fused_mlp.fused_field_head.launches == 0  # CPU tensors: the plain head
    assert state_t.step == 1 and set(aux_t) == {"loss", "loss_frames", "per_ray_loss"}
    assert float(aux_t["loss"]) > 0.01
    np.testing.assert_allclose(float(aux_t["loss"]), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(float(aux_t["loss_frames"]), float(aux_j["loss_frames"]),
                               rtol=1e-4)
    np.testing.assert_allclose(n(aux_t["per_ray_loss"]), np.asarray(aux_j["per_ray_loss"]),
                               rtol=1e-3, atol=1e-6)
    for k, gj in g_j.items():
        gj = np.asarray(gj)
        gt = n(state_t.params[k].grad)
        scale = np.abs(gj).max()
        assert scale > 0, k
        # test_torch_frames.py's tolerances: the density path's gradients sum
        # terms that cancel (3e-2 of the scale per entry, 5e-3 in L2), the
        # rest 1e-3 of the scale
        tol = 3e-2 if k in ("hash_table", "sigma_w0") else 1e-3
        np.testing.assert_allclose(gt, gj, rtol=0, atol=tol * scale, err_msg=k)
        assert np.linalg.norm(gt - gj) <= 5e-3 * np.linalg.norm(gj), k
        clear = np.abs(gj) > 2 * tol * scale
        np.testing.assert_allclose(n(state_t.params[k])[clear], np.asarray(new_j.params[k])[clear],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(n(state_t.ema_params[k])[clear],
                                   np.asarray(new_j.ema_params[k])[clear], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def _syn_cfg(tmp, *extra):
    return build_config([
        "--config", os.path.join(REPO, "configs", "synthetic_demo.txt"), "--events", "0",
        "--event_only", "0", "--H", "24", "--W", "24", "--syn_frames", "10", "--num_levels", "2",
        "--num_rays", "48", "--num_steps", "16", "--march_samples", "16", "--log_every", "1",
        "--val_idxs", "5", "--outdir", str(tmp), *extra])


@pytest.mark.parametrize("error_map", [False, True])
def test_synthetic_frames_providers_match_jax(tmp_path, error_map):
    cfg = _syn_cfg(tmp_path, *(["--error_map"] if error_map else []))
    train, val = tprov.make_providers(cfg, device="cpu")
    train_j, val_j = jprov.make_providers(cfg)
    assert isinstance(train, tprov.FramesProvider)
    np.testing.assert_array_equal(n(train.images), np.asarray(train_j.images))
    np.testing.assert_array_equal(train.train_poses, train_j.train_poses)
    assert train.num_rays == train_j.num_rays == 48
    if error_map:
        np.testing.assert_array_equal(n(train.error_map), np.asarray(train_j.error_map))
    else:
        assert train.error_map is None and train_j.error_map is None
    for a, b in zip(val.val_views(), val_j.val_views(), strict=True):
        np.testing.assert_array_equal(a["pose"], b["pose"])
        np.testing.assert_array_equal(a["gt"], b["gt"])


def test_trainer_frames_mode_on_the_march_with_the_error_map(tmp_path):
    """--ff -O --events 0 --error_map: the frame poses mark the untrained
    cells, each step is train_step_frames through the march and the fused
    head, the error map moves after every step, and the frames-mode
    evaluation reports plain PSNR."""
    cfg = _syn_cfg(tmp_path, "--ff", "-O", "--error_map", "--eval_interval", "1")
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    assert tr.ss.use_march and tr.static.use_fused_head
    train, val = tprov.make_providers(cfg, device="cpu")
    train.train_poses = train.train_poses[:1]  # one camera leaves cells unseen
    train.steps_per_epoch = 2
    before = train.error_map.clone()
    tmarch.march_rays.host_syncs = 0
    tr.train(train, val, max_epoch=1)
    assert tr.state.step == 2 and tmarch.march_rays.host_syncs > 0
    lf = [aux["loss_frames"] for _, aux in tr.history]
    assert len(lf) == 2 and np.isfinite(lf).all() and min(lf) > 0
    assert all(set(aux) == {"loss", "loss_frames"} for _, aux in tr.history)
    assert (train.error_map != before).sum() > 48
    assert 0.0 < float((tr.occupancy.density_grid == -1.0).float().mean()) < 1.0
    assert np.isfinite(tr.last_eval["psnr"]) and "psnr_corrected" not in tr.last_eval


def test_cli_runs_a_tiny_esim_config(tmp_path, monkeypatch):
    """python -m enerf_torch --config spiral1_nerf.txt --datadir <esim dir>
    --device cpu: 2 steps (the epoch cut to 2), a checkpoint, the
    evaluation, the best checkpoint and the test renders."""
    data = jsyn.simulate_events(H=32, W=32, n_frames=8, C=0.2,
                                cache_dir=os.environ.get("ENERF_SYN_CACHE"))
    d = jprov.save_esim_dataset(data, str(tmp_path / "spiral1"), scale=0.3)
    real = tprov.make_providers

    def two_steps(*args, **kw):
        train, val = real(*args, **kw)
        train.steps_per_epoch = 2
        return train, val

    monkeypatch.setattr(tprov, "make_providers", two_steps)
    out = tmp_path / "out"
    argv = ["--config", os.path.join(REPO, "configs", "spiral1", "spiral1_nerf.txt"),
            "--datadir", d, "--outdir", str(out), "--num_rays", "64", "--num_steps", "16",
            "--num_levels", "2", "--iters", "2", "--val_idxs", "1", "--eval_interval", "1",
            "--log_every", "1", "--max_ray_batch", "512"]
    if not torch.cuda.is_available():  # without --device the CLI wants the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tmain.main(argv)
    tmain.main(argv + ["--device", "cpu"])
    ws = out / "MONTH-DAY" / "esim" / "spiral1_nerf"
    log = (ws / "log.txt").read_text()
    assert "step 2 loss=" in log and "[eval] epoch 1: psnr=" in log
    assert (ws / "checkpoints" / "spiral1_nerf_ep0001.npz").exists()
    assert (ws / "checkpoints" / "spiral1_nerf_best.npz").exists()
    assert (ws / "transform_train.json").exists()
    assert sorted(os.listdir(ws / "results")) == ["0000.png", "0000_depth.png", "0000_raw.npy"]


def test_get_select_frames():
    cfg = build_config(["--train_idxs", "0", "--train_idxs", "2", "--train_idxs", "4",
                        "--val_idxs", "1", "--val_idxs", "3", "--exclude_idxs", "2",
                        "--exclude_idxs", "3"])
    sf = tmain.get_select_frames(cfg)
    assert sf == {"train_idxs": [0, 4], "val_idxs": [1], "test_idxs": [0],
                  "exclude_idxs": [2, 3]}
    assert tmain.get_select_frames(build_config([]))["train_idxs"] is None
    for bad in (["--train_idxs", "3", "--train_idxs", "1"],
                ["--val_idxs", "1", "--val_idxs", "1"]):
        with pytest.raises(ValueError):
            tmain.get_select_frames(build_config(bad))


def test_check_supported_takes_frames_esim_and_the_error_map():
    spiral = os.path.join(REPO, "configs", "spiral1", "spiral1_nerf.txt")
    for extra in ([], ["--error_map"], ["--events", "1", "--images_corrupted", "1"],
                  ["--e2vid", "1"], ["--mode", "tumvie"], ["--mode", "eds"]):
        check_supported(build_config(["--config", spiral, *extra]))
    # the CLIP step is ported: rand_pose is accepted (the trainer asks for
    # --clip_text, test_torch_clip.py)
    for extra in (["--rand_pose", "0"], ["--rand_pose", "4", "--clip_text", "a carpet"]):
        cfg = build_config(["--config", spiral, *extra])
        assert check_supported(cfg) is cfg
