"""Parity of the port's evaluation (metrics, the affine-corrected tail of
Trainer.evaluate, an end-to-end evaluate) and checkpoints with enerf_tpu,
on the same images, weights and states."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import carry_lpips_from_jax, n, params_np, t

from enerf_tpu import config as jconfig
from enerf_tpu.data import provider as jprov, synthetic as jsyn
from enerf_tpu.models import field as jfield
from enerf_tpu.render import occupancy as jocc
from enerf_tpu.train import checkpoints as jckpt, metrics as jmetrics, state as jstate
from enerf_tpu.train import trainer as jtrainer
from enerf_torch import config as tconfig
from enerf_torch.convert import occupancy_from_jax, params_from_jax
from enerf_torch.data import provider as tprov
from enerf_torch.render import occupancy as tocc
from enerf_torch.train import checkpoints as tckpt, metrics as tmetrics, state as tstate
from enerf_torch.train import trainer as ttrainer

METRICS = ("psnr", "ssim", "affine_a", "affine_b", "psnr_corrected", "ssim_corrected")


# ------------------------------------------------------------------ metrics

def test_metrics_match_jax():
    """The same float64 numpy arithmetic: rel 1e-9."""
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (a[..., 0], b[..., 0])):
        np.testing.assert_allclose(tmetrics.psnr(x, y), jmetrics.psnr(x, y), rtol=1e-9)
        np.testing.assert_allclose(tmetrics.ssim(x, y), jmetrics.ssim(x, y), rtol=1e-9)
    np.testing.assert_allclose(tmetrics.psnr(a * 255, b * 255, max_val=255.0),
                               jmetrics.psnr(a * 255, b * 255, max_val=255.0), rtol=1e-9)
    np.testing.assert_allclose(tmetrics.ssim(a[..., 0] * 255, b[..., 0] * 255, data_range=255.0),
                               jmetrics.ssim(a[..., 0] * 255, b[..., 0] * 255, data_range=255.0),
                               rtol=1e-9)
    assert tmetrics.psnr(a, a) == np.inf
    la, lb = np.log(255 * a + 1e-3), np.log(255 * b + 1e-3) * 0.8 + 0.3
    np.testing.assert_allclose(tmetrics.solve_normal_equations(la, lb),
                               jmetrics.solve_normal_equations(la, lb), rtol=1e-9)
    # a constant prediction makes the normal equations singular: nan fallback
    const = np.ones_like(la)
    assert tmetrics.solve_normal_equations(const, lb) == jmetrics.solve_normal_equations(const, lb)
    mt, mj = tmetrics.PSNRMeter(), jmetrics.PSNRMeter()
    for m in (mt, mj):
        m.update(a, b)
        m.update(a[..., 0], b[..., 0] * 0.9)
    assert mt.report() == mj.report()


# --------------------------------------------------------------- evaluation

def _argv(tmp_path):
    # f32 compute, unfused MLP on the block grid, the march: the same math in
    # both packages (bf16 rounds at other places in the two frameworks)
    return ["--mode", "synthetic", "--H", "32", "--W", "32", "--events", "1",
            "--event_only", "1", "--out_dim_color", "1", "--C_thres", "0.2", "--bound", "1",
            "--cuda_ray", "--encoding", "blockgrid", "--num_levels", "2",
            "--outdir", str(tmp_path)]


def _trainers(tmp_path):
    argv = _argv(tmp_path)
    jt = jtrainer.Trainer(jconfig.build_config(argv), workspace=str(tmp_path / "jax"),
                          use_checkpoint="scratch")
    tt = ttrainer.Trainer(tconfig.build_config(argv), device="cpu",
                          workspace=str(tmp_path / "torch"))
    return jt, tt


def _views(count=2):
    d = jsyn.simulate_events(H=32, W=32, n_frames=8, C=0.2,
                             cache_dir=os.environ.get("ENERF_SYN_CACHE"))
    idx = np.linspace(0, 7, count).astype(int)
    return d["frames"][idx], d["poses"][idx], d["intrinsics"]


def _fixed_render(preds):
    """render_view stand-in: view i is told apart by pose[3, 3] = 1 + i."""
    def render_view(pose, intrinsics, H, W):
        i = int(round(float(np.asarray(pose)[3, 3]))) - 1
        return preds[i], np.full((H, W), 0.5, np.float32)
    return render_view


def test_evaluate_metric_tail_matches_jax(tmp_path, monkeypatch):
    """Both evaluations on the same fixed renders: the metric tail (PSNR,
    SSIM, the affine fit over all val images, the corrected metrics) is
    float64 numpy on the same float32 images: rel 1e-9."""
    rng = np.random.default_rng(1)
    gts, poses, intr = _views()
    poses = poses.copy()
    poses[:, 3, 3] = 1 + np.arange(len(poses))
    preds = np.clip(0.7 * gts + 0.2 + rng.normal(scale=0.05, size=gts.shape), 0, 1
                    ).astype(np.float32)
    jt, tt = _trainers(tmp_path)
    carry_lpips_from_jax(monkeypatch)  # both packages' LPIPS on JAX's weights
    jt.render_view = _fixed_render(preds)
    tt.render_view = _fixed_render(preds)
    rj = jt.evaluate(jprov.FramesProvider(gts, poses, intr), save=False)
    rt = tt.evaluate(tprov.FramesProvider(gts, poses, intr), save=True)
    for k in METRICS:
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-9, err_msg=k)
    # LPIPS: f32 convolutions summed in other orders (test_torch_lpips.py): rel 1e-4
    for k in ("lpips_alex_rand", "lpips_vgg_rand"):
        assert rj[k] > 0
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, err_msg=k)
    assert tt.lpips_seconds is not None
    # the PNGs decode to the 8-bit images
    cv2 = pytest.importorskip("cv2")
    vdir = os.path.join(tt.workspace, "validation")
    for j in range(len(preds)):
        got = cv2.imread(os.path.join(vdir, "prediction", f"ep0000_{j:04d}.png"),
                         cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, (np.clip(preds[j], 0, 1) * 255).astype(np.uint8)[..., 0])
        got = cv2.imread(os.path.join(vdir, "gt", f"{j:04d}.png"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, (np.clip(gts[j], 0, 1) * 255).astype(np.uint8)[..., 0])


def test_png_writer_rgb_and_gray(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from enerf_torch.utils.png import write_png
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    write_png(str(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "rgb.png"))[..., ::-1], rgb)
    write_png(str(tmp_path / "g.png"), rgb[..., :1])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED),
                                  rgb[..., 0])
    with pytest.raises(TypeError):
        write_png(str(tmp_path / "f.png"), rgb.astype(np.float32))


def test_evaluate_end_to_end_matches_jax(tmp_path, monkeypatch):
    """Both trainers render the same val views with the same converted
    weights and bitfield through their inference renderers."""
    gts, poses, intr = _views()
    jt, tt = _trainers(tmp_path)
    pj = jfield.init_field_params(jax.random.PRNGKey(3), jt.static)
    pj["hash_table"] = jnp.asarray(np.random.default_rng(3).uniform(
        -1.0, 1.0, pj["hash_table"].shape).astype(np.float32))
    bitfield = np.asarray(jocc.ball_bitfield(radius=0.6))
    jt.state = jt.state._replace(ema_params=pj)
    jt.occupancy = jt.occupancy._replace(occ_bitfield=jnp.asarray(bitfield))
    tt.state.ema_params = params_from_jax(params_np(pj))
    tt.occupancy = occupancy_from_jax(np.zeros((1, bitfield.shape[1]), np.float32), bitfield,
                                      0.0, 0)
    carry_lpips_from_jax(monkeypatch)
    renders = {}
    for name, tr in (("jax", jt), ("torch", tt)):
        inner = tr.render_view

        def keep(*args, _inner=inner, _name=name):
            out = _inner(*args)
            renders.setdefault(_name, []).append(out[0])
            return out
        tr.render_view = keep
    rj = jt.evaluate(jprov.FramesProvider(gts, poses, intr), save=False)
    rt = tt.evaluate(tprov.FramesProvider(gts, poses, intr), save=False)
    assert np.ptp(renders["torch"][0]) > 0.05  # the field is visible
    # Inside JAX's jitted march the sample positions may be FMA-contracted,
    # moving a sample by an ulp and flipping a block-grid floor(): the
    # images are held at 1e-4 absolute, as tests/test_torch_render.py holds
    # render_rays_infer.  Through the metrics that is at most ~1e-3 dB of
    # PSNR at these errors (0.1-0.3 RMS) and less for the rest: 1e-3
    # absolute on PSNR, 1e-4 relative on the others.  (Measured with these
    # inputs: images 3.6e-6, corrected PSNR 5.5e-6 dB, the rest 3e-7 rel.)
    for a, b in zip(renders["torch"], renders["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for k in METRICS:
        if k.startswith("psnr"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # LPIPS of renders 1e-4 apart, on JAX's weights: rel 1e-3
    for k in ("lpips_alex_rand", "lpips_vgg_rand"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-3, err_msg=k)


# -------------------------------------------------------------- checkpoints

def _jax_state(seed=0, updates=2):
    """A JAX TrainState after `updates` Adam steps on random gradients."""
    static = jfield.FieldStatic(bound=1.0, out_dim_color=1, num_levels=2,
                                log2_hashmap_size=10, encoding="blockgrid")
    params = jfield.init_field_params(jax.random.PRNGKey(seed), static)
    state, opt = jstate.init_train_state(params, 5e-3, 100)
    rng = np.random.default_rng(seed)
    for _ in range(updates):
        grads = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                 for k, v in params.items()}
        state = jstate.apply_updates(state, grads, opt)
    return state, opt, static


def _torch_state(params_np_, updates=0, seed=0, lr=5e-3, iters=100):
    state = tstate.TrainState(params_from_jax(params_np_), lr, iters)
    rng = np.random.default_rng(seed)
    for _ in range(updates):
        for k, p in state.params.items():
            p.grad = t(rng.normal(size=p.shape).astype(np.float32))
        state.apply_updates()
    return state


def _occ(seed):
    rng = np.random.default_rng(seed)
    grid = rng.uniform(0, 0.02, (1, jocc.GRID_SIZE ** 3)).astype(np.float32)
    return grid, grid > 0.01, np.float32(grid.mean()), 7


def test_checkpoint_jax_writes_port_reads(tmp_path):
    state_j, opt, _ = _jax_state()
    grid, bits, mean, it = _occ(1)
    occ_j = jocc.OccupancyState(jnp.asarray(grid), jnp.asarray(bits), jnp.asarray(mean),
                                jnp.asarray(it, jnp.int32))
    path = jckpt.save_checkpoint(str(tmp_path / "j_ep0003"), state_j, occ_j, 3, {"loss": [1.5]})
    tmpl = _torch_state({k: np.zeros_like(v) for k, v in params_np(state_j.params).items()})
    state_t, occ_t, meta = tckpt.load_checkpoint(path, tmpl, tocc.init_occupancy(1.0))
    assert meta == {"epoch": 3, "global_step": 2, "stats": {"loss": [1.5]}}
    assert state_t.step == 2 and int(state_t.count) == 2
    mu, nu = state_j.opt_state[0].mu, state_j.opt_state[0].nu
    for k, p in state_t.params.items():
        np.testing.assert_array_equal(n(p), np.asarray(state_j.params[k]), err_msg=k)
        np.testing.assert_array_equal(n(state_t.ema_params[k]), np.asarray(state_j.ema_params[k]))
        np.testing.assert_array_equal(n(state_t.exp_avg[k]), np.asarray(mu[k]))
        np.testing.assert_array_equal(n(state_t.exp_avg_sq[k]), np.asarray(nu[k]))
    for f, v in zip(tckpt.OCC_FIELDS, (grid, bits, mean, it)):
        np.testing.assert_array_equal(np.asarray(n(getattr(occ_t, f)) if f != "iter_density"
                                                 else occ_t.iter_density), v, err_msg=f)
    # the restored optimizer continues like JAX's: one more update on the
    # same gradient (Adam's bias correction reads the restored count)
    assert float(state_t.lr()) == pytest.approx(5e-3 * 0.1 ** (2 / 100), rel=1e-12)
    rng = np.random.default_rng(9)
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in state_j.params.items()}
    new_j = jstate.apply_updates(state_j, {k: jnp.asarray(v) for k, v in grads.items()}, opt)
    for k, p in state_t.params.items():
        p.grad = t(grads[k])
    state_t.apply_updates()
    for k in grads:
        # one f32 Adam update, the same math in another order
        np.testing.assert_allclose(n(state_t.params[k]), np.asarray(new_j.params[k]),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_checkpoint_port_writes_jax_reads(tmp_path):
    state_j0, _, _ = _jax_state(updates=0)
    state_t = _torch_state(params_np(state_j0.params), updates=3, seed=4)
    grid, bits, mean, it = _occ(2)
    occ_t = occupancy_from_jax(grid, bits, mean, it)
    path = tckpt.save_checkpoint(str(tmp_path / "t_ep0002"), state_t, occ_t, 2, {"psnr": [9.0]})
    occ_tmpl = jocc.init_occupancy(1.0)
    state_j, occ_j, meta = jckpt.load_checkpoint(path, state_j0, occ_tmpl)
    assert meta["epoch"] == 2 and meta["global_step"] == 3 and meta["stats"] == {"psnr": [9.0]}
    assert int(state_j.step) == 3
    assert int(state_j.opt_state[0].count) == 3 and int(state_j.opt_state[1].count) == 3
    for k, p in state_t.params.items():
        np.testing.assert_array_equal(np.asarray(state_j.params[k]), n(p), err_msg=k)
        np.testing.assert_array_equal(np.asarray(state_j.ema_params[k]), n(state_t.ema_params[k]))
        np.testing.assert_array_equal(np.asarray(state_j.opt_state[0].mu[k]),
                                      n(state_t.exp_avg[k]))
        np.testing.assert_array_equal(np.asarray(state_j.opt_state[0].nu[k]),
                                      n(state_t.exp_avg_sq[k]))
    np.testing.assert_array_equal(np.asarray(occ_j.density_grid), grid)
    np.testing.assert_array_equal(np.asarray(occ_j.occ_bitfield), bits)
    assert float(occ_j.mean_density) == float(mean) and int(occ_j.iter_density) == it


def test_checkpoint_manager_rotation_resolve_and_resume(tmp_path):
    state_j0, _, _ = _jax_state(updates=0)
    for async_save in (False, True):
        d = tmp_path / f"async{int(async_save)}"
        mgr = tckpt.CheckpointManager(str(d), name="run", max_keep=2, async_save=async_save)
        assert mgr.resolve("latest") is None and mgr.resolve("best") is None
        state = _torch_state(params_np(state_j0.params))
        occ = tocc.init_occupancy(1.0)
        for epoch in range(1, 5):
            state.step = epoch
            mgr.save(state, occ, epoch, {"loss": [float(epoch)]})
        mgr.wait()
        names = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
        assert names == ["run_ep0003.npz", "run_ep0004.npz"]
        assert mgr.resolve("latest") == str(d / "run_ep0004.npz")
        assert mgr.resolve("best") == str(d / "run_ep0004.npz")  # no best yet
        assert mgr.resolve("scratch") is None and mgr.resolve("x.npz") == "x.npz"
        with torch.no_grad():
            state.ema_params["sigma_w0"].add_(1.0)
        best = mgr.save_best(state, occ, 4)
        assert mgr.resolve("best") == best
        # the best checkpoint holds the EMA weights as its params (JAX reads it)
        bj, _, _ = jckpt.load_checkpoint(best, state_j0)
        np.testing.assert_array_equal(np.asarray(bj.params["sigma_w0"]),
                                      n(state.ema_params["sigma_w0"]))
    # a Trainer resumes from its workspace's latest checkpoint
    cfg = tconfig.build_config(_argv(tmp_path) + ["--expname", "run"])
    tr = ttrainer.Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    tr.stats["best_metric"] = 12.5
    tr.state.step = 7
    with torch.no_grad():
        tr.state.params["sigma_w1"].mul_(2.0)
    tr.ckpt.save(tr.state, tr.occupancy, 3, tr.stats)
    tr2 = ttrainer.Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"),
                           use_checkpoint="latest")
    assert tr2.epoch == 3 and tr2.state.step == 7 and tr2.best_metric == 12.5
    for k in tr.state.params:
        assert torch.equal(tr2.state.params[k], tr.state.params[k]), k
        assert torch.equal(tr2.state.ema_params[k], tr.state.ema_params[k]), k
    with pytest.raises(KeyError):
        np.savez(str(tmp_path / "other.npz"), x=np.zeros(3))
        tckpt.load_checkpoint(str(tmp_path / "other.npz"), tr2.state)
