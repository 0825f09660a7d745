"""Parity of the port's TUM-VIE / EDS path with enerf_tpu: compute_ms_to_idx
and EventSlicer on the same H5 files, load_tumvie_dataset and
load_eds_dataset (select_idxs, images_corrupted, hotpixs, both tumvie
pose branches, an EDS t_offset) on directories written by the JAX
package's writers and by the port's, make_providers (stereo views, the val
set, the per-image windows), one event batch with the same window and
draws, one tumvie event step, the stereo views that evaluate writes, the
val split by index into the whole sequence, a batch without host syncs,
and check_supported on every published tumvie / eds config."""

import glob
import json
import os

import cv2
import h5py
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import carry_lpips_from_jax, n, params_np, t

from enerf_tpu import config as jconfig
from enerf_tpu.data import eds as jeds, h5events as jh5, provider as jprov
from enerf_tpu.data import synthetic as jsyn, tumvie as jtumvie
from enerf_tpu.models import field as jfield
from enerf_tpu.ops import hashgrid as jh
from enerf_tpu.train import state as jstate, step as jstep
from enerf_tpu.train import trainer as jtrainer
from enerf_torch import config as tconfig
from enerf_torch.convert import params_from_jax
from enerf_torch.data import eds as teds, h5events as th5, provider as tprov
from enerf_torch.data import tumvie as ttumvie
from enerf_torch.models import field as tfield
from enerf_torch.ops import hashgrid as th
from enerf_torch.train import state as tstate, step as tstep, trainer as ttrainer
from enerf_torch.utils import hdf5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUBLISHED = sorted(p for d in ("mocap1dtrans", "mocapDesk2", "mocapDesk2_6Views", "eds00", "eds11")
                   for p in glob.glob(os.path.join(REPO, "configs", d, "*.txt")))


@pytest.fixture(scope="module")
def sim():
    # dense enough that pixels have >= 2 events inside one image's window
    # (tests/test_eds_tumvie.py's provider fixture)
    return jsyn.simulate_events(H=32, W=32, n_frames=12, C=0.04, turns=0.5)


def _extras(d, sim, events_name):
    """images_corrupted/ (seeded noise) and a hot-pixel-filtered stream
    (every second event) beside a written fixture."""
    src = sorted(glob.glob(os.path.join(d, "*images*", "*.png")))
    os.makedirs(os.path.join(d, "images_corrupted"))
    rng = np.random.default_rng(0)
    for p in src:
        im = cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float64)
        noisy = np.clip(im + rng.normal(0, 12.0, im.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(d, "images_corrupted", os.path.basename(p)), noisy)
    ev = sim["events"][np.argsort(sim["events"][:, 2], kind="stable")][::2]
    jh5.write_event_h5(os.path.join(d, events_name), ev[:, 0], ev[:, 1], ev[:, 2] * 1e6,
                       (ev[:, 3] > 0).astype(np.int8), grouped=True)


@pytest.fixture(scope="module")
def tumvie_dir(sim, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tumvie") / "mocap-desk2")
    jtumvie.save_tumvie_dataset(sim, d, scale=0.33)
    _extras(d, sim, "events_left_hotpixs.h5")
    # an event camera unlike the frame camera (cameras 2 / 3 of the rig)
    calib_path = os.path.join(d, "calib_undist.json")
    calib = json.load(open(calib_path))
    for cam in calib["value0"]["intrinsics_undistorted"][2:]:
        cam.update(fx=cam["fx"] * 1.1, fy=cam["fy"] * 0.95, cx=cam["cx"] + 1.5)
    json.dump(calib, open(calib_path, "w"))
    return d


@pytest.fixture(scope="module")
def eds_dir(sim, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("eds") / "eds_scene")
    jeds.save_eds_dataset(sim, d, scale=0.33)
    _extras(d, sim, "events_hotpixs_0.h5")
    return d


def _assert_data_equal(got, ref):
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, (int, np.integer)) or k in ("images", "event_frame_ids"):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r), err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(r, np.float64),
                                       rtol=1e-9, atol=1e-9, err_msg=k)


# ------------------------------------------------------------ H5 streams


def test_compute_ms_to_idx_matches_jax():
    rng = np.random.default_rng(0)
    t_us = np.sort(rng.integers(0, 50_000, 3000))
    for tick in (1000, 1_000_000):
        ts = t_us * (1 if tick == 1000 else 1000)
        np.testing.assert_array_equal(th5.compute_ms_to_idx(ts, tick_ns=tick),
                                      jh5.compute_ms_to_idx(ts, tick_ns=tick))


@pytest.mark.parametrize("t_offset,grouped", [(None, False), (0, True), (4_000_000, True)])
def test_event_slicer_matches_jax(tmp_path, t_offset, grouped):
    """In-range windows, windows that start before the stream, empty ones,
    and windows whose conservative end is past the ms table (JAX: every
    remaining event), on the same file."""
    rng = np.random.default_rng(1)
    t_us = np.sort(rng.integers(0, 20_000, 5000))
    t_us[-40:] = 20_000 + np.arange(40)  # events inside the table's last ms
    path = str(tmp_path / "ev.h5")
    jh5.write_event_h5(path, rng.integers(0, 64, 5000), rng.integers(0, 48, 5000), t_us,
                       rng.integers(0, 2, 5000), t_offset=t_offset, grouped=grouped)
    off = t_offset or 0
    windows = [(0, 1000), (1500, 1501), (999, 7777), (12_345, 19_999), (19_999, 20_039),
               (19_000, 20_500), (20_001, 99_999), (30_000, 40_000)]
    with h5py.File(path, "r") as fj, hdf5.File(path) as ft:
        sj, st = jh5.EventSlicer(fj), th5.EventSlicer(ft)
        np.testing.assert_array_equal(st.ms_to_idx, sj.ms_to_idx)
        assert (st.t_offset, st.get_start_time_us(), st.get_final_time_us()) == \
            (sj.t_offset, sj.get_start_time_us(), sj.get_final_time_us())
        for a, b in windows:
            rj, rt = sj.get_events(a + off, b + off), st.get_events(a + off, b + off)
            if rj is None:
                assert rt is None, (a, b)
                continue
            assert rt is not None and set(rt) == set(rj)
            for k in rj:
                np.testing.assert_array_equal(rt[k], rj[k], err_msg=f"{k} {a}-{b}")
                assert rt[k].dtype == rj[k].dtype
        assert st.get_events(19_000 + off, 20_500 + off)["t"].size > 0  # past the table


# ------------------------------------------------------------ loaders


LOADER_CASES = {
    "plain": {},
    "select": dict(select_idxs=[1, 3, 4, 7, 10]),
    "corrupted": dict(images_corrupted=True),
    "hotpixs": dict(hotpixs=True, select_idxs=[0, 2, 5, 11]),
    "downscale": dict(downscale=2),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
@pytest.mark.parametrize("pp_poses_sphere", [False, True])
def test_tumvie_loader_matches_jax(tumvie_dir, case, pp_poses_sphere):
    kw = dict(scale=0.33, out_dim_color=1, pp_poses_sphere=pp_poses_sphere,
              **LOADER_CASES[case])
    ref = jtumvie.load_tumvie_dataset(tumvie_dir, **kw)
    got = ttumvie.load_tumvie_dataset(tumvie_dir, **kw)
    assert got["intrinsics_evs"] != got["intrinsics"] and got["W_ev"] == 1280
    assert len(got["events"]) > 1000
    _assert_data_equal(got, ref)


@pytest.mark.parametrize("case", list(LOADER_CASES) + ["port_writer_t_offset"])
def test_eds_loader_matches_jax(eds_dir, sim, tmp_path, case):
    d, kw = eds_dir, dict(LOADER_CASES.get(case, {}))
    if case == "port_writer_t_offset":
        # the port's writer, absolute stamps 7 s after the stream's start
        d = teds.save_eds_dataset(sim, str(tmp_path / "eds_offset"), scale=0.33,
                                  t_offset=7_000_000)
        with h5py.File(os.path.join(d, "events.h5"), "r") as f:
            assert int(f["t_offset"][()]) == 7_000_000 and f["t"][-1] <= 1_000_000
    ref = jeds.load_eds_dataset(d, scale=0.33, out_dim_color=1, **kw)
    got = teds.load_eds_dataset(d, scale=0.33, out_dim_color=1, **kw)
    assert len(got["events"]) > 1000
    _assert_data_equal(got, ref)


def test_port_tumvie_writer_reads_back_through_jax(sim, tmp_path):
    """The port's save_tumvie_dataset (its PNG and HDF5 writers) makes a
    directory that JAX's loader reads as the port's does."""
    d = ttumvie.save_tumvie_dataset(sim, str(tmp_path / "tv"), scale=0.33)
    with h5py.File(os.path.join(d, "rectify_map_left.h5"), "r") as f:
        assert f["rectify_map"].shape == (32, 32, 2) and f["rectify_map"].dtype == np.float32
    kw = dict(scale=0.33, out_dim_color=1, pp_poses_sphere=False)
    _assert_data_equal(ttumvie.load_tumvie_dataset(d, **kw),
                       jtumvie.load_tumvie_dataset(d, **kw))


# ------------------------------------------------------------ providers


def _argv(mode, d, tmp_path, *extra):
    return ["--mode", mode, "--datadir", d, "--outdir", str(tmp_path), "--events", "1",
            "--event_only", "1", "--out_dim_color", "1", "--use_luma", "0",
            "--pp_poses_sphere", "0", "--eval_stereo_views", "1", "--batch_size_evs", "64",
            "--num_rays", "64", "--C_thres", "0.2", "--scale", "0.33", *extra]


def _providers(mode, d, tmp_path, *extra):
    argv = _argv(mode, d, tmp_path, *extra)
    jtr, jva = jprov.make_providers(jconfig.build_config(argv))
    ttr, tva = tprov.make_providers(tconfig.build_config(argv), device="cpu")
    return (jtr, jva), (ttr, tva)


@pytest.mark.parametrize("mode,extra", [("tumvie", ()), ("eds", ()),
                                        ("eds", ("--val_idxs", "3", "--val_idxs", "8")),
                                        ("tumvie", ("--accumulate_evs", "1"))])
def test_make_providers_matches_jax(tumvie_dir, eds_dir, tmp_path, mode, extra):
    """train_idxs None: the windows of all 12 images, the val set, the
    stereo views at the val images' times and the chains' bounds."""
    d = tumvie_dir if mode == "tumvie" else eds_dir
    (jtr, jva), (ttr, tva) = _providers(mode, d, tmp_path, *extra)
    assert ttr.n_frames == jtr.n_frames == 12
    assert (ttr.H, ttr.W) == (jtr.H, jtr.W) and ttr.intrinsics_evs == jtr.intrinsics_evs
    for k in ("frame_bounds", "pixel_bounds"):
        np.testing.assert_array_equal(getattr(ttr.chains, k), np.asarray(getattr(jtr.chains, k)))
        np.testing.assert_array_equal(n(getattr(ttr.chains, k + "_dev")),
                                      np.asarray(getattr(jtr.chains, k)))
    for k in ("xs", "ys", "ts", "pols"):
        np.testing.assert_array_equal(n(getattr(ttr.chains, k)),
                                      np.asarray(getattr(jtr.chains, k)), err_msg=k)
    np.testing.assert_allclose(n(ttr.poses_evs), np.asarray(jtr.poses_evs), rtol=1e-6,
                               atol=1e-6)
    views_t, views_j = tva.val_views(), jva.val_views()
    assert len(views_t) == len(views_j) == (2 if extra and extra[0] == "--val_idxs" else 12)
    for a, b in zip(views_t, views_j):
        np.testing.assert_allclose(a["pose"], b["pose"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(a["gt"], b["gt"])
        assert a["intrinsics"] == b["intrinsics"] and (a["H"], a["W"]) == (b["H"], b["W"])
    assert len(tva.stereo_views) == len(jva.stereo_views) == len(views_j)
    for a, b in zip(tva.stereo_views, jva.stereo_views):
        np.testing.assert_allclose(a["pose"], b["pose"], rtol=1e-9, atol=1e-9)
        assert (a["intrinsics"], a["H"], a["W"], a["gt"]) == \
            (b["intrinsics"], b["H"], b["W"], b["gt"])


def _jax_batch_and_draws(jtr, key):
    """JAX's batch for `key`, and the window and draws it made
    (_event_sample_jit's splits), as tensors."""
    bj = jtr.train_step_batch(key)
    k1, k2, _, _ = jax.random.split(key, 4)
    frame = jax.random.randint(k1, (), 0, jtr.n_frames)
    ka, kb = jax.random.split(k2)
    bounds = jtr.chains.frame_bounds if jtr.accumulate_evs else jtr.chains.pixel_bounds
    lo, hi = np.asarray(bounds[int(frame)])
    r = jax.random.randint(ka, (jtr.batch_size_evs,), 0, max(hi - lo, 1))
    u = jax.random.uniform(kb, (jtr.batch_size_evs,))
    return bj, torch.tensor([int(frame)]), (t(r).long(), t(u))


@pytest.mark.parametrize("mode,extra", [("tumvie", ()), ("eds", ("--precompute_evs_poses", "0")),
                                        ("tumvie", ("--accumulate_evs", "1"))])
def test_event_batch_matches_jax(tumvie_dir, eds_dir, tmp_path, mode, extra):
    """The same window and draws: JAX's event rays (cast with the event
    camera's intrinsics, which differ from the frame camera's on tumvie)
    and polarities."""
    d = tumvie_dir if mode == "tumvie" else eds_dir
    (jtr, _), (ttr, _) = _providers(mode, d, tmp_path, *extra)
    if mode == "tumvie":
        assert ttr.intrinsics_evs != ttr.intrinsics
    for step in range(3):
        bj, frame, draws = _jax_batch_and_draws(jtr, jax.random.PRNGKey(step))
        bt = ttr.train_step_batch(None, frame=frame, draws=draws)
        for k in ("rays_evs_o1", "rays_evs_d1", "rays_evs_o2", "rays_evs_d2", "pols"):
            np.testing.assert_allclose(n(bt[k]), np.asarray(bj[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} step {step}")


def test_tumvie_event_step_matches_jax(tumvie_dir, tmp_path):
    """One event-only step on the fixed-step hash grid from the tumvie
    provider's batch (JAX's, handed to both): loss to rtol 1e-4, gradients
    within test_torch_frames_mode.py's scaled tolerances."""
    (jtr, _), _ = _providers("tumvie", tumvie_dir, tmp_path)
    bj = jtr.train_step_batch(jax.random.PRNGKey(4))
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    grid = dict(num_levels=4, level_dim=2, log2_hashmap_size=13, desired_resolution=64)
    sj.grid_meta, st.grid_meta = jh.HashGridMeta(**grid), th.HashGridMeta(**grid)
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    pj["hash_table"] = jnp.asarray(np.random.default_rng(1).uniform(
        -0.5, 0.5, pj["hash_table"].shape).astype(np.float32))
    common = dict(min_near=0.2, density_scale=1.0, C_thres=0.2, event_only=True,
                  use_luma=False, linlog=True, out_dim_color=1, num_steps=32,
                  upsample_steps=0, weight_loss_rgb=1.0)
    ss_j = jstep.StepStatics(field_static=sj, negative_event_sampling=False, w_no_ev=1.0,
                             **common)
    ss_t = tstep.StepStatics(field_static=st, **common)
    N = bj["pols"].shape[0]
    key = jax.random.PRNGKey(9)
    k_bg, k1, k2 = jax.random.split(key, 7)[:3]
    noise = {"bg": t(jax.random.uniform(k_bg, (1, 1)))}
    for name, k in (("1", k1), ("2", k2)):
        noise[f"jitter{name}"] = t(jax.random.uniform(jax.random.split(k)[0], (N, 32)))
    batch = {k: np.asarray(v) for k, v in bj.items()}
    state_j, opt = jstate.init_train_state(pj, 0.005, 1000)
    (loss_j, aux_j), g_j = jax.value_and_grad(jstep.event_loss_fn, has_aux=True)(
        state_j.params, ss_j, {k: jnp.asarray(v) for k, v in batch.items()}, key, None)
    state_t = tstate.TrainState(params_from_jax(params_np(pj)), 0.005, 1000)
    aux_t = tstep.train_step_events(state_t, {k: t(v) for k, v in batch.items()}, ss_t, None,
                                    noise=noise)
    assert float(aux_t["loss"]) > 1e-3
    np.testing.assert_allclose(float(aux_t["loss"]), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(float(aux_t["loss_evs"]), float(aux_j["loss_evs"]), rtol=1e-4)
    for k, gj in g_j.items():
        gj = np.asarray(gj)
        gt = n(state_t.params[k].grad)
        scale = np.abs(gj).max()
        assert scale > 0, k
        tol = 3e-2 if k in ("hash_table", "sigma_w0") else 1e-3
        np.testing.assert_allclose(gt, gj, rtol=0, atol=tol * scale, err_msg=k)
        assert np.linalg.norm(gt - gj) <= 5e-3 * np.linalg.norm(gj), k


def test_event_batch_makes_no_host_sync(tumvie_dir, tmp_path, monkeypatch):
    """A batch with several windows draws its window on the device: no
    .item(), int(), float(), bool(), .cpu(), .numpy() or .tolist() of a
    tensor (each would wait for the card)."""
    _, (ttr, _) = _providers("tumvie", tumvie_dir, tmp_path, "--negative_event_sampling", "1")
    assert ttr.n_frames == 12 and ttr.noev_coords is not None
    calls = []
    for name in ("item", "__int__", "__float__", "__bool__", "__index__", "cpu", "numpy",
                 "tolist"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    gen = torch.Generator().manual_seed(0)
    for _ in range(8):
        batch = ttr.train_step_batch(gen)
    monkeypatch.undo()
    assert calls == []
    assert batch["rays_evs_o1"].shape == (64, 3) and batch["rays_no_evs_o1"].shape == (32, 3)


# ------------------------------------------------------------ evaluation


def test_stereo_views_written_by_evaluate_match_jax(tumvie_dir, tmp_path, monkeypatch):
    """Both evaluations on the same fixed renders (frame views and stereo
    views told apart by pose[3, 3]): the same affine (a, b) and, under
    validation/event_view/, the same _raw.npy and the same PNG pixels."""
    argv = _argv("tumvie", tumvie_dir, tmp_path, "--val_idxs", "2", "--val_idxs", "6")
    cfg_j, cfg_t = jconfig.build_config(argv), tconfig.build_config(argv)
    _, jva = jprov.make_providers(cfg_j)
    _, tva = tprov.make_providers(cfg_t, device="cpu")
    def fixed(views, base):
        out = [dict(v, pose=np.array(v["pose"], np.float64)) for v in views]
        for i, v in enumerate(out):
            v["pose"][3, 3] = base + i
        return out

    jviews, tviews = fixed(jva.val_views(), 1), fixed(tva.val_views(), 1)
    jva.val_views, tva.val_views = (lambda: jviews), (lambda: tviews)
    jva.stereo_views, tva.stereo_views = fixed(jva.stereo_views, 11), fixed(tva.stereo_views, 11)
    rng = np.random.default_rng(5)
    renders = {}
    for i, v in enumerate(tviews):
        renders[1 + i] = np.clip(0.6 * v["gt"] + 0.2 + rng.normal(0, 0.05, v["gt"].shape),
                                 0, 1).astype(np.float32)
    for j, v in enumerate(tva.stereo_views):
        renders[11 + j] = rng.uniform(0.05, 1, (v["H"], v["W"], 1)).astype(np.float32)

    def render_view(pose, intrinsics, H, W):
        img = renders[int(round(float(np.asarray(pose)[3, 3])))]
        assert img.shape[:2] == (H, W)
        return img, img[..., 0] * 0.5

    carry_lpips_from_jax(monkeypatch)  # both packages' LPIPS on JAX's weights
    jt = jtrainer.Trainer(cfg_j, workspace=str(tmp_path / "jax"), use_checkpoint="scratch")
    tt = ttrainer.Trainer(cfg_t, device="cpu", workspace=str(tmp_path / "torch"))
    jt.render_view = tt.render_view = render_view
    rj, rt = jt.evaluate(jva), tt.evaluate(tva)
    for k in ("psnr", "affine_a", "affine_b", "psnr_corrected"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-9, err_msg=k)
    for k in ("lpips_alex_rand", "lpips_vgg_rand"):  # test_torch_lpips.py's rel 1e-4
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, err_msg=k)
    dj = os.path.join(jt.workspace, "validation", "event_view")
    dt = os.path.join(tt.workspace, "validation", "event_view")
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt)) and len(names) == 6
    for name in names:
        pj, pt = os.path.join(dj, name), os.path.join(dt, name)
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pt), np.load(pj))
        else:
            got = cv2.imread(pt, cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(got, cv2.imread(pj, cv2.IMREAD_UNCHANGED))
            assert got.shape == (720, 1280) and got.dtype == np.uint8


# ------------------------------------------------------------ the val split


@pytest.mark.parametrize("mode", ["tumvie", "eds"])
def test_val_split_indexes_the_whole_sequence(tumvie_dir, eds_dir, tmp_path, mode):
    """train_idxs [2, 4, 6] and val_idxs [3, 5]: the JAX package keeps only
    val indices below the 3 train frames it loaded and then fails to build
    an empty val set; the port's val set is frames 3 and 5 of the
    sequence, as the loader gives them, with stereo views at their times."""
    d = tumvie_dir if mode == "tumvie" else eds_dir
    argv = _argv(mode, d, tmp_path, *sum((["--train_idxs", str(i)] for i in (2, 4, 6)), []),
                 "--val_idxs", "3", "--val_idxs", "5")
    with pytest.raises(ValueError, match="reshape"):
        jprov.make_providers(jconfig.build_config(argv))
    ttr, tva = tprov.make_providers(tconfig.build_config(argv), device="cpu")
    load = (jtumvie.load_tumvie_dataset if mode == "tumvie" else jeds.load_eds_dataset)
    kw = dict(scale=0.33, out_dim_color=1)
    if mode == "tumvie":
        kw["pp_poses_sphere"] = False
    train_ref, val_ref = load(d, select_idxs=[2, 4, 6], **kw), load(d, select_idxs=[3, 5], **kw)
    assert ttr.n_frames == 3
    np.testing.assert_array_equal(ttr.chains.pixel_bounds,
                                  jprov.build_event_chains(
                                      train_ref["events"], train_ref["event_frame_ids"], 3
                                  )[0].pixel_bounds)
    views = tva.val_views()
    assert len(views) == 2 and len(tva.stereo_views) == 2
    for v, gt, pose in zip(views, val_ref["images"], val_ref["poses"]):
        np.testing.assert_array_equal(v["gt"], gt)
        np.testing.assert_allclose(v["pose"], pose, rtol=1e-6, atol=1e-6)
    ev_poses = jprov.make_pose_interpolator(val_ref["hf_ts"], val_ref["hf_poses"])(
        val_ref["tss_imgs_ns"])
    for sv, p in zip(tva.stereo_views, ev_poses):
        np.testing.assert_allclose(sv["pose"][:3], p, rtol=1e-9, atol=1e-9)


# ------------------------------------------------------------ configs


@pytest.mark.parametrize("path", PUBLISHED, ids=lambda p: os.path.basename(p)[:-4])
def test_check_supported_takes_the_published_tumvie_and_eds_configs(path):
    cfg = tconfig.build_config(["--config", path])
    assert cfg.mode in ("tumvie", "eds") and cfg.eval_stereo_views == 1
    tconfig.check_supported(cfg)
    assert len(PUBLISHED) == 19
