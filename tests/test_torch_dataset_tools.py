"""The port's dataset tools (enerf_torch/tools/{undistort_images,
numpys_to_h5, inspect_h5, psnrs_corr, raw_to_png}.py) against the scripts
they port (scripts/*.py, on cv2, h5py and the JAX package), each run in a
subprocess on copies of one generated directory."""

import glob
import json
import os
import shutil
import subprocess
import sys

import cv2
import h5py
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
H, W = 48, 64
CALIB = {
    "radtan": {"fx": 0.8 * W, "fy": 0.8 * W * 1.003, "cx": W / 2 - 0.37, "cy": H / 2 + 0.61,
               "k1": -0.33, "k2": 0.12, "p1": 0.0005, "p2": 0.0012, "k3": -0.021},
    "fisheye": {"fx": 0.6 * W, "fy": 0.6 * W, "cx": W / 2 + 0.2, "cy": H / 2 - 0.4,
                "k1": 0.0348, "k2": -0.0101, "k3": 0.0037, "k4": -0.0011},
}


def _run(args, cwd):
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=ENV, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _script(name, *args, cwd=REPO):
    return _run([os.path.join(REPO, "scripts", name + ".py"), *args], cwd)


def _tool(name, *args, cwd=REPO):
    return _run(["-m", "enerf_torch.tools." + name, *args], cwd)


def _frames(n, color, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    out = []
    for i in range(n):
        base = 128 + 80 * np.sin(xx / 5.0 + i) * np.cos(yy / 7.0 - i)
        im = np.clip(base[..., None] + rng.normal(0, 20, (H, W, 3 if color else 1)), 0, 255)
        out.append(im.astype(np.uint8) if color else im[..., 0].astype(np.uint8))
    return out


def _two_copies(src, tmp_path):
    a, b = str(tmp_path / "script"), str(tmp_path / "port")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    return a, b


def _images_close(pa, pb):
    ia, ib = cv2.imread(pa, cv2.IMREAD_UNCHANGED), cv2.imread(pb, cv2.IMREAD_UNCHANGED)
    assert ia.shape == ib.shape and ia.dtype == ib.dtype, (pa, ia.shape, ib.shape)
    d = np.abs(ia.astype(np.int64) - ib)
    assert (d == 0).mean() >= 0.999 and d.max() <= 2, (pa, d.max(), (d > 0).mean())
    return d.max()


def _json_close(pa, pb):
    with open(pa) as f:
        ja = json.load(f)["intrinsics_undistorted"][0]
    with open(pb) as f:
        jb = json.load(f)["intrinsics_undistorted"][0]
    for k in ("fx", "fy", "cx", "cy"):
        assert abs(ja[k] - jb[k]) <= 1e-6 * abs(ja[k]), (k, ja[k], jb[k])


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("model", ["radtan", "fisheye"])
def test_undistort_frames_match_the_script(tmp_path, model, ext):
    src = tmp_path / "seq"
    os.makedirs(src / "images")
    for i, im in enumerate(_frames(3, color=(model == "radtan"), seed=1)):
        cv2.imwrite(str(src / "images" / f"{i:05d}.{ext}"), im)
    with open(src / "calibration.json", "w") as f:
        json.dump({"intrinsics": [CALIB["fisheye"], CALIB[model]]}, f)
    a, b = _two_copies(str(src), tmp_path)
    args = ["--cam", "1", "--model", model, "--img_glob", f"images/*.{ext}", "--out_suffix",
            "left"]
    for run, d in ((_script, a), (_tool, b)):
        run("undistort_images", "--datadir", d, "--calib", os.path.join(d, "calibration.json"),
            *args)
    _json_close(os.path.join(a, "calib_undist_left.json"),
                os.path.join(b, "calib_undist_left.json"))
    with h5py.File(os.path.join(a, "rectify_map_left.h5")) as f:
        ra = np.asarray(f["rectify_map"])
    with h5py.File(os.path.join(b, "rectify_map_left.h5")) as f:
        rb = np.asarray(f["rectify_map"])
    assert ra.shape == rb.shape == (H, W, 2) and ra.dtype == rb.dtype == np.float32
    sent = (ra == -1e6).all(-1)
    assert np.array_equal(sent, (rb == -1e6).all(-1))
    assert np.abs(ra - rb)[~sent].max() < 1e-3
    names = sorted(os.listdir(os.path.join(a, "images_undistorted_left")))
    assert names == sorted(os.listdir(os.path.join(b, "images_undistorted_left")))
    assert len(names) == 3 and all(n.endswith(ext) for n in names)
    for n in names:
        _images_close(os.path.join(a, "images_undistorted_left", n),
                      os.path.join(b, "images_undistorted_left", n))


@pytest.mark.parametrize("model", ["radtan", "fisheye"])
def test_undistort_e2vid_matches_the_script(tmp_path, model):
    src = tmp_path / "seq"
    indir = src / "e2vids" / "left" / "e2vid_up4_freq0" / "e2calib"
    os.makedirs(indir)
    for i, im in enumerate(_frames(3, color=False, seed=2)):
        cv2.imwrite(str(indir / f"frame_{i:04d}.png"), im)
    # the radtan cross-check undistorts with 4 terms, so the calibration has 4
    intr = {k: v for k, v in CALIB[model].items() if model == "fisheye" or k != "k3"}
    with open(src / "calibration.json", "w") as f:
        json.dump({"intrinsics": [intr]}, f)
    a, b = _two_copies(str(src), tmp_path)
    rel = "e2vids/left/e2vid_up4_freq0/e2calib/"
    for run, d in ((_script, a), (_tool, b)):
        run("undistort_images", "--e2vid", "--indir", os.path.join(d, rel), "--calib",
            os.path.join(d, "calibration.json"), "--cam", "0", "--model", model)
    sub = "e2vids/left/e2vid_up4_freq0"
    _json_close(os.path.join(a, sub, "calib_undist_e2vid.json"),
                os.path.join(b, sub, "calib_undist_e2vid.json"))
    names = sorted(os.listdir(os.path.join(a, sub, "e2calib_undistorted")))
    assert names == [f"{i:021d}.png" for i in range(3)]
    assert names == sorted(os.listdir(os.path.join(b, sub, "e2calib_undistorted")))
    for n in names:
        _images_close(os.path.join(a, sub, "e2calib_undistorted", n),
                      os.path.join(b, sub, "e2calib_undistorted", n))


def _h5_datasets(path):
    out = {}
    with h5py.File(path) as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_h5(pa, pb):
    da, db = _h5_datasets(pa), _h5_datasets(pb)
    assert sorted(da) == sorted(db), (sorted(da), sorted(db))
    for k in da:
        va, vb = np.asarray(da[k]), np.asarray(db[k])
        assert va.dtype == vb.dtype and va.shape == vb.shape, (k, va.dtype, vb.dtype)
        assert np.array_equal(va, vb), k


def test_numpys_to_h5_matches_the_script(tmp_path):
    rng = np.random.default_rng(4)
    src = tmp_path / "seq"
    os.makedirs(src / "events")
    t0 = 0
    for i in range(3):
        n = 500 + 100 * i
        t = np.sort(rng.integers(t0, t0 + 40_000_000, n)).astype(np.float64)
        t0 += 40_000_000
        ev = np.stack([rng.integers(0, W, n), rng.integers(0, H, n), t,
                       rng.choice([-1.0, 1.0], n), rng.normal(size=n)], 1)
        np.save(src / "events" / f"{i:04d}.npy", ev[rng.permutation(n)])
    a, b = _two_copies(str(src), tmp_path)
    _script("numpys_to_h5", "--datadir", a)
    _tool("numpys_to_h5", "--datadir", b, "--out", os.path.join(b, "events.h5"))
    _assert_same_h5(os.path.join(a, "events.h5"), os.path.join(b, "events.h5"))


def _write_h5(path, grouped, rng):
    n = 3000
    t = np.sort(rng.integers(1_000_000, 3_500_000, n)).astype(np.int64)
    with h5py.File(path, "w") as f:
        g = f.create_group("events") if grouped else f
        g.create_dataset("x", data=rng.integers(0, W, n).astype(np.uint16))
        g.create_dataset("y", data=rng.integers(0, H, n).astype(np.uint16))
        g.create_dataset("t", data=t)
        g.create_dataset("p", data=rng.integers(0, 2, n).astype(np.uint8 if grouped else np.int8))
        if grouped:  # a stale table and an offset
            f.create_dataset("ms_to_idx", data=np.arange(10, dtype=np.int64))
            f.create_dataset("t_offset", data=np.int64(123456))


@pytest.mark.parametrize("fix", [False, True])
@pytest.mark.parametrize("layout", ["grouped", "flat"])
def test_inspect_h5_matches_the_script(tmp_path, layout, fix):
    src = tmp_path / "seq"
    os.makedirs(src)
    _write_h5(str(src / "events.h5"), layout == "grouped", np.random.default_rng(5))
    a, b = _two_copies(str(src), tmp_path)
    extra = (["--fix_ms_to_idx"] if fix else []) + ["--vis", "vis.png", "--n_vis", "2000"]
    out_a = _script("inspect_h5", "events.h5", *extra, cwd=a)
    out_b = _tool("inspect_h5", "events.h5", *extra, cwd=b)
    assert out_a.splitlines() == out_b.splitlines()
    assert ("MISSING" in out_a) == (layout == "flat")
    _assert_same_h5(os.path.join(a, "events.h5"), os.path.join(b, "events.h5"))
    np.testing.assert_array_equal(cv2.imread(os.path.join(a, "vis.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(os.path.join(b, "vis.png"), cv2.IMREAD_UNCHANGED))
    # without a flag the tool only reads
    out_a = _script("inspect_h5", "events.h5", cwd=a)
    assert out_a.splitlines() == _tool("inspect_h5", "events.h5", cwd=b).splitlines()


def test_psnrs_corr_matches_the_script(tmp_path):
    from enerf_tpu.train.metrics import psnr, solve_normal_equations, ssim
    from enerf_torch.tools import psnrs_corr

    rng = np.random.default_rng(6)
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    os.makedirs(pred_dir)
    os.makedirs(gt_dir)
    for i, g in enumerate(_frames(3, color=True, seed=6)):
        cv2.imwrite(str(gt_dir / f"{i:03d}.png"), g)
        gray = cv2.imread(str(gt_dir / f"{i:03d}.png"), cv2.IMREAD_GRAYSCALE) / 255.0
        pred = np.clip(0.8 * gray + 0.05 + rng.normal(0, 0.03, gray.shape), 0, 1)
        if i == 1:  # an RGB render, taken to luma
            pred = np.repeat(pred[..., None], 3, -1).astype(np.float32)
        np.save(pred_dir / f"{i:03d}_raw.npy", pred.astype(np.float32))
    args = ["--pred_dir", str(pred_dir), "--gt_dir", str(gt_dir)]
    assert _script("psnrs_corr", *args).splitlines() == _tool("psnrs_corr", *args).splitlines()
    # the numbers themselves, against the script's computation
    p_list, g_list = [], []
    for pp, gp in zip(sorted(glob.glob(str(pred_dir / "*.npy"))),
                      sorted(glob.glob(str(gt_dir / "*.png")))):
        p = np.load(pp)
        g = cv2.imread(gp, cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
        if p.ndim == 3:
            p = p @ np.asarray([0.299, 0.587, 0.114], np.float32)
        p_list.append(np.log(255.0 * p.reshape(g.shape) + 1e-3))
        g_list.append(np.log(255.0 * g + 1e-3))
    a, b = solve_normal_equations(np.stack(p_list), np.stack(g_list))
    ref_psnr = np.mean([psnr(np.exp(pl * a + b), np.exp(gl), max_val=255.0)
                        for pl, gl in zip(p_list, g_list)])
    ref_ssim = np.mean([ssim(np.exp(pl * a + b), np.exp(gl), data_range=255.0)
                        for pl, gl in zip(p_list, g_list)])
    got = psnrs_corr.main(args)
    np.testing.assert_allclose(got, (a, b, ref_psnr, ref_ssim), rtol=0, atol=1e-5)


def test_raw_to_png_matches_the_script(tmp_path):
    rng = np.random.default_rng(7)
    src = tmp_path / "ws" / "raw"
    os.makedirs(src)
    np.save(src / "000_raw.npy", rng.uniform(-0.1, 1.1, (H, W)).astype(np.float32))
    np.save(src / "001_raw.npy", rng.uniform(0, 1, (H, W, 1)).astype(np.float32))
    np.save(src / "002_raw.npy", rng.uniform(0.2, 0.7, (H, W, 3)).astype(np.float32))
    a, b = _two_copies(str(tmp_path / "ws"), tmp_path)
    _script("raw_to_png", "--indir", os.path.join(a, "raw"))
    _tool("raw_to_png", "--indir", os.path.join(b, "raw"), "--start_from", "0")
    files = sorted(os.path.relpath(p, a) for p in glob.glob(os.path.join(a, "raw_pngs", "**",
                                                                         "*.png"), recursive=True))
    assert len(files) == 6
    assert files == sorted(os.path.relpath(p, b) for p in glob.glob(
        os.path.join(b, "raw_pngs", "**", "*.png"), recursive=True))
    for rel in files:
        np.testing.assert_array_equal(cv2.imread(os.path.join(a, rel), cv2.IMREAD_UNCHANGED),
                                      cv2.imread(os.path.join(b, rel), cv2.IMREAD_UNCHANGED))


def test_write_image_matches_cv2_imwrite(tmp_path):
    """The tools write what cv2.imwrite writes: PNGs of every frame kind
    cv2 reads unchanged (uint8 / uint16, gray / BGR / BGRA) and JPEGs."""
    from enerf_torch.data.provider import read_unchanged, write_image

    rng = np.random.default_rng(8)
    for i, (shape, dtype) in enumerate((((20, 30), np.uint8), ((20, 30, 3), np.uint8),
                                        ((20, 30, 4), np.uint8), ((20, 30), np.uint16),
                                        ((20, 30, 3), np.uint16))):
        img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype)
        path = str(tmp_path / f"{i}.png")
        write_image(path, img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(read_unchanged(path), img)
    img = _frames(1, color=True, seed=8)[0]
    write_image(str(tmp_path / "a.jpg"), img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
