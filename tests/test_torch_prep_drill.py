"""A small drill of the port's dataset preparation, the counterpart of
tests/test_pipeline_drill.py at a tier-1 size (64 x 64, 6 frames):

    fisheye-distorted JPEG frames and event coordinates
    -> python -m enerf_torch.tools.undistort_images (rectify map + Knew)
    -> the TUM-VIE layout around the tool's outputs -> make_providers
    (load_tumvie_dataset on the JPEG frames) -> 2 training steps and one
    stereo view on device="cpu".

The tool's rectify map and Knew are held to what
scripts/undistort_images.py gives on the same directory.
"""

import json
import os
import shutil
import subprocess
import sys

import h5py
import numpy as np
import torch

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch.data import synthetic
from enerf_torch.utils import camera
from enerf_torch.utils.jpeg import write_jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
D_FISHEYE = np.array([0.0348, -0.0101, 0.0037, -0.0011]) * 4  # TUM-VIE-like, stronger
H = W = 64


def _K(intr):
    fx, fy, cx, cy = intr
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def _distort(xy, intr):
    """The equidistant model forward: undistorted pixels -> distorted ones."""
    fx, fy, cx, cy = intr
    x, y = (xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy
    r = np.sqrt(x * x + y * y)
    th = np.arctan(r)
    k = D_FISHEYE
    thd = th * (1 + k[0] * th ** 2 + k[1] * th ** 4 + k[2] * th ** 6 + k[3] * th ** 8)
    s = np.where(r > 1e-12, thd / np.maximum(r, 1e-12), 1.0)
    return np.stack([x * s * fx + cx, y * s * fy + cy], -1)


def _run(args):
    out = subprocess.run([sys.executable, *args], cwd=REPO, env=ENV, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]


def test_prepared_tumvie_sequence_trains(tmp_path):
    sim = synthetic.simulate_events(H=H, W=W, n_frames=6, C=0.04)
    intr = sim["intrinsics"]
    d = str(tmp_path / "seq")
    os.makedirs(os.path.join(d, "images"))

    # distorted frames: dst(u_d) = clean(undistort(u_d)), as JPEG
    grid = np.stack(np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32)),
                    -1).reshape(-1, 1, 2)
    und = camera.fisheye_undistort_points(grid, _K(intr), D_FISHEYE, P=_K(intr)).reshape(H, W, 2)
    for i, im in enumerate(sim["frames"]):
        img8 = (np.clip(im[..., 0], 0, 1) * 255).astype(np.uint8)
        write_jpeg(os.path.join(d, "images", f"{i:05d}.jpg"),
                   camera.remap_linear(img8, und[..., 0], und[..., 1]))
    fx, fy, cx, cy = intr
    calib = {"intrinsics": [{"fx": fx, "fy": fy, "cx": cx, "cy": cy,
                             **dict(zip(("k1", "k2", "k3", "k4"), D_FISHEYE.tolist()))}]}
    with open(os.path.join(d, "calibration.json"), "w") as f:
        json.dump(calib, f)
    ref = str(tmp_path / "script_copy")
    shutil.copytree(d, ref)

    args = ["--cam", "0", "--model", "fisheye", "--img_glob", "images/*.jpg",
            "--out_suffix", "left"]
    _run(["-m", "enerf_torch.tools.undistort_images", "--datadir", d, "--calib",
          os.path.join(d, "calibration.json"), *args])
    _run([os.path.join(REPO, "scripts", "undistort_images.py"), "--datadir", ref, "--calib",
          os.path.join(ref, "calibration.json"), *args])
    maps = []
    for root in (d, ref):
        with h5py.File(os.path.join(root, "rectify_map_left.h5")) as f:
            maps.append(np.asarray(f["rectify_map"]))
    sent = (maps[1] == camera.FISHEYE_SENTINEL).all(-1)
    assert np.array_equal(sent, (maps[0] == camera.FISHEYE_SENTINEL).all(-1))
    assert np.abs(maps[0] - maps[1])[~sent].max() < 1e-3
    knew = []
    for root in (d, ref):
        with open(os.path.join(root, "calib_undist_left.json")) as f:
            knew.append(json.load(f)["intrinsics_undistorted"][0])
    for k in ("fx", "fy", "cx", "cy"):
        assert abs(knew[0][k] - knew[1][k]) <= 1e-6 * abs(knew[1][k])
    knew = knew[0]

    # the TUM-VIE layout around the tool's outputs
    from enerf_torch.data.h5events import write_event_h5, write_rectify_map
    from enerf_torch.data.tumvie import save_tumvie_dataset
    save_tumvie_dataset(sim, d, scale=0.33)
    rmap_tool = maps[0]
    write_rectify_map(os.path.join(d, "rectify_map_left.h5"), rmap_tool)
    imgdir = os.path.join(d, "left_images_undistorted")
    for name in os.listdir(imgdir):
        if name.endswith(".png"):
            os.remove(os.path.join(imgdir, name))
    for name in os.listdir(os.path.join(d, "images_undistorted_left")):
        shutil.copy(os.path.join(d, "images_undistorted_left", name), os.path.join(imgdir, name))
    ev = sim["events"][np.argsort(sim["events"][:, 2], kind="stable")]
    dist = _distort(ev[:, :2], intr)
    ok = ((dist[:, 0] >= 0) & (dist[:, 0] <= W - 1) & (dist[:, 1] >= 0)
          & (dist[:, 1] <= H - 1))
    ev, dist = ev[ok], np.floor(dist[ok])
    write_event_h5(os.path.join(d, "events_left.h5"), dist[:, 0], dist[:, 1], ev[:, 2] * 1e6,
                   (ev[:, 3] > 0).astype(np.int8), grouped=True)
    with open(os.path.join(d, "calib_undist.json")) as f:
        cal = json.load(f)
    for ci in range(4):
        cal["value0"]["intrinsics_undistorted"][ci] = {k: knew[k] for k in ("fx", "fy", "cx", "cy")}
    for ci in (2, 3):  # the event cameras 2 cm along x
        cal["value0"]["T_imu_cam"][ci] = {"px": 0.02, "py": 0.0, "pz": 0.0, "qx": 0.0,
                                          "qy": 0.0, "qz": 0.0, "qw": 1.0}
    with open(os.path.join(d, "calib_undist.json"), "w") as f:
        json.dump(cal, f)

    # load the JPEG frames, 2 steps, one stereo view
    from enerf_torch.config import build_config
    from enerf_torch.data.provider import make_providers, read_image
    from enerf_torch.train.trainer import Trainer

    cfg = build_config([
        "--mode", "tumvie", "--datadir", d, "--events", "1", "--event_only", "1",
        "--out_dim_color", "1", "--use_luma", "0", "--pp_poses_sphere", "1",
        "--eval_stereo_views", "1", "--batch_size_evs", "128", "--C_thres", "0.04",
        "--num_steps", "16", "--upsample_steps", "0", "--num_levels", "2", "--bound", "1",
        "--scale", "0.33", "--negative_event_sampling", "0", "--train_idxs", "0",
        "--train_idxs", "2", "--train_idxs", "4", "--val_idxs", "3", "--fuse_steps", "1",
        "--outdir", str(tmp_path / "out"), "--expname", "drill"])
    train_p, val_p = make_providers(cfg, device="cpu")
    assert sorted(os.listdir(imgdir))[:-1] == [f"{i:05d}.jpg" for i in range(6)]
    # the val frame is the tool's JPEG, decoded by the port
    np.testing.assert_array_equal(val_p._images_np[0],
                                  read_image(os.path.join(imgdir, "00003.jpg"), 1))
    assert val_p.stereo_views
    trainer = Trainer(cfg, device="cpu")
    losses = [float(trainer.train_step(train_p)["loss"]) for _ in range(2)]
    assert np.all(np.isfinite(losses)), losses
    view = val_p.stereo_views[0]
    fx_e, fy_e, cx_e, cy_e = view["intrinsics"]
    img, depth = trainer.render_view(view["pose"], (fx_e / 10, fy_e / 10, cx_e / 10, cy_e / 10),
                                     view["H"] // 10, view["W"] // 10)
    assert img.shape == (view["H"] // 10, view["W"] // 10, 1) and np.isfinite(img).all()
    assert np.isfinite(depth).all()
