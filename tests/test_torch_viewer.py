"""The port's viewer (enerf_torch/viewer.py), render tool
(enerf_torch/tools/render.py) and --profile traces, on the CPU: the orbit
camera against enerf_tpu's, the GUI renderer's progressive and dynamic
behaviour as tests/test_viewer_tools.py checks JAX's, the HTTP server on
an ephemeral port, the turntable, the render tool and a trace."""

import glob
import json
import math
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_tpu import viewer as jviewer
from enerf_tpu.data import poses as jposes
from enerf_torch import viewer as tviewer
from enerf_torch.config import build_config
from enerf_torch.data import poses as tposes
from enerf_torch.data.provider import make_providers
from enerf_torch.train.trainer import Trainer
from enerf_torch.utils.png import decode_png, read_png


def _cfg(tmp_path, *extra):
    # frames mode on the hash grid, the published configs' path, tiny
    return build_config(["--mode", "synthetic", "--H", "24", "--W", "24", "--syn_frames", "10",
                         "--num_rays", "128", "--num_steps", "24", "--num_levels", "2",
                         "--out_dim_color", "3", "--use_luma", "1", "--lr", "0.01",
                         "--log_every", "1", "--outdir", str(tmp_path), *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A trainer after one 5-step epoch (a checkpoint in its workspace)."""
    tmp = tmp_path_factory.mktemp("viewer")
    cfg = _cfg(tmp)
    trainer = Trainer(cfg, device="cpu")
    train, val = make_providers(cfg, device="cpu")
    train.steps_per_epoch = 5
    trainer.train(train, None, max_epoch=1)
    return trainer, train, val


def test_orbit_camera_matches_jax():
    cams = [jviewer.OrbitCamera(64, 48, r=3.0, fovy=60.0),
            tviewer.OrbitCamera(64, 48, r=3.0, fovy=60.0)]
    for c in cams:
        c.orbit(32, 5)
        c.scale(1)
        c.pan(10, -4, 2)
        c.orbit(-7, 100)  # pitch clipped at 1.5
    np.testing.assert_array_equal(cams[1].pose, cams[0].pose)
    assert cams[1].intrinsics == cams[0].intrinsics
    p = cams[1].pose
    np.testing.assert_allclose(p[:3, :3] @ p[:3, :3].T, np.eye(3), atol=1e-8)
    assert cams[1].pitch == 1.5 and cams[1].radius < 3.0


def test_spiral_path_matches_jax():
    center = np.eye(4)
    center[:3, 3] = [0, 0, -2.0]
    np.testing.assert_array_equal(tposes.spiral_path(center, [0.8, 0.8, 0.3], 2.0, 7),
                                  jposes.spiral_path(center, [0.8, 0.8, 0.3], 2.0, 7))


def test_gui_renderer_progressive_and_dynamic(trained):
    trainer, train, _ = trained
    step = trainer.state.step
    gui = tviewer.GUIRenderer(trainer, train, W=32, H=32, frame_budget_ms=1e9)
    loss = gui.train_steps(4)
    assert np.isfinite(loss) and trainer.state.step == step + 4
    f1 = gui.render_frame()
    assert gui.spp == 1 and f1.shape == (32, 32, 3)
    f2 = gui.render_frame()
    assert gui.spp == 2 and f2.shape == f1.shape  # progressive accumulation
    np.testing.assert_allclose(f2, f1, atol=1e-6)  # the same view, averaged
    gui.cam.orbit(4, 0)
    gui.reset_view()
    assert gui.spp == 0
    # dynamic downscale: a tiny budget forces the resolution down
    gui2 = tviewer.GUIRenderer(trainer, None, W=64, H=64, frame_budget_ms=0.001)
    gui2.render_frame()
    gui2.reset_view()
    gui2.render_frame()
    assert 0.25 <= gui2.downscale < 1.0 and not gui2.training


def test_viewer_server_on_an_ephemeral_port(trained):
    trainer, train, _ = trained
    gui = tviewer.GUIRenderer(trainer, train, W=32, H=24, frame_budget_ms=1e9)
    server = tviewer.make_viewer_server(gui, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            assert b"/frame" in r.read()
        step = trainer.state.step
        with urllib.request.urlopen(base + "/frame", timeout=120) as r:
            assert r.headers["Content-Type"] == "image/png"
            img = decode_png(r.read())
        assert img.shape == (24, 32, 3) and img.dtype == np.uint8
        assert trainer.state.step == step + 16  # training between frames
        pose = gui.cam.pose
        with urllib.request.urlopen(base + "/orbit?dx=8&dy=2&dz=1", timeout=60) as r:
            assert r.status == 200
        assert not np.allclose(gui.cam.pose, pose) and gui.spp == 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_turntable_recorder(trained, tmp_path):
    trainer = trained[0]
    out = tviewer.TurntableRecorder(trainer, W=24, H=16).record(str(tmp_path / "tt"), n_frames=3)
    names = sorted(os.listdir(out))
    assert names == ["0000.png", "0001.png", "0002.png"]
    frames = [read_png(os.path.join(out, n)) for n in names]
    assert all(f.shape == (16, 24, 3) for f in frames)
    assert not np.array_equal(frames[0], frames[1])  # the orbit moves


def test_render_tool_val_and_quatlist(trained, tmp_path):
    from scipy.spatial.transform import Rotation as R
    from enerf_torch.data import synthetic
    from enerf_torch.tools import render

    trainer = trained[0]
    args_json = os.path.join(trainer.workspace, "args.json")
    before = open(args_json).read()
    outdir = str(tmp_path / "renders")
    render.main(["--model_dir", trainer.workspace, "--traj", "val", "--n_poses", "2",
                 "--H", "16", "--W", "20", "--outdir", outdir, "--device", "cpu"])
    assert sorted(os.listdir(outdir)) == ["0000.png", "0000_depth.png", "0000_raw.npy",
                                         "0001.png", "0001_depth.png", "0001_raw.npy"]
    raw = np.load(os.path.join(outdir, "0000_raw.npy"))
    assert raw.shape == (16, 20, 3) and np.isfinite(raw).all()
    np.testing.assert_array_equal(read_png(os.path.join(outdir, "0000.png"))[..., ::-1],  # BGR
                                  (np.clip(raw, 0, 1) * 255).astype(np.uint8))
    # the checkpoint's weights: the same render as the trainer's EMA weights
    intr = synthetic.default_intrinsics(16, 20, trainer.cfg.fovy)
    ckpt_state = Trainer(trainer.cfg, device="cpu", workspace=trainer.workspace,
                         use_checkpoint="latest", snapshot=False)
    want, _ = ckpt_state.render_view(synthetic.circle_pose(0.0), intr, 16, 20)
    np.testing.assert_array_equal(raw, want)
    assert open(args_json).read() == before  # read-only use of the workspace

    # a quaternion list of poses
    pose = synthetic.circle_pose(0.3)
    qpath = str(tmp_path / "poses.txt")
    np.savetxt(qpath, np.asarray([[0.0, *pose[:3, 3], *R.from_matrix(pose[:3, :3]).as_quat()]]),
               header="ts px py pz qx qy qz qw")
    np.testing.assert_allclose(render.load_quatlist_poses(qpath)[0], pose, atol=1e-7)
    outdir2 = str(tmp_path / "renders_q")
    render.main(["--model_dir", trainer.workspace, "--infile", qpath, "--H", "16", "--W", "16",
                 "--outdir", outdir2, "--device", "cpu"])
    assert "0000.png" in os.listdir(outdir2) and len(os.listdir(outdir2)) == 3


def test_profile_writes_a_trace(tmp_path):
    """--profile 1 on a 3-step epoch traces step 2 into <workspace>/profile/."""
    cfg = _cfg(tmp_path, "--profile", "1")
    trainer = Trainer(cfg, device="cpu")
    train, _ = make_providers(cfg, device="cpu")
    train.steps_per_epoch = 3
    trainer.train(train, None, max_epoch=1)
    traces = glob.glob(os.path.join(trainer.workspace, "profile", "*.json"))
    assert traces == [trainer.profile_path]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert any("[profile] trace of steps 2-2" in line
               for line in open(os.path.join(trainer.workspace, "log.txt")))
    # without --profile nothing is traced
    t2 = Trainer(_cfg(tmp_path / "off"), device="cpu")
    train2, _ = make_providers(t2.cfg, device="cpu")
    train2.steps_per_epoch = 2
    t2.train(train2, None, max_epoch=1)
    assert t2.profile_path is None and not os.path.exists(os.path.join(t2.workspace, "profile"))


def test_step_timer_and_trace_context(tmp_path):
    from enerf_torch.utils import profiling
    timer = profiling.StepTimer("cpu")
    for _ in range(3):
        with timer.measure():
            torch.ones(64).sum()
    assert len(timer.times) == 3 and timer.mean_ms() >= 0
    with profiling.trace(str(tmp_path / "tr"), cuda=False) as out:
        torch.ones(64).cumsum(0)
    assert os.path.exists(out["path"]) and math.isfinite(os.path.getsize(out["path"]))
