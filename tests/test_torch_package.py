"""Package-level checks of enerf_torch: it imports no JAX, its entry points
want the card, a port-only CPU run of the --ff -O trainer trains, and the
CLI honours --test (mesh), --profile and --gui."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch.config import build_config, check_supported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(*extra):
    return build_config([
        "--mode", "synthetic", "--H", "32", "--W", "32", "--syn_frames", "10",
        "--events", "1", "--event_only", "1", "--out_dim_color", "1",
        "--C_thres", "0.2", "--bound", "1", "--lr", "0.005", "--ff", "-O",
        "--num_levels", "2", "--batch_size_evs", "64", "--march_samples", "16",
        "--log_every", "1", *extra])


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import enerf_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(enerf_torch.__path__, 'enerf_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'enerf_tpu', 'cv2', 'h5py', 'PIL'))\n"
        "assert len(mods) >= 32, mods\n"
        "assert {'enerf_torch.ops.hashgrid', 'enerf_torch.ops.composite',\n"
        "        'enerf_torch.ops.group_gather', 'enerf_torch.render.renderer',\n"
        "        'enerf_torch.tools.bench_gather', 'enerf_torch.utils.hdf5',\n"
        "        'enerf_torch.data.h5events', 'enerf_torch.data.tumvie',\n"
        "        'enerf_torch.data.eds', 'enerf_torch.utils.mesh',\n"
        "        'enerf_torch.train.lpips', 'enerf_torch.utils.plotting',\n"
        "        'enerf_torch.utils.profiling', 'enerf_torch.viewer',\n"
        "        'enerf_torch.tools.render', 'enerf_torch.cli', 'enerf_torch.parallel.mesh',\n"
        "        'enerf_torch.parallel.multihost', 'enerf_torch.utils.jpeg',\n"
        "        'enerf_torch.utils.camera', 'enerf_torch.tools.undistort_images',\n"
        "        'enerf_torch.tools.numpys_to_h5', 'enerf_torch.tools.inspect_h5',\n"
        "        'enerf_torch.tools.psnrs_corr', 'enerf_torch.tools.raw_to_png',\n"
        "        'enerf_torch.data.native_events'} <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_entry_points_want_the_card(tmp_path):
    from enerf_torch.backend import resolve_device
    from enerf_torch.data.provider import make_providers
    from enerf_torch.tools import bench_gather, render
    from enerf_torch.train import metrics
    from enerf_torch.train.trainer import Trainer
    from enerf_torch.utils import mesh
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    # the render tool on a trained workspace; save_mesh queries and extracts
    # on its trainer's device, whose default is the card
    trainer = Trainer(_cfg(), device="cpu", workspace=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        render.main(["--model_dir", trainer.workspace, "--n_poses", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.extract_fields([-1] * 3, [1] * 3, 4, lambda p: p[:, 0])
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.compute_lpips(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)))
    trainer.save_mesh(resolution=4)  # a CPU trainer's mesh stays on the CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):  # device=None is the card
        make_providers(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_gather.main(["--rows", "64", "--m", "64"])
    with pytest.raises(RuntimeError):
        resolve_device(None)


def test_config_parses_tpu_flags_and_refuses_missing_paths():
    from enerf_torch.config import TPU_ONLY
    cfg = _cfg("--fuse_steps", "4", "--segsum_grad", "1")
    assert cfg.fp16 and cfg.cuda_ray and cfg.preload and cfg.ff
    check_supported(cfg)  # TPU-only options are accepted (and ignored)
    # the data-parallel options are the port's own (parallel/, cli.py)
    cfg = _cfg("--mesh_shape", "2", "--multihost", "1")
    assert cfg.mesh_shape == [2] and cfg.multihost == 1
    # ... and so is the training window (train/chunk.py)
    assert not {"mesh_shape", "multihost", "fuse_steps"} & set(TPU_ONLY)
    check_supported(cfg)
    # the no-event pair, the device slerp, the frame term, march_warmup and
    # frames mode are ported
    check_supported(_cfg("--negative_event_sampling", "1", "--precompute_evs_poses", "0"))
    check_supported(_cfg("--march_warmup", "10", "--event_only", "0"))
    check_supported(_cfg("--events", "0", "--event_only", "0", "--error_map"))
    # the tumvie / eds loaders are ported (with the stereo event views)
    for config in ("mocapDesk2/mocapDesk2_enerf.txt", "eds11/eds11_enerf.txt"):
        check_supported(build_config(["--config", os.path.join(REPO, "configs", config)]))
    # and so are the background net, the grid-free encoders and the CLIP step
    for extra in (["--bg_radius", "2"], ["--encoding", "frequency"], ["--encoding", "none"],
                  ["--rand_pose", "0", "--clip_text", "a ball"]):
        cfg = _cfg(*extra)
        assert check_supported(cfg) is cfg
    demo = os.path.join(REPO, "configs", "synthetic_demo.txt")
    check_supported(build_config(["--config", demo, "--ff", "-O"]))
    # the published configs' path: hash grid, fixed-step renderer, frames
    cfg = build_config(["--config", demo, "--event_only", "0"])
    assert not (cfg.ff or cfg.tcnn or cfg.cuda_ray) and cfg.encoding == "auto"
    check_supported(cfg)


def test_trainer_cpu_run_trains_with_occupancy_updates(tmp_path):
    from enerf_torch.data.provider import make_providers
    from enerf_torch.ops import fused_mlp
    from enerf_torch.train.trainer import Trainer
    cfg = _cfg()
    trainer = Trainer(cfg, device="cpu", workspace=str(tmp_path))
    assert trainer.static.use_fused_head
    assert trainer.static.compute_dtype == torch.bfloat16
    train, val = make_providers(cfg, device="cpu")
    train.steps_per_epoch = 17
    launches = fused_mlp.fused_field_head.launches
    trainer.train(train, max_epoch=1)
    assert trainer.state.step == 17
    # occupancy updates before steps 0 and 16: the window's (steps 0-15,
    # fuse_steps 16) and the per-step path's before step 16
    assert trainer.occupancy.iter_density == 2
    # logged: the window's mean at step 16, then step 17 (log_every 1)
    assert [s for s, _ in trainer.history] == [16, 17]
    losses = [aux["loss"] for _, aux in trainer.history]
    assert np.isfinite(losses).all()
    v = val.val_views()[0]
    img, depth = trainer.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
    assert img.shape == (32, 32, 1) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0 + 1e-6
    # CPU tensors take the plain path: the kernel never launched
    assert fused_mlp.fused_field_head.launches == launches


def _cli_argv(tmp_path, *extra):
    # frames mode on the hash grid (the published configs' path), tiny
    return ["--mode", "synthetic", "--H", "24", "--W", "24", "--syn_frames", "10",
            "--num_rays", "128", "--num_steps", "16", "--num_levels", "2",
            "--val_idxs", "0", "--eval_interval", "1", "--log_every", "50",
            "--outdir", str(tmp_path), "--expname", "cli", "--device", "cpu", *extra]


@pytest.fixture
def small_meshes(monkeypatch):
    """The CLI's save_mesh(256, 10) calls, recorded, run at 16^3 (the 256^3
    query is the card's work: chip_smoke.py runs it)."""
    from enerf_torch.train.trainer import Trainer
    calls, save_mesh = [], Trainer.save_mesh

    def small(self, path=None, resolution=256, threshold=10.0):
        calls.append((resolution, threshold))
        return save_mesh(self, path, resolution=16, threshold=threshold)

    monkeypatch.setattr(Trainer, "save_mesh", small)
    return calls


def test_cli_trains_then_writes_mesh_lpips_and_a_profile(tmp_path, small_meshes):
    """python -m enerf_torch ... --iters 2 --profile 1: one 100-step epoch,
    the evaluation with finite LPIPS, a trace of the second 16-step window
    (the first one after step 1), the test render and the mesh after train
    + test."""
    from enerf_torch.__main__ import main
    main(_cli_argv(tmp_path, "--iters", "2", "--profile", "1"))
    ws = os.path.join(str(tmp_path), "testweek", "cli")
    log = open(os.path.join(ws, "log.txt")).read()
    ev = [ln for ln in log.splitlines() if ln.startswith("[eval]")]
    assert len(ev) == 1 and "lpips_alex_rand=" in ev[0] and "lpips_vgg_rand=" in ev[0]
    vals = [float(tok.split("=")[1]) for tok in ev[0].split() if tok.startswith("lpips_")]
    assert len(vals) == 2 and np.isfinite(vals).all() and min(vals) > 0
    assert small_meshes == [(256, 10.0)]
    assert os.path.exists(os.path.join(ws, "meshes", "cli_ep0001.obj"))
    # one trace and, beside it, the span registry's snapshot of the same steps
    files = sorted(os.listdir(os.path.join(ws, "profile")))
    assert len(files) == 2 and files[0].startswith("spans_") and files[1].startswith("trace_")
    assert files[0][len("spans_"):] == files[1][len("trace_"):]
    assert "[profile] trace of steps 17-32" in log
    assert os.path.exists(os.path.join(ws, "diagnostics"))
    assert os.path.exists(os.path.join(ws, "results", "0000.png"))


def test_cli_test_writes_a_mesh_and_gui_serves_the_viewer(tmp_path, small_meshes, monkeypatch):
    """--test renders and exports the mesh without training; --gui builds
    the viewer instead of training (driven here on an ephemeral port)."""
    import threading
    import urllib.request
    from enerf_torch import viewer
    from enerf_torch.__main__ import main
    from enerf_torch.utils.png import decode_png

    main(_cli_argv(tmp_path, "--test"))
    ws = os.path.join(str(tmp_path), "testweek", "cli")
    assert small_meshes == [(256, 10.0)]
    assert os.path.exists(os.path.join(ws, "meshes", "cli_ep0000.obj"))
    assert os.path.exists(os.path.join(ws, "results", "0000.png"))
    assert not os.path.exists(os.path.join(ws, "checkpoints", "cli_ep0001.npz"))

    served = {}

    def serve(gui, host="127.0.0.1", port=7007):
        assert (host, port) == ("127.0.0.1", 7007)
        server = viewer.make_viewer_server(gui, host, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://{host}:{server.server_address[1]}/frame"
            with urllib.request.urlopen(url, timeout=120) as r:
                served["frame"] = decode_png(r.read())
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        served["gui"] = gui

    monkeypatch.setattr(viewer, "serve_web_viewer", serve)
    main(_cli_argv(tmp_path / "gui", "--gui", "--max_spp", "4"))
    gui = served["gui"]
    assert gui.training and gui.max_spp == 4 and gui.cam.W == 24
    assert served["frame"].shape == (24, 24)  # out_dim_color 1: grayscale
    assert gui.trainer.state.step == 16  # the frame's 16 steps, no epoch
    ws = os.path.join(str(tmp_path / "gui"), "testweek", "cli")
    assert not os.listdir(os.path.join(ws, "checkpoints"))
