"""Package-level checks of enerf_torch: it imports no JAX, its entry points
want the card, and a port-only CPU run of the --ff -O trainer trains."""

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
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'enerf_tpu', 'cv2', 'h5py'))\n"
        "assert len(mods) >= 26, mods\n"
        "assert {'enerf_torch.ops.hashgrid', 'enerf_torch.ops.composite',\n"
        "        'enerf_torch.ops.group_gather', 'enerf_torch.render.renderer',\n"
        "        'enerf_torch.tools.bench_gather', 'enerf_torch.utils.hdf5',\n"
        "        'enerf_torch.data.h5events', 'enerf_torch.data.tumvie',\n"
        "        'enerf_torch.data.eds'} <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_entry_points_want_the_card():
    from enerf_torch.backend import resolve_device
    from enerf_torch.data.provider import make_providers
    from enerf_torch.tools import bench_gather
    from enerf_torch.train.trainer import Trainer
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):  # device=None is the card
        make_providers(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_gather.main(["--rows", "64", "--m", "64"])
    with pytest.raises(RuntimeError):
        resolve_device(None)


def test_config_parses_tpu_flags_and_refuses_missing_paths():
    cfg = _cfg("--fuse_steps", "4", "--segsum_grad", "1", "--mesh_shape", "2")
    assert cfg.fp16 and cfg.cuda_ray and cfg.preload and cfg.ff
    check_supported(cfg)  # TPU-only options are accepted (and ignored)
    # the no-event pair, the device slerp, the frame term, march_warmup and
    # frames mode are ported
    check_supported(_cfg("--negative_event_sampling", "1", "--precompute_evs_poses", "0"))
    check_supported(_cfg("--march_warmup", "10", "--event_only", "0"))
    check_supported(_cfg("--events", "0", "--event_only", "0", "--error_map"))
    # the tumvie / eds loaders are ported (with the stereo event views)
    for config in ("mocapDesk2/mocapDesk2_enerf.txt", "eds11/eds11_enerf.txt"):
        check_supported(build_config(["--config", os.path.join(REPO, "configs", config)]))
    for extra in (["--bg_radius", "2"], ["--encoding", "frequency"], ["--rand_pose", "0"]):
        with pytest.raises(NotImplementedError):
            check_supported(_cfg(*extra))
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
    # occupancy updates before steps 0 and 16
    assert trainer.occupancy.iter_density == 2
    losses = [aux["loss"] for _, aux in trainer.history]
    assert len(losses) == 17 and np.isfinite(losses).all()
    v = val.val_views()[0]
    img, depth = trainer.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
    assert img.shape == (32, 32, 1) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0 + 1e-6
    # CPU tensors take the plain path: the kernel never launched
    assert fused_mlp.fused_field_head.launches == launches
