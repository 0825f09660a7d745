"""The trainer's training windows (train/chunk.py) on the CPU, as JAX's
tests/test_trainer.py:78-105 asserts them: the step count, the occupancy
updates, the error map updated, the log count.  The window itself is held
to JAX's by tests/test_torch_chunk.py."""

import numpy as np
import torch

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch.config import build_config
from enerf_torch.data import provider as tprov
from enerf_torch.train.trainer import Trainer


def _trainer_cfg(tmp_path, *extra):
    return build_config([
        "--mode", "synthetic", "--H", "32", "--W", "32", "--syn_frames", "10",
        "--events", "1", "--event_only", "1", "--out_dim_color", "1", "--C_thres", "0.2",
        "--bound", "1", "--lr", "0.005", "--ff", "-O", "--num_levels", "2",
        "--batch_size_evs", "64", "--march_samples", "16", "--log_every", "4",
        "--outdir", str(tmp_path), *extra])


def test_trainer_windows_advance_the_step_occupancy_and_logs(tmp_path):
    """JAX's tests/test_trainer.py:78-105 on the port: 19 steps of 16-step
    windows are one window and 3 per-step steps; the occupancy updated at
    step 0 (the window's) and 16 (the per-step cadence); logs at the
    window's end (crossing a multiple of log_every 6) and at step 18."""
    cfg = _trainer_cfg(tmp_path, "--log_every", "6")
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    train, _ = tprov.make_providers(cfg, device="cpu")
    train.steps_per_epoch = 19
    tr.train(train, max_epoch=1)
    assert tr.state.step == 19 and int(tr.state.count) == 19
    assert tr.occupancy.iter_density == 2
    assert [s for s, _ in tr.history] == [16, 18]
    assert all(np.isfinite(aux["loss"]) for _, aux in tr.history)


def test_trainer_frames_windows_update_the_error_map(tmp_path):
    cfg = build_config([
        "--mode", "synthetic", "--H", "24", "--W", "24", "--syn_frames", "6", "--events", "0",
        "--num_rays", "64", "--num_steps", "8", "--num_levels", "2", "--error_map",
        "--log_every", "16", "--outdir", str(tmp_path)])
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    train, _ = tprov.make_providers(cfg, device="cpu")
    train.steps_per_epoch = 32
    before = train.error_map.clone()
    tr.train(train, max_epoch=1)
    assert tr.state.step == 32 and [s for s, _ in tr.history] == [16, 32]
    assert (train.error_map != before).any() and float(train.error_map.std()) > 0


def test_trainer_steps_after_the_windows_equal_the_per_step_path(tmp_path):
    """An epoch of 18 steps is one window and 2 steps through the window's
    step, one a call, with the per-step path's occupancy update at step 16:
    bit for bit what the per-step path (--fuse_steps 1) gives."""
    runs = {}
    for fuse in ("16", "1"):
        cfg = build_config([
            "--mode", "synthetic", "--H", "24", "--W", "24", "--syn_frames", "6",
            "--events", "0", "--num_rays", "16", "--march_samples", "8", "--ff", "-O",
            "--num_levels", "2", "--bound", "1", "--fuse_steps", fuse,
            "--outdir", str(tmp_path / fuse)])
        tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / fuse / "ws"))
        train, _ = tprov.make_providers(cfg, device="cpu")
        train.steps_per_epoch = 18
        tr.train(train, max_epoch=1)
        runs[fuse] = tr
    a, b = runs["16"], runs["1"]
    assert a.state.step == b.state.step == 18
    assert a.occupancy.iter_density == b.occupancy.iter_density == 2
    for k, v in b.state.params.items():
        assert torch.equal(a.state.params[k], v), k
        assert torch.equal(a.state.ema_params[k], b.state.ema_params[k]), k
    assert torch.equal(a.occupancy.density_grid, b.occupancy.density_grid)
    assert torch.equal(a.occupancy.occ_packed, b.occupancy.occ_packed)
