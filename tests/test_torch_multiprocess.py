"""The port's data-parallel entry points on the CPU, each rank a process:
`python -m enerf_torch --mesh_shape 2 --device cpu` (ranks spawned over
gloo) trains and checkpoints once, from rank 0; a new 2-rank job resumes
that checkpoint; `--multihost 1` under torchrun trains the same way; the
distributed environment that is missing or asks for more cards than there
are raises.  And the --ff -O trainer on two ranks: the sharded occupancy
update, the march steps and the sharded evaluation, the ranks bit-equal.

Every subprocess runs in its own session under a timeout, after which its
whole process group is killed; a hung rank fails its test in minutes.
"""

import datetime
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch import cli
from enerf_torch.parallel import mesh as dp

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SMALL_MESH_CLI = os.path.join(HERE, "torch_cli_small_mesh.py")


def _argv(outdir, *extra):
    # frames mode on the hash grid with the error map, tiny: one 100-step
    # epoch, its evaluation, the test render, the mesh; the per-step path
    # (--fuse_steps 1: the config's batch split over the ranks; the window
    # path is tests/test_torch_chunk_mesh.py's)
    return ["--mode", "synthetic", "--H", "24", "--W", "24", "--syn_frames", "10",
            "--fuse_steps", "1",
            "--num_rays", "128", "--num_steps", "16", "--num_levels", "2", "--error_map",
            "--val_idxs", "0", "--eval_interval", "1", "--log_every", "50", "--iters", "2",
            "--outdir", str(outdir), "--expname", "cli", "--device", "cpu", *extra]


def _run(cmd, timeout=240):
    """Run cmd in its own session; kill the whole group after `timeout` s."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"{cmd} did not finish in {timeout} s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-6000:]
    return out


def _log(outdir):
    with open(os.path.join(outdir, "testweek", "cli", "log.txt")) as f:
        return f.read()


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh2")
    _run([sys.executable, SMALL_MESH_CLI, *_argv(out, "--mesh_shape", "2")])
    return out


def test_cli_mesh_shape_trains_with_one_log_and_one_checkpoint(mesh_run):
    log = _log(mesh_run)
    assert "[mesh] 2 ranks over gloo" in log
    # rank 0 alone logs: each line once
    assert log.count("[train] done at epoch 1, step 100") == 1
    steps = [ln for ln in log.splitlines() if ln.startswith("[train] epoch 1 step")]
    assert [ln.split()[4] for ln in steps] == ["50", "100"]
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in steps]
    assert np.isfinite(losses).all()
    assert log.count("[eval] epoch 1") == 1 and "replication check" in log
    ws = os.path.join(mesh_run, "testweek", "cli")
    assert sorted(os.listdir(os.path.join(ws, "checkpoints"))) == [
        "cli_best.json", "cli_best.npz", "cli_ep0001.json", "cli_ep0001.npz"]
    assert os.path.exists(os.path.join(ws, "results", "0000.png"))
    assert os.path.exists(os.path.join(ws, "meshes", "cli_ep0001.obj"))


def test_cli_new_job_resumes_rank0_checkpoint(mesh_run):
    """A fresh 2-rank job loads the checkpoint on every rank, at the same
    step, replicated and checked bit-equal; --test renders and meshes."""
    _run([sys.executable, SMALL_MESH_CLI, *_argv(mesh_run, "--mesh_shape", "2", "--test")])
    log = _log(mesh_run)
    assert "[ckpt] resumed from" in log and "cli_ep0001.npz at epoch 1" in log
    assert "[mesh] state replicated from rank 0 at step 100; the ranks agree" in log
    ws = os.path.join(mesh_run, "testweek", "cli")
    assert os.path.exists(os.path.join(ws, "meshes", "cli_ep0001.obj"))


def test_cli_multihost_under_torchrun(tmp_path):
    """--multihost 1 joins torchrun's job: each rank samples the config's
    batch (the global batch is their sum), rank 0 logs and checkpoints."""
    _run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
          "2", SMALL_MESH_CLI, *_argv(tmp_path, "--multihost", "1")])
    log = _log(tmp_path)
    assert "[mesh] 2 ranks over gloo" in log
    assert log.count("[train] done at epoch 1, step 100") == 1 and "replication check" in log
    ckpts = os.listdir(os.path.join(tmp_path, "testweek", "cli", "checkpoints"))
    assert "cli_ep0001.npz" in ckpts


def test_cli_refuses_a_missing_or_too_large_distributed_environment(tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(_argv(tmp_path, "--multihost", "1"))
    assert not torch.distributed.is_initialized()
    cards = torch.cuda.device_count()
    argv = _argv(tmp_path, "--mesh_shape", str(max(2, cards + 1)))
    argv.remove("--device")
    argv.remove("cpu")
    with pytest.raises(RuntimeError, match=f"has {cards} CUDA devices"):
        cli.main(argv)
    with pytest.raises(ValueError, match="--gui"):
        cli.main(_argv(tmp_path, "--mesh_shape", "2", "--gui"))
    assert not os.path.exists(os.path.join(tmp_path, "testweek"))


def _march_ranks(mesh, workspace, out_dir):
    """Two ranks of the --ff -O trainer: 2 steps (the occupancy update
    before step 0) and the evaluation of one view."""
    from enerf_torch.config import build_config
    from enerf_torch.data.provider import make_providers
    from enerf_torch.ops import fused_mlp
    from enerf_torch.train.trainer import Trainer
    torch.set_num_threads(1)
    cfg = build_config([
        "--mode", "synthetic", "--H", "32", "--W", "32", "--syn_frames", "10",
        "--events", "1", "--event_only", "1", "--out_dim_color", "1", "--C_thres", "-1",
        "--bound", "1", "--lr", "0.005", "--ff", "-O", "--num_levels", "2",
        "--batch_size_evs", "64", "--march_samples", "16", "--log_every", "1",
        "--val_idxs", "0", "--eval_interval", "1", "--fuse_steps", "1"])
    trainer = Trainer(cfg, workspace=workspace, mesh=mesh)
    train, val = make_providers(cfg, device="cpu", shards=mesh.world_size)
    assert train.batch_size_evs == 32
    train.steps_per_epoch = 2
    trainer.train(train, val, max_epoch=1)
    img, _ = trainer.render_view(**{k: val.val_views()[0][k]
                                    for k in ("pose", "intrinsics", "H", "W")})
    out = {f"param/{k}": p.detach().numpy() for k, p in trainer.state.params.items()}
    out.update(grid=trainer.occupancy.density_grid.numpy(), img=img,
               iter_density=trainer.occupancy.iter_density, step=trainer.state.step,
               losses=[aux["loss"] for _, aux in trainer.history],
               psnr=trainer.last_eval["psnr_corrected"],
               kernel_launches=fused_mlp.fused_field_head.launches)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)


def test_march_trainer_on_two_ranks(tmp_path):
    """--ff -O through parallel.mesh.spawn, as the CLI starts ranks: the
    sharded occupancy update, two data-parallel march steps with the global
    norm (C_thres -1), the sharded evaluation; the ranks bit-equal, the
    files written once."""
    dp.spawn(_march_ranks, ["cpu", "cpu"], args=(str(tmp_path / "ws"), str(tmp_path)),
             timeout=datetime.timedelta(seconds=120))
    r0, r1 = (dict(np.load(tmp_path / f"rank{r}.npz")) for r in (0, 1))
    for k, v in r0.items():
        np.testing.assert_array_equal(r1[k], v, err_msg=k)
    assert int(r0["step"]) == 2 and int(r0["iter_density"]) == 1
    assert (r0["grid"] >= 0).any() and np.isfinite(r0["losses"]).all()
    assert r0["img"].shape == (32, 32, 1) and np.isfinite(r0["img"]).all()
    assert np.isfinite(float(r0["psnr"]))
    assert int(r0["kernel_launches"]) == 0  # CPU tensors take K1's plain version
    with open(tmp_path / "ws" / "log.txt") as f:
        assert f.read().count("[train] done at epoch 1, step 2") == 1
