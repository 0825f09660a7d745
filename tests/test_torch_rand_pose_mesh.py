"""--rand_pose under --mesh_shape: two gloo ranks (tests/torch_rand_pose_worker.py,
in a subprocess of its own session under a timeout) take a data-parallel
frame step and then the rand-pose CLIP step on the same pose; their state
stays bit-equal and matches one process's CLIP step from the same state
and draws within 1e-6 by norm (that one-process step is held to JAX's
train_step_clip by tests/test_torch_clip.py).  --multihost still refuses
--rand_pose."""

import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from torch_rand_pose_worker import ARGS  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rand_pose_mesh"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_rand_pose_worker.py"),
                             out], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"the two ranks did not finish in 240 s:\n{log[-4000:]}")
    assert proc.returncode == 0, log[-6000:]
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in (0, 1)]


def test_ranks_stay_bit_equal_after_the_clip_step(ranks):
    r0, r1 = ranks
    assert int(r0["rays"]) == 64  # each rank's frame batch is half the config's
    keys = [k for k in r0 if k.startswith("after/")]
    assert any(k.startswith("after/params/") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert float(r0["loss_clip"]) == float(r1["loss_clip"])
    # the step changed the params
    assert any(not np.array_equal(r0[k], r0[k.replace("after/", "before/")])
               for k in keys if k.startswith("after/params/"))


def test_clip_step_matches_one_process(ranks, tmp_path):
    from enerf_torch.config import build_config
    from enerf_torch.data.provider import make_providers
    from enerf_torch.parallel import mesh as dp
    from enerf_torch.train.trainer import Trainer

    r0 = ranks[0]
    cfg = build_config(ARGS + ["--outdir", str(tmp_path)])
    trainer = Trainer(cfg, device="cpu")
    provider, _ = make_providers(cfg, device="cpu")
    with torch.no_grad():
        for k, t in dp.replicated_tensors(trainer.state).items():
            t.copy_(torch.from_numpy(r0["before/" + k]))
    trainer.state.step = int(r0["step"])
    trainer.generator.set_state(torch.from_numpy(r0["gen_state"]))
    provider._batch_i = int(r0["batch_i"])
    aux = trainer.train_step(provider)
    assert "loss_clip" in aux
    np.testing.assert_allclose(float(aux["loss_clip"]), float(r0["loss_clip"]), rtol=1e-6)
    for k, t in dp.replicated_tensors(trainer.state).items():
        ref = r0["after/" + k]
        got = t.detach().numpy()
        err = np.linalg.norm((got - ref).astype(np.float64))
        assert err <= 1e-6 * max(np.linalg.norm(ref.astype(np.float64)), 1e-12), (k, err)


def test_multihost_still_refuses_rand_pose(tmp_path):
    from enerf_torch.config import build_config
    from enerf_torch.train.trainer import Trainer

    cfg = build_config(ARGS + ["--multihost", "1", "--outdir", str(tmp_path)])
    fake_mesh = types.SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="multihost.*folds each host"):
        Trainer(cfg, mesh=fake_mesh)
