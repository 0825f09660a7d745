"""The port's side of tests/test_torch_rand_pose_mesh.py: two gloo ranks on
the CPU.

    python tests/torch_rand_pose_worker.py OUT_DIR

starts two ranks with enerf_torch.parallel.mesh.spawn.  Each builds the
tiny frames-mode rand-pose config's Trainer on its rank of the mesh and its
provider (make_providers with the mesh's shards), takes one data-parallel
frame step and then the rand-pose CLIP step, checks the ranks bit-equal
(`assert_replicated`, as every epoch's end does) and writes
OUT_DIR/rank<r>.npz: the replicated tensors before and after the CLIP
step, the shared generator's state and the provider's batch count before
it, and the step's loss_clip.  This module imports no JAX.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ARGS = ["--mode", "synthetic", "--H", "24", "--W", "24", "--syn_frames", "6", "--events", "0",
        "--num_rays", "128", "--num_steps", "8", "--num_levels", "2", "--rand_pose", "1",
        "--clip_text", "a ball", "--expname", "rand_pose", "--log_every", "1"]


def snapshot(trainer):
    from enerf_torch.parallel import mesh as dp
    return {k: v.detach().cpu().numpy().copy()
            for k, v in dp.replicated_tensors(trainer.state).items()}


def rank_main(mesh, outdir):
    from enerf_torch.config import build_config
    from enerf_torch.data.provider import make_providers
    from enerf_torch.parallel import mesh as dp
    from enerf_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    cfg = build_config(ARGS + ["--mesh_shape", "2", "--outdir", outdir])
    trainer = Trainer(cfg, mesh=mesh)
    provider, _ = make_providers(cfg, device=trainer.device, shards=mesh.world_size)
    aux = trainer.train_step(provider)  # batch 1: frame rays, this rank's half
    assert "loss_clip" not in aux
    before = snapshot(trainer)
    gen_state = trainer.generator.get_state().numpy().copy()
    batch_i, step = provider._batch_i, trainer.state.step
    aux = trainer.train_step(provider)  # batch 2: the rand pose, every rank alike
    assert "loss_clip" in aux, sorted(aux)
    dp.assert_replicated(trainer.state, None, mesh)
    after = snapshot(trainer)
    np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"),
             gen_state=gen_state, batch_i=batch_i, step=step,
             loss_clip=float(aux["loss_clip"]), rays=provider.num_rays,
             **{"before/" + k: v for k, v in before.items()},
             **{"after/" + k: v for k, v in after.items()})


if __name__ == "__main__":
    from enerf_torch.parallel import mesh as dp
    dp.spawn(rank_main, ["cpu", "cpu"], args=(sys.argv[1],))
