"""The port's side of tests/test_torch_chunk_mesh.py: two gloo ranks on the CPU.

    python tests/torch_chunk_worker.py INPUTS.npz OUT_DIR

starts two ranks with enerf_torch.parallel.mesh.spawn; each runs the
data-parallel training window (train/chunk.py with a mesh) of every case
on its own batches and noise, which the test drew with the JAX package
(each rank the config's whole batch), and writes OUT_DIR/rank<r>.npz: the
params after the window, the window's mean scalars and, in frames mode,
the merged error map; then a Trainer on the tiny frames config with
`fuse_steps` 16 and 20 steps an epoch: its provider's batch, its step
count and (rank 0) its log.  This module imports no JAX.
"""

import datetime
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LR, ITERS, K = 5e-3, 1000, 2
N_EVENTS, N_FRAMES = 32, 48  # each rank's batch (the config's)
NUM_STEPS = 16
CASES = {
    "events_norm": dict(mode="events", step=dict(C_thres=-1.0, event_only=True, linlog=True,
                                                 w_opacity=0.01)),
    "frames": dict(mode="frames", step=dict(C_thres=0.2, event_only=False, linlog=False)),
}
FIELD = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=13,
             encoding="hashgrid")
GRID = dict(num_levels=4, level_dim=2, log2_hashmap_size=13, desired_resolution=64)
COMMON = dict(min_near=0.2, density_scale=1.0, use_luma=False, out_dim_color=1,
              num_steps=NUM_STEPS)
TRAINER_ARGS = ["--mode", "synthetic", "--H", "24", "--W", "24", "--syn_frames", "6",
                "--events", "0", "--num_rays", "64", "--num_steps", "8", "--num_levels", "2",
                "--error_map", "--log_every", "16"]


def step_statics(case):
    from enerf_torch.models.field import FieldStatic
    from enerf_torch.ops.hashgrid import HashGridMeta
    from enerf_torch.train.step import StepStatics
    st = FieldStatic(**FIELD)
    st.grid_meta = HashGridMeta(**GRID)
    return StepStatics(field_static=st, **COMMON, **CASES[case]["step"])


def _take(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in data.items()
            if k.startswith(prefix)}


def run_case(mesh, data, case, out):
    from enerf_torch.data.provider import FramesProvider
    from enerf_torch.train.chunk import make_train_chunk
    from enerf_torch.train.state import TrainState

    mode = CASES[case]["mode"]
    r = mesh.rank
    state = TrainState(_take(data, f"{case}/param/"), LR, ITERS)
    batches, noises = [], []
    for i in range(K):
        batch = _take(data, f"{case}/r{r}/s{i}/batch/")
        cells = None
        if mode == "frames":
            cells = (torch.from_numpy(data[f"{case}/r{r}/s{i}/fi"]).expand(N_FRAMES),
                     torch.from_numpy(data[f"{case}/r{r}/s{i}/ic"]))
        batches.append((batch, cells))
        noises.append(_take(data, f"{case}/r{r}/s{i}/noise/"))
    prov = None
    if mode == "frames":
        prov = FramesProvider(np.zeros((2, 8, 8, 1), np.float32), np.tile(np.eye(4), (2, 1, 1)),
                              (8.0, 8.0, 4.0, 4.0), num_rays=N_FRAMES, error_map=True)
        prov.error_map = torch.from_numpy(data[f"{case}/emap0"].copy())
    chunk = make_train_chunk(step_statics(case), mode, chunk_len=K, use_occ=False,
                             error_map=mode == "frames", mesh=mesh)
    _, aux = chunk(state, None, prov, batches=batches, noises=noises)
    assert state.step == K
    for k, p in state.params.items():
        out[f"{case}/param/{k}"] = p.detach().numpy()
    for k, v in aux.items():
        out[f"{case}/aux/{k}"] = v.numpy()
    if prov is not None:
        out[f"{case}/emap"] = prov.error_map.numpy()


def run_trainer(mesh, workspace, out):
    """The trainer's window under a mesh: the provider's batch is the
    config's, the epoch rounded down to whole windows."""
    from enerf_torch.config import build_config
    from enerf_torch.data.provider import make_providers
    from enerf_torch.train.trainer import Trainer
    cfg = build_config(TRAINER_ARGS + ["--outdir", workspace])
    trainer = Trainer(cfg, workspace=os.path.join(workspace, "ws"), mesh=mesh)
    train, _ = make_providers(cfg, device="cpu", shards=mesh.world_size)
    train.steps_per_epoch = 20
    before = train.error_map.clone()
    trainer.train(train, None, max_epoch=1)
    out["trainer/num_rays"] = np.asarray(train.num_rays)
    out["trainer/step"] = np.asarray(trainer.state.step)
    out["trainer/emap_changed"] = np.asarray(bool((train.error_map != before).any()))
    out["trainer/logged_steps"] = np.asarray([s for s, _ in trainer.history])
    if mesh.rank == 0:
        with open(trainer.log_path) as f:
            out["trainer/log"] = np.asarray(f.read())


def rank_main(mesh, inputs, out_dir):
    torch.set_num_threads(1)
    data = dict(np.load(inputs))
    out = {}
    for case in CASES:
        run_case(mesh, data, case, out)
    run_trainer(mesh, os.path.join(out_dir, "trainer"), out)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)


if __name__ == "__main__":
    from enerf_torch.parallel import mesh as dp
    dp.spawn(rank_main, ["cpu", "cpu"], args=(sys.argv[1], sys.argv[2]),
             timeout=datetime.timedelta(seconds=120))
