"""The port's command line: `python -m enerf_torch --config FILE [flags]`.

Parses the same configs and flags as the JAX package's main.py (the
port's own config copy) and follows its flow (main.py:87-106): the frame
selection of the config (`get_select_frames`), resume from `--ckpt`
('latest' by default, 'scratch' for none), train for
ceil(iters / steps_per_epoch) epochs with evaluation and checkpoints, then
render the test views and export the mesh (256^3, threshold 10);
`--test` renders the test views and exports the mesh only; `--gui` serves
the web viewer on http://127.0.0.1:7007 instead (training between frames
unless `--test`).  `--device cpu` runs the plain PyTorch path; the default
is the CUDA device.

Data parallelism (main.py:73-84), train, test and mesh on every rank, the
files written by rank 0:
  - `--mesh_shape N` (the product of the list) starts N ranks on this host
    with torch.multiprocessing (spawn), on cuda:0..N-1 over NCCL, or with
    `--device cpu` on the CPU over gloo.  With `--fuse_steps 1` the
    config's batch is the global batch: each rank samples 1/N of it.  With
    the default fuse_steps (16) the ranks train in windows, as JAX's chunk
    does: each rank samples the config's batch and normalizes its loss over
    it, and an epoch is rounded down to whole windows.  More ranks than
    cards raises; two ranks never share a card here.
  - `--multihost 1` joins the job torchrun started, one rank per process
    on cuda:LOCAL_RANK (or the CPU): each rank samples the config's batch,
    so the global batch is their sum.  Without torchrun's environment it
    raises.
The ranks are started through this module, not __main__, because spawned
processes import the function they run by its module's name.

Examples (the synthetic event scene on the --ff -O path; a published esim
config on a dataset directory):
  python -m enerf_torch --config configs/synthetic_demo.txt --ff -O --iters 200
  python -m enerf_torch --config configs/spiral1/spiral1_nerf.txt --datadir DATA/spiral1 \
      --outdir output
  python -m enerf_torch --config configs/synthetic_demo.txt --ff -O --gui
  python -m enerf_torch --config configs/synthetic_demo.txt --ff -O --mesh_shape 2
  python -m torch.distributed.run --nproc_per_node 2 -m enerf_torch \
      --config configs/synthetic_demo.txt --ff -O --multihost 1
"""

import argparse

import numpy as np


def get_select_frames(cfg):
    """The config's train / val / test frame indices (reference
    main_nerf.py:14-42, the JAX package's main.py): each strictly
    increasing and unique, test_idxs [0] by default, and exclude_idxs
    removed from all three."""
    sf = {"train_idxs": cfg.train_idxs, "val_idxs": cfg.val_idxs,
          "test_idxs": cfg.test_idxs or [0], "exclude_idxs": cfg.exclude_idxs}
    for k in ("train_idxs", "val_idxs", "test_idxs"):
        if sf[k] is not None:
            if not np.all(np.diff(sf[k]) > 0):
                raise ValueError(f"{k} must be strictly increasing: {sf[k]}")
            if len(np.unique(sf[k])) != len(sf[k]):
                raise ValueError(f"{k} must be unique: {sf[k]}")
    if sf["exclude_idxs"]:
        ex = set(sf["exclude_idxs"])
        for k in ("train_idxs", "val_idxs", "test_idxs"):
            if sf[k] is not None:
                sf[k] = [i for i in sf[k] if i not in ex]
    return sf


def main(argv=None):
    from enerf_torch.config import build_config

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    cfg = build_config(rest)
    if not (cfg.multihost or cfg.mesh_shape):
        run(cfg, known.device)
        return
    if cfg.gui:
        raise ValueError("--gui serves one process's viewer; run it without --mesh_shape "
                         "or --multihost")
    import torch
    from enerf_torch.parallel import mesh as dp, multihost

    cpu = known.device is not None and torch.device(known.device).type == "cpu"
    if cfg.multihost:
        multihost.initialize(backend="gloo" if cpu else "nccl")
        try:  # the CPU under gloo, cuda:LOCAL_RANK under NCCL
            run(cfg, mesh=dp.make_mesh())
        finally:
            torch.distributed.destroy_process_group()
        return
    n = int(np.prod(cfg.mesh_shape))
    if not cpu and n > torch.cuda.device_count():
        raise RuntimeError(f"--mesh_shape {cfg.mesh_shape} asks for {n} ranks, one card each, "
                           f"and this host has {torch.cuda.device_count()} CUDA devices")
    dp.spawn(run_rank, ["cpu"] * n if cpu else [f"cuda:{i}" for i in range(n)], args=(cfg,))


def run_rank(mesh, cfg):
    """One rank of --mesh_shape (the provider's batch: make_providers)."""
    run(cfg, mesh=mesh, shards=mesh.world_size)


def run(cfg, device=None, mesh=None, shards=1):
    """main.py's flow on this process (a rank of `mesh`, if any): the GUI,
    or --test, or train then test and the mesh."""
    from enerf_torch.data.provider import make_providers
    from enerf_torch.train.trainer import Trainer

    select_frames = get_select_frames(cfg)
    trainer = Trainer(cfg, device=device, use_checkpoint=cfg.ckpt, mesh=mesh)
    train_provider, val_provider = make_providers(cfg, select_frames, device=trainer.device,
                                                  shards=shards)
    if cfg.gui:
        from enerf_torch.viewer import GUIRenderer, serve_web_viewer
        gui = GUIRenderer(trainer, provider=None if cfg.test else train_provider,
                          W=cfg.W, H=cfg.H, radius=cfg.radius, fovy=cfg.fovy,
                          max_spp=cfg.max_spp)
        serve_web_viewer(gui)
        return
    if cfg.test:
        trainer.test(val_provider)
        trainer.save_mesh(resolution=256, threshold=10.0)
        return
    max_epoch = int(np.ceil(cfg.iters / train_provider.steps_per_epoch))
    trainer.log(f"max epochs = {max_epoch}")
    trainer.train(train_provider, val_provider, max_epoch)
    trainer.test(val_provider)
    trainer.save_mesh(resolution=256, threshold=10.0)
