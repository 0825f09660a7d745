"""CLI entry point of the port: `python -m enerf_torch --config FILE [flags]`.

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

Examples (the synthetic event scene on the --ff -O path; a published esim
config on a dataset directory):
  python -m enerf_torch --config configs/synthetic_demo.txt --ff -O --iters 200
  python -m enerf_torch --config configs/spiral1/spiral1_nerf.txt --datadir DATA/spiral1 \
      --outdir output
  python -m enerf_torch --config configs/synthetic_demo.txt --ff -O --gui
"""

import argparse
import sys

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
    from enerf_torch.data.provider import make_providers
    from enerf_torch.train.trainer import Trainer

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    cfg = build_config(rest)
    select_frames = get_select_frames(cfg)
    trainer = Trainer(cfg, device=known.device, use_checkpoint=cfg.ckpt)
    train_provider, val_provider = make_providers(cfg, select_frames, device=trainer.device)
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


if __name__ == "__main__":
    main(sys.argv[1:])
