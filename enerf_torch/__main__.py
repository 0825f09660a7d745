"""CLI entry point of the port: `python -m enerf_torch --config FILE [flags]`.

Parses the same configs and flags as the JAX package's main.py (the
port's own config copy); `--device cpu` runs the plain PyTorch path, the
default is the CUDA device.  Trains for `iters` steps, then renders the
first validation view through the inference renderer.

Example (synthetic event scene, the --ff -O path):
  python -m enerf_torch --config configs/synthetic_demo.txt --ff -O --iters 200
"""

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    from enerf_torch.config import build_config
    from enerf_torch.data.provider import make_providers
    from enerf_torch.train.trainer import Trainer

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    cfg = build_config(rest)
    trainer = Trainer(cfg, device=known.device)
    train_provider, val_provider = make_providers(cfg, device=trainer.device)
    max_epoch = int(np.ceil(cfg.iters / train_provider.steps_per_epoch))
    trainer.log(f"max epochs = {max_epoch}")
    trainer.train(train_provider, max_epoch)
    views = val_provider.val_views()
    if views:
        v = views[0]
        img, _ = trainer.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
        path = os.path.join(trainer.workspace, "val0000.npy")
        np.save(path, img)
        trainer.log(f"[render] val view 0 mean {float(img.mean()):.5f} -> {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
