"""CLI entry point of the port: `python -m enerf_torch --config FILE [flags]`.

Parses the same configs and flags as the JAX package's main.py (the
port's own config copy) and follows its flow, without the GUI and the
mesh: resume from `--ckpt` ('latest' by default, 'scratch' for none), train
for ceil(iters / steps_per_epoch) epochs with evaluation and checkpoints,
then render the test views; `--test` renders the test views only.
`--device cpu` runs the plain PyTorch path; the default is the CUDA device.

Example (synthetic event scene, the --ff -O path):
  python -m enerf_torch --config configs/synthetic_demo.txt --ff -O --iters 200
"""

import argparse
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
    trainer = Trainer(cfg, device=known.device, use_checkpoint=cfg.ckpt)
    train_provider, val_provider = make_providers(cfg, device=trainer.device)
    if cfg.test:
        trainer.test(val_provider)
        return
    max_epoch = int(np.ceil(cfg.iters / train_provider.steps_per_epoch))
    trainer.log(f"max epochs = {max_epoch}")
    trainer.train(train_provider, val_provider, max_epoch)
    trainer.test(val_provider)


if __name__ == "__main__":
    main(sys.argv[1:])
