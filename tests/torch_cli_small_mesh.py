"""`python -m enerf_torch ARGS` with the closing 256^3 mesh export cut to
16^3 (on the CPU the 256^3 density query alone takes ~50 s):

    python tests/torch_cli_small_mesh.py ARGS
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_cli_small_mesh.py ARGS --multihost 1

The cut is made when this file is imported, so it holds in the ranks that
--mesh_shape spawns too: they import the parent's main script again.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from enerf_torch.train.trainer import Trainer  # noqa: E402

_save_mesh = Trainer.save_mesh


def _small_mesh(self, path=None, resolution=256, threshold=10.0):
    return _save_mesh(self, path, resolution=16, threshold=threshold)


Trainer.save_mesh = _small_mesh

if __name__ == "__main__":
    from enerf_torch.cli import main
    main(sys.argv[1:])
