"""Offline renderer of a trained workspace.

    python -m enerf_torch.tools.render --model_dir WORKSPACE [--infile poses.txt]
        [--traj spiral|val] [--n_poses 60] [--H H --W W] [--fovy DEG]
        [--outdir DIR] [--ckpt latest] [--device cuda|cpu]

Counterpart of scripts/render.py (reference scripts/render.py): re-reads
the config snapshot the workspace holds (args.json), loads its checkpoint
(read-only: args.json stays as training wrote it), builds the poses from a
quaternion list (`--infile`, rows ts px py pz qx qy qz qw after one header
line), a spiral around (0, 0, -2) or the synthetic orbit (`--traj val`),
renders each with the EMA weights and writes <i>.png, <i>_depth.png and
<i>_raw.npy into --outdir (default <model_dir>/renders).  The default
device is the card.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def load_quatlist_poses(path):
    """Rows [ts, px, py, pz, qx, qy, qz, qw] after one header line ->
    [N, 4, 4] c2w."""
    from scipy.spatial.transform import Rotation as R
    from enerf_torch.data.poses import get_hom_trafos

    q = np.loadtxt(path, skiprows=1)
    if q.ndim == 1:
        q = q[None]
    return get_hom_trafos(R.from_quat(q[:, 4:8]).as_matrix(), q[:, 1:4])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_dir", required=True, help="trained workspace")
    ap.add_argument("--infile", default=None, help="quatlist txt of poses")
    ap.add_argument("--traj", default="spiral", choices=["spiral", "val"])
    ap.add_argument("--n_poses", type=int, default=60)
    ap.add_argument("--H", type=int, default=None)
    ap.add_argument("--W", type=int, default=None)
    ap.add_argument("--fovy", type=float, default=None)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--ckpt", default="latest")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    from enerf_torch.config import Config
    from enerf_torch.data import synthetic
    from enerf_torch.data.poses import spiral_path
    from enerf_torch.train.trainer import Trainer
    from enerf_torch.utils.png import write_png

    with open(os.path.join(args.model_dir, "args.json")) as f:
        cfg_dict = json.load(f)
    cfg_dict["render_mode"] = 1
    names = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in cfg_dict.items() if k in names})
    trainer = Trainer(cfg, device=args.device, workspace=args.model_dir,
                      use_checkpoint=args.ckpt, snapshot=False)

    H, W = args.H or cfg.H, args.W or cfg.W
    intr = synthetic.default_intrinsics(H, W, args.fovy or cfg.fovy)
    if args.infile:
        poses = load_quatlist_poses(args.infile)
    elif args.traj == "spiral":
        center = np.eye(4)
        center[:3, 3] = [0, 0, -2.0]
        poses = spiral_path(center, [0.8, 0.8, 0.3], 2.0, args.n_poses)
    else:
        poses = np.stack([synthetic.circle_pose(t) for t in np.linspace(0, 1, args.n_poses)])

    outdir = args.outdir or os.path.join(args.model_dir, "renders")
    os.makedirs(outdir, exist_ok=True)
    for i, pose in enumerate(poses):
        img, depth = trainer.render_view(pose, intr, H, W)
        write_png(os.path.join(outdir, f"{i:04d}.png"), (np.clip(img, 0, 1) * 255).astype(np.uint8))
        write_png(os.path.join(outdir, f"{i:04d}_depth.png"),
                  (np.clip(depth, 0, 1) * 255).astype(np.uint8))
        np.save(os.path.join(outdir, f"{i:04d}_raw.npy"), img)
        print(f"rendered {i + 1}/{len(poses)}", flush=True)
    print(f"wrote {len(poses)} renders to {outdir}")
    return outdir


if __name__ == "__main__":
    main(sys.argv[1:])
