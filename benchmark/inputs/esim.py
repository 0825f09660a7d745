"""Kind "esim": a simulated sequence's grey frames and their poses on a
spiral (see data.py); split "train" or "val" takes the config's
`train_idxs` or `val_idxs`."""

import numpy as np

from benchmark import data as helpers


def make(data, cfg, rng, split="train"):
    cam = data["camera"]
    idx = np.asarray(cfg["train_idxs" if split == "train" else "val_idxs"])
    poses = helpers.spiral_poses(data["n_frames"], data["trajectory"], cfg["scale"])[idx]
    images = helpers.smooth_frames(len(idx), cam["H"], cam["W"], cfg["out_dim_color"],
                                   data["image_cells"], rng)
    return {"images": images, "poses": poses,
            "intrinsics": (cam["fx"], cam["fy"], cam["cx"], cam["cy"])}
