"""Kind "tumvie": a stereo rig's event camera, E-NeRF's real-data format
(see data.py).  Only the train split: the train windows' events and the
keyframe poses."""

import numpy as np

from benchmark import data as helpers


def make(data, cfg, rng, split="train"):
    if split != "train":
        raise ValueError(f"tumvie inputs have no {split!r} split")
    cam = data["event_camera"]
    W, H = cam["W"], cam["H"]
    train = np.asarray(cfg["train_idxs"])
    stamps_us = train / data["image_rate_hz"] * 1e6
    centers = helpers.window_centers(stamps_us)
    total = centers[-1] - centers[0]
    shrink = max(total - data["max_window_s"] * 1e6, 0.0) / (2 * len(train))
    F = len(train)
    per_window = np.full(F, data["num_events"] // F, np.int64)
    per_window[: data["num_events"] % F] += 1
    k1 = data["rectify_k1"]
    events, fids = [], []
    for i in range(F):
        t0, t1 = centers[i] + shrink, centers[i + 1] - shrink
        n, P = int(per_window[i]), data["active_pixels_per_window"]
        flat = rng.choice(H * W, size=P, replace=False)
        px, py = (flat % W).astype(np.float64), (flat // W).astype(np.float64)
        # the rectify map: a smooth radial shift to fractional coordinates
        rx, ry = (px - cam["cx"]) / cam["fx"], (py - cam["cy"]) / cam["fy"]
        g = 1.0 + k1 * (rx * rx + ry * ry)
        ux = np.clip(cam["cx"] + (px - cam["cx"]) * g, 0.0, W - 1e-3)
        uy = np.clip(cam["cy"] + (py - cam["cy"]) * g, 0.0, H - 1e-3)
        weight = rng.pareto(data["pixel_skew"], P) + 1.0
        pix = rng.choice(P, size=n, p=weight / weight.sum())
        t = np.sort(rng.uniform(t0, t1, n)) * 1000.0  # us -> ns
        ev = np.empty((n, 4))
        ev[:, 0], ev[:, 1], ev[:, 2] = ux[pix], uy[pix], t
        ev[:, 3] = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        events.append(ev)
        fids.append(np.full(n, i, np.int64))
    hf_ts_s = np.arange(0.0, data["duration_s"], 1.0 / data["pose_rate_hz"])
    hf_poses = helpers.arc_poses(hf_ts_s, data["trajectory"], cfg["scale"], rng)
    fc = data["frame_camera"]
    return {"events": np.concatenate(events), "event_frame_ids": np.concatenate(fids),
            "n_frames": F, "hf_ts": hf_ts_s * 1e9, "hf_poses": hf_poses,
            "intrinsics_evs": (cam["fx"], cam["fy"], cam["cx"], cam["cy"]),
            "intrinsics": (fc["fx"], fc["fy"], fc["cx"], fc["cy"]), "H_ev": H, "W_ev": W}
