"""Plain reference of a training step's batch, worked out again from the
generated inputs (events, keyframe poses, frames) and the step's random
draws.

The draws are the trainer's: one CUDA torch.Generator seeded with the
run's seed + 1, drawn from in the order the published collate draws
(torch-ngp / E-NeRF provider.py:1363-1499, utils.py:482-604), so that a
generator of the same seed on the same device gives the same numbers.
An event batch: the window (randint over the windows), a pixel group
(randint(0, 2^62) modulo the window's group count), the event inside the
group (u (count - 1), truncated), its successor; then the step's noise, a
background [1, C] and each render's jitter [N, num_steps].  A frame batch:
the frame, num_rays pixels (randint over H x W); then a background [N, C]
and the jitter.

Event chains (provider.py:1146-1219): events grouped per (window, pixel),
the pixel trunc(y_f32) * W + trunc(x_f32) with W = trunc(max x) + 2,
sorted by time inside a group (ties in index order), groups of fewer than
two events dropped.  Poses at event times: Slerp rotations and cubic
translations over the keyframes (pose_utils.py:138-160), in float64, kept
as float32.
"""

import numpy as np
import torch
from scipy.interpolate import interp1d
from scipy.spatial.transform import Rotation, Slerp


class Chains:
    """The per-(window, pixel) event chains, numpy, with the window bounds
    into the group table."""

    def __init__(self, events, frame_ids, n_frames):
        ev = np.asarray(events, np.float64)
        W = int(ev[:, 0].max()) + 2
        pix = (ev[:, 1].astype(np.float32).astype(np.int64) * W
               + ev[:, 0].astype(np.float32).astype(np.int64))
        fid = np.asarray(frame_ids, np.int64)
        order = np.lexsort((ev[:, 2], pix, fid))
        key_p, key_f = pix[order], fid[order]
        start = np.ones(len(order), bool)
        start[1:] = (key_p[1:] != key_p[:-1]) | (key_f[1:] != key_f[:-1])
        gid = np.cumsum(start) - 1
        counts = np.bincount(gid)
        keep = counts[gid] >= 2
        sel = order[keep]
        kept_counts = counts[counts >= 2]
        offsets = np.concatenate([[0], np.cumsum(kept_counts)[:-1]]).astype(np.int64)
        group_frame = fid[sel][offsets]
        f = np.arange(n_frames)
        lo = np.searchsorted(group_frame, f, "left")
        hi = np.searchsorted(group_frame, f, "right")
        self.bounds = np.stack([np.where(hi > lo, lo, 0), np.where(hi > lo, hi, 0)], 1)
        self.xs = ev[sel, 0].astype(np.float32)
        self.ys = ev[sel, 1].astype(np.float32)
        self.ts = ev[sel, 2]
        self.pols = ev[sel, 3].astype(np.float32)
        self.counts = kept_counts.astype(np.int64)
        self.offsets = offsets


def pose_interpolator(key_ts, key_poses):
    """Query times -> [N, 3, 4] float32 poses (Slerp + cubic translations)."""
    key_ts = np.asarray(key_ts, np.float64)
    key_poses = np.asarray(key_poses, np.float64)
    rot = Slerp(key_ts, Rotation.from_matrix(key_poses[:, :3, :3]))
    trans = interp1d(key_ts, key_poses[:, :3, 3], axis=0,
                     kind="cubic" if len(key_ts) >= 4 else "linear")

    def query(t):
        t = np.clip(np.asarray(t, np.float64), key_ts[0], key_ts[-1])
        out = np.zeros((len(t), 3, 4), np.float32)
        out[:, :, :3] = rot(t).as_matrix()
        out[:, :, 3] = trans(t)
        return out

    return query


def pixel_dirs(xs, ys, intrinsics):
    fx, fy, cx, cy = intrinsics
    d = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], -1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def event_batch(chains, poses_at, intrinsics_evs, n_frames, batch, gen, device):
    """One event batch from the generator -> dict(o1, d1, o2, d2 [B, 3],
    pols [B])."""
    frame = torch.randint(0, n_frames, (1,), device=device, generator=gen)
    bounds = torch.as_tensor(chains.bounds, device=device)
    lo, hi = bounds.index_select(0, frame)[0]
    r = torch.randint(0, 2 ** 62, (batch,), device=device, generator=gen) % (hi - lo).clamp(min=1)
    u = torch.rand(batch, device=device, generator=gen)
    counts = torch.as_tensor(chains.counts, device=device)
    offsets = torch.as_tensor(chains.offsets, device=device)
    g = (lo + r).clamp(0, counts.shape[0] - 1)
    k = (u * (counts[g] - 1).float()).to(torch.int64)
    i0 = (offsets[g] + k).clamp(0, chains.xs.shape[0] - 2).cpu().numpy()
    i1 = i0 + 1
    xs = torch.as_tensor(chains.xs[i0], device=device)
    ys = torch.as_tensor(chains.ys[i0], device=device)
    dirs = pixel_dirs(xs, ys, intrinsics_evs)
    out = {"pols": torch.as_tensor(chains.pols[i1], device=device)}
    for name, idx in (("1", i0), ("2", i1)):
        pose = torch.as_tensor(poses_at(chains.ts[idx]), device=device)
        out["o" + name] = pose[:, :, 3]
        out["d" + name] = (pose[:, :, :3] * dirs[:, None, :]).sum(-1)
    return out


def frame_batch(images, poses, intrinsics, H, W, n_rays, gen, device):
    """One frame batch: images [F, H*W, C], poses [F, 4, 4] on `device` ->
    dict(o, d [N, 3], gt [N, C])."""
    fi = torch.randint(0, images.shape[0], (1,), device=device, generator=gen)
    inds = torch.randint(0, H * W, (n_rays,), device=device, generator=gen)
    pose = poses.index_select(0, fi)[0]
    i = (inds % W).float()
    j = torch.div(inds, W, rounding_mode="floor").float()
    d = pixel_dirs(i, j, intrinsics) @ pose[:3, :3].T
    return {"o": pose[:3, 3].expand_as(d), "d": d, "gt": images.index_select(0, fi)[0][inds]}
