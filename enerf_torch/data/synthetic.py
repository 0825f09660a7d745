"""Synthetic scene + ESIM-style event simulator for tests and benchmarks.

The port's own copy of enerf_tpu/data/synthetic.py (numpy only), without
the JAX package's on-disk cache.

The reference ships no data and no tests; this module provides a fully
deterministic stand-in: an analytic emission-absorption scene (soft Gaussian
blobs), ground-truth volume rendering of it, smooth camera trajectories, and
an event-camera simulation (per-pixel log-intensity threshold crossings, the
ESIM generation model the reference's esim datasets were produced with —
readme.md:80, utils/event_utils.py linlog convention).

Everything is numpy, host-side, cheap at test sizes.
"""

import numpy as np


# ----------------------------------------------------------------------------
# analytic scene


def scene_density_color(x, rich=False):
    """Analytic field: x [N, 3] -> (sigma [N], rgb [N, 3]).

    Three Gaussian blobs of distinct brightness/colour inside |x| < 1.
    `rich` levels (int):
      1: a ring of small high-contrast blobs (sharper edges -> denser
         event streams);
      2: additionally TEXTURED — a high-frequency multiplicative albedo
         pattern on all geometry plus a textured floor slab.  Smooth
         untextured blobs only emit events at silhouettes, leaving
         interior brightness unconstrained by event supervision (the
         mist-mode quality analysis, ROUND2_STATUS.md); the reference's
         real esim scenes are textured rooms where events cover most
         pixels, which level 2 emulates.
    """
    rich = int(rich)
    blobs = [
        (np.array([0.3, 0.0, 0.0]), 0.22, 40.0, np.array([0.9, 0.2, 0.2])),
        (np.array([-0.25, 0.3, 0.1]), 0.18, 35.0, np.array([0.2, 0.85, 0.3])),
        (np.array([0.0, -0.3, -0.2]), 0.2, 30.0, np.array([0.25, 0.35, 0.95])),
    ]
    if rich >= 1:
        rng = np.random.default_rng(7)
        for k in range(12):
            ang = 2 * np.pi * k / 12
            c = np.array([0.55 * np.cos(ang), 0.55 * np.sin(ang),
                          0.35 * np.sin(2 * ang)])
            col = rng.uniform(0.05, 1.0, 3)
            blobs.append((c, 0.07, 120.0, col))
    sigma = np.zeros(x.shape[0])
    rgb_acc = np.zeros((x.shape[0], 3))
    for c, r, amp, col in blobs:
        d2 = np.sum((x - c) ** 2, axis=-1)
        w = amp * np.exp(-d2 / (2 * r * r))
        sigma += w
        rgb_acc += w[:, None] * col
    if rich >= 2:
        # opaque floor slab at z < -0.75 with a checker albedo
        floor = 200.0 / (1.0 + np.exp((x[:, 2] + 0.75) / 0.01))
        checker = 0.25 + 0.6 * (
            (np.floor(x[:, 0] * 4) + np.floor(x[:, 1] * 4)) % 2)
        sigma = sigma + floor
        rgb_acc = rgb_acc + floor[:, None] * checker[:, None] * np.ones(3)
    rgb = rgb_acc / np.maximum(sigma[:, None], 1e-9)
    if rich >= 2:
        # multiplicative high-frequency albedo texture on everything
        tex = (0.6 + 0.4 * np.sin(9.3 * np.pi * x[:, 0])
               * np.sin(8.1 * np.pi * x[:, 1])
               * np.sin(7.2 * np.pi * x[:, 2]))
        rgb = rgb * tex[:, None]
    rgb = np.where(sigma[:, None] > 1e-6, rgb, 1.0)
    return np.clip(sigma, 0.0, None), np.clip(rgb, 0.0, 1.0)


def render_gt(pose, intrinsics, H, W, n_steps=192, bound=1.0, bg=1.0,
              grayscale=False, with_alpha=False, rich=False):
    """Ground-truth render of the analytic scene (fine fixed-step march).

    with_alpha: append the accumulated opacity as a 4th (or 2nd) channel so
    training can composite GT against the same random background as the
    prediction (the reference's C==4 branch, utils.py:595-598).
    """
    fx, fy, cx, cy = intrinsics
    j, i = np.meshgrid(np.arange(H, dtype=np.float64),
                       np.arange(W, dtype=np.float64), indexing="ij")
    dirs = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rd = dirs.reshape(-1, 3) @ pose[:3, :3].T
    ro = np.broadcast_to(pose[:3, 3], rd.shape)

    # slab near/far
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (-bound - ro) / rd
        t1 = (bound - ro) / rd
    tmin = np.minimum(t0, t1).max(-1)
    tmax = np.maximum(t0, t1).min(-1)
    tmin = np.clip(tmin, 0.05, None)
    hit = tmax > tmin

    N = rd.shape[0]
    img = np.ones((N, 3)) * bg
    acc = np.zeros(N)
    if hit.any():
        tn, tf = tmin[hit], tmax[hit]
        ts = tn[:, None] + (tf - tn)[:, None] * (np.arange(n_steps) + 0.5)[None] / n_steps
        dt = (tf - tn)[:, None] / n_steps
        pts = ro[hit, None, :] + rd[hit, None, :] * ts[..., None]
        sig, rgb = scene_density_color(pts.reshape(-1, 3), rich=rich)
        sig = sig.reshape(-1, n_steps)
        rgb = rgb.reshape(-1, n_steps, 3)
        alpha = 1.0 - np.exp(-sig * dt)
        trans = np.cumprod(1.0 - alpha + 1e-15, axis=-1) / (1.0 - alpha + 1e-15)
        w = alpha * trans
        img[hit] = (w[..., None] * rgb).sum(1) + (1 - w.sum(1))[:, None] * bg
        acc[hit] = w.sum(1)
    img = img.reshape(H, W, 3)
    acc = acc.reshape(H, W, 1)
    if grayscale:
        img = (img @ np.array([0.299, 0.587, 0.114]))[..., None]
    if with_alpha:
        # foreground pre-divided out of the bg mix so gt = fg*a + bg'*(1-a)
        fg = np.where(acc > 1e-6, (img - (1 - acc) * bg) / np.maximum(acc, 1e-6), img)
        img = np.concatenate([np.clip(fg, 0, 1), acc], axis=-1)
    return img.astype(np.float32)


# ----------------------------------------------------------------------------
# cameras


def look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)):
    """c2w pose with camera axes right-down-forward (the get_rays convention)."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r /= np.linalg.norm(r)
    d = np.cross(f, r)  # down: right x down = forward (right-handed)
    d /= np.linalg.norm(d)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, d, f, eye
    return pose


def circle_pose(t, radius=2.5, height=0.8, turns=1.0):
    """Smooth orbit trajectory; t in [0, 1]."""
    ang = 2.0 * np.pi * turns * t
    eye = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
    return look_at_pose(eye)


def default_intrinsics(H, W, fovy_deg=60.0):
    fy = H / (2.0 * np.tan(np.radians(fovy_deg) / 2.0))
    fx = fy
    return (fx, fy, W / 2.0, H / 2.0)


# ----------------------------------------------------------------------------
# event simulation (ESIM generation model)


def _lin_log(x, thres=20.0):
    slope = np.log(thres) / thres
    return np.where(x < thres, slope * x, np.log(np.maximum(x, 1e-20)))


def simulate_events(H=64, W=64, n_frames=40, C=0.2, radius=2.5, height=0.8,
                    turns=0.5, fovy_deg=60.0, seed=0, rich=False):
    """Simulate an event stream from the orbiting camera.

    Returns dict with:
      events: [M, 4] array (x, y, t, pol) float64, t in [0, 1], pol +-1
      frames: [n_frames, H, W, 1] grayscale intensity images in [0, 1]
      frame_ts: [n_frames] times
      poses: [n_frames, 4, 4] c2w at frame times
      intrinsics: (fx, fy, cx, cy)
      pose_fn: callable t -> 4x4 c2w (the continuous trajectory)
      C: contrast threshold used

    Deterministic in its arguments (the same data as enerf_tpu's simulator;
    this copy keeps no disk cache).
    """
    intr = default_intrinsics(H, W, fovy_deg)
    ts = np.linspace(0.0, 1.0, n_frames)
    poses = np.stack([circle_pose(t, radius, height, turns) for t in ts])
    frames = np.stack(
        [render_gt(circle_pose(t, radius, height, turns), intr, H, W,
                   grayscale=True, rich=rich) for t in ts]
    )

    # per-pixel linlog intensity over time
    ll = _lin_log(frames[..., 0] * 255.0)  # [F, H, W]

    events = []
    ref = ll[0].copy()
    for f in range(1, n_frames):
        prev_t, cur_t = ts[f - 1], ts[f]
        cur = ll[f]
        # emit events while the intensity has moved >= C from the reference
        diff = cur - ref
        n_cross = np.floor(np.abs(diff) / C).astype(np.int64)
        max_n = int(n_cross.max()) if n_cross.size else 0
        for k in range(1, max_n + 1):
            mask = n_cross >= k
            ys, xs = np.nonzero(mask)
            pol = np.sign(diff[mask])
            # linear interpolation of the crossing time within the frame gap
            frac = np.clip(k * C / np.maximum(np.abs(diff[mask]), 1e-12), 0, 1)
            t_ev = prev_t + frac * (cur_t - prev_t)
            events.append(
                np.stack([xs.astype(np.float64), ys.astype(np.float64), t_ev, pol], -1)
            )
        ref = ref + np.sign(diff) * n_cross * C

    if events:
        ev = np.concatenate(events, 0)
        ev = ev[np.argsort(ev[:, 2], kind="stable")]
    else:
        ev = np.zeros((0, 4))

    def pose_fn(t):
        return circle_pose(t, radius, height, turns)

    return {
        "events": ev,
        "frames": frames,
        "frame_ts": ts,
        "poses": poses,
        "intrinsics": intr,
        "pose_fn": pose_fn,
        "C": C,
        "H": H,
        "W": W,
    }
