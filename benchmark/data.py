"""The benchmark's inputs, made from the run's seed (numpy only).

The seed changes the data and not its sizes: every seed gives the same
number of events in each window, frames of the same size and the same
number of poses.  `make_inputs(data, cfg, seed)` returns what a dataset
loader would hand the providers, in the loaders' conventions (poses as
[K, 4, 4] camera-to-world matrices in the instant-ngp frame, columns right,
down, forward, position, already at the config's `scale`; event times in
ns; polarities +-1).  A configuration's `data.kind` names the module of
inputs/ that makes them (`make(data, cfg, rng, split)`), from the helpers
here; a new kind of dataset is a new file there.  The first two:

  - kind "tumvie" (a stereo rig's event camera, E-NeRF's real-data format):
    the image stamps at `image_rate_hz`; the train windows centred between
    the train images' stamps and shrunk when they span more than
    `max_window_s` (the TUM-VIE loader's rule); in each window a set of
    active sensor pixels, each sent through a smooth radial rectify map to
    fractional coordinates, and `num_events` events in all, spread over the
    windows evenly and over each window's pixels by skewed weights, with
    sorted times and both polarities; keyframe poses at `pose_rate_hz` on a
    hand-held arc around the scene, looking into the box;
  - kind "esim" (a simulated sequence): `n_frames` grey frames of smooth
    random texture and their poses on a spiral around the scene.
"""

import numpy as np

from benchmark import named


def seed_sequence(seed, stream):
    return np.random.SeedSequence([int(seed) & (2 ** 63 - 1), int(seed) >> 63, int(stream)])


def look_at(eye, target):
    """[4, 4] camera-to-world with columns right, down, forward, eye."""
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    right = np.cross(f, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(f, right)
    out = np.eye(4)
    out[:3, 0], out[:3, 1], out[:3, 2], out[:3, 3] = right, down, f, eye
    return out


def window_centers(stamps_us):
    """The TUM-VIE loader's window bounds between image stamps."""
    dT = np.diff(stamps_us).mean()
    c = np.insert(stamps_us, 0, stamps_us[0] - 2 * dT)
    c = np.append(c, c[-1] + 2 * dT)
    return c[:-1] + np.diff(c) / 2.0


def arc_poses(ts, traj, scale, rng):
    """Hand-held arc: the camera at `radius_m` from `target_m`, `height_m`
    up, sweeping `arc_deg` over the sequence, with a slow wobble."""
    span = ts[-1] - ts[0]
    phase = rng.uniform(0, 2 * np.pi, 6)
    target = np.asarray(traj["target_m"], np.float64)
    out = []
    for t in ts:
        s = (t - ts[0]) / span
        ang = np.radians(traj["start_deg"] + traj["arc_deg"] * s)
        wob = traj["wobble_m"] * np.sin(2 * np.pi * 0.3 * t + phase[:3])
        eye = target + np.array([traj["radius_m"] * np.cos(ang), traj["radius_m"] * np.sin(ang),
                                 traj["height_m"]]) + wob
        look = target + traj["wobble_m"] * np.sin(2 * np.pi * 0.2 * t + phase[3:])
        p = look_at(eye * scale, look * scale)
        out.append(p)
    return np.stack(out)


def spiral_poses(n, traj, scale):
    """`n` poses on a spiral around `target_m` looking at it."""
    target = np.asarray(traj["target_m"], np.float64)
    out = []
    for i in range(n):
        s = i / max(n - 1, 1)
        ang = 2 * np.pi * traj["turns"] * s
        h0, h1 = traj["height_m"]
        eye = target + np.array([traj["radius_m"] * np.cos(ang), traj["radius_m"] * np.sin(ang),
                                 h0 + (h1 - h0) * s])
        out.append(look_at(eye * scale, target * scale))
    return np.stack(out)


def smooth_frames(n, H, W, C, cells, rng):
    """[n, H, W, C] float32 in [0, 1]: random values on a coarse grid of
    `cells` (rows, cols), bilinearly upsampled."""
    ch, cw = cells
    coarse = rng.random((n, ch + 1, cw + 1, C), dtype=np.float32)
    y = np.linspace(0, ch, H, dtype=np.float32)
    x = np.linspace(0, cw, W, dtype=np.float32)
    y0 = np.minimum(y.astype(np.int64), ch - 1)
    x0 = np.minimum(x.astype(np.int64), cw - 1)
    fy, fx = (y - y0)[None, :, None, None], (x - x0)[None, None, :, None]
    a = coarse[:, y0][:, :, x0]
    b = coarse[:, y0][:, :, x0 + 1]
    c = coarse[:, y0 + 1][:, :, x0]
    d = coarse[:, y0 + 1][:, :, x0 + 1]
    top = a + (b - a) * fx
    return (top + (c + (d - c) * fx - top) * fy).astype(np.float32)


def make_inputs(data, cfg, seed, split="train", root=named.ROOT):
    """The inputs of one run (see the module docstring); split 'train'
    (the train provider's) or 'val' (the views an evaluation renders)."""
    rng = np.random.default_rng(seed_sequence(seed, 0))
    return named.module("inputs", data["kind"], root).make(data, cfg, rng, split)
