"""Pose interpolation: on the host (numpy + scipy) and on the device.

Counterpart of enerf_tpu/data/poses.py (reference pose_utils.py:138-160).
`make_pose_interpolator` (Slerp rotations + cubic translations, the port's
own copy) runs once when a dataset is built; `interp_pose_device` (slerp +
cubic Hermite on tensors) computes poses per batch instead, for
precompute_evs_poses=0 and for the no-event pair's random times.
`get_hom_trafos` and `nerf_matrix_to_ngp` are the loaders' pose
conventions, `preprocess_pose_array_sphere` the tumvie loader's
sphere preprocessing (pp_poses_sphere=1) and `spiral_path` the render
tool's spiral: copies of the JAX package's numpy functions.
"""

import numpy as np
import torch
from scipy.interpolate import interp1d
from scipy.spatial.transform import Rotation as R
from scipy.spatial.transform import Slerp


def make_pose_interpolator(ts, poses):
    """ts: [K]; poses: [K, 4, 4] or [K, 3, 4] c2w.

    Returns callable query(ts_q) -> [N, 3, 4] float32 (Slerp rotations,
    cubic translations; reference provider.py:1208-1218, 1231-1235).
    """
    ts = np.asarray(ts, np.float64)
    poses = np.asarray(poses, np.float64)
    rot_i = Slerp(ts, R.from_matrix(poses[:, :3, :3]))
    kind = "cubic" if len(ts) >= 4 else "linear"
    trans_i = interp1d(ts, poses[:, :3, 3], axis=0, kind=kind, bounds_error=True)

    def query(ts_q):
        ts_q = np.clip(np.asarray(ts_q, np.float64), ts[0], ts[-1])
        out = np.zeros((len(ts_q), 3, 4), np.float32)
        out[:, :3, :3] = rot_i(ts_q).as_matrix()
        out[:, :3, 3] = trans_i(ts_q)
        return out

    return query


def get_hom_trafos(rots, trans):
    """[N, 3, 3] + [N, 3] -> [N, 4, 4] homogeneous c2w (pose_utils.py)."""
    rots, trans = np.asarray(rots), np.asarray(trans)
    out = np.tile(np.eye(4), (rots.shape[0], 1, 1))
    out[:, :3, :3] = rots
    out[:, :3, 3] = trans
    return out


def nerf_matrix_to_ngp(pose, scale=0.33, offset=(0, 0, 0)):
    """rub (OpenGL / NeRF) c2w -> rdf (instant-ngp, this repo), scaled
    (reference pose_utils.py:664-676)."""
    p = np.asarray(pose, np.float64)
    return np.array([
        [p[1, 0], -p[1, 1], -p[1, 2], p[1, 3] * scale + offset[0]],
        [p[2, 0], -p[2, 1], -p[2, 2], p[2, 3] * scale + offset[1]],
        [p[0, 0], -p[0, 1], -p[0, 2], p[0, 3] * scale + offset[2]],
        [0, 0, 0, 1],
    ], dtype=np.float64)


def mat_to_quat_np(rot):
    """[..., 3, 3] -> [..., 4] (w, x, y, z)."""
    q = R.from_matrix(np.asarray(rot).reshape(-1, 3, 3)).as_quat()  # xyzw
    q = np.concatenate([q[:, 3:4], q[:, :3]], axis=1)
    return q.reshape(np.asarray(rot).shape[:-2] + (4,))


def quat_to_mat(q):
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def slerp_device(q0, q1, u):
    """Batched quaternion slerp along the shortest arc.  q0, q1: [..., 4]; u: [...]."""
    d = (q0 * q1).sum(-1)
    q1 = torch.where(d[..., None] < 0, -q1, q1)
    d = d.abs().clamp(-1.0, 1.0)
    theta = torch.arccos(d)
    sin_t = torch.sin(theta)
    small = sin_t < 1e-6
    safe = torch.where(small, torch.ones_like(sin_t), sin_t)
    w0 = torch.where(small, 1.0 - u, torch.sin((1.0 - u) * theta) / safe)
    w1 = torch.where(small, u, torch.sin(u * theta) / safe)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def interp_pose_device(key_ts, key_quats, key_trans, ts_q):
    """Poses at query times, on the tensors' device.

    key_ts: [K] sorted keyframe times; key_quats: [K, 4]; key_trans: [K, 3];
    ts_q: [N].  Returns [N, 3, 4]: slerp rotations + cubic Hermite
    translations with Catmull-Rom tangents on non-uniform knots.
    """
    K = key_ts.shape[0]
    idx = (torch.searchsorted(key_ts, ts_q.contiguous(), right=True) - 1).clamp(0, K - 2)
    t0, t1 = key_ts[idx], key_ts[idx + 1]
    h = (t1 - t0).clamp(min=1e-12)
    u = ((ts_q - t0) / h).clamp(0.0, 1.0)
    q = slerp_device(key_quats[idx], key_quats[idx + 1], u)

    p0, p1 = key_trans[idx], key_trans[idx + 1]
    im = (idx - 1).clamp(min=0)
    ip = (idx + 2).clamp(max=K - 1)
    # central-difference tangents scaled to the local interval
    m0 = (p1 - key_trans[im]) / (t1 - key_ts[im]).clamp(min=1e-12)[:, None] * h[:, None]
    m1 = (key_trans[ip] - p0) / (key_ts[ip] - t0).clamp(min=1e-12)[:, None] * h[:, None]
    u2 = (u * u)[:, None]
    u3 = u2 * u[:, None]
    uu = u[:, None]
    tr = ((2 * u3 - 3 * u2 + 1) * p0 + (u3 - 2 * u2 + uu) * m0
          + (-2 * u3 + 3 * u2) * p1 + (u3 - u2) * m1)
    return torch.cat([quat_to_mat(q), tr[..., None]], dim=-1)


# ----------------------------------------------------------------------------
# pose-set preprocessing (reference pose_utils.py:372-470, provider.py:358-408)


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    """[3, 4] camera matrix from forward z, up hint, and position."""
    vec2 = normalize(np.asarray(z, np.float64))
    vec0 = normalize(np.cross(np.asarray(up, np.float64), vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, np.asarray(pos, np.float64)], 1)


def poses_avg(poses):
    """Average c2w of a pose set [N, 3, 4] (pose_utils.py:395-445)."""
    poses = np.asarray(poses)
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return viewmatrix(vec2, up, center)


def spiral_path(c2w_center, radii, focus_depth, n_poses=120, n_rots=2):
    """Spiral render path [n_poses, 4, 4] around a center pose
    (pose_utils.py:597-607 role)."""
    c2w = np.asarray(c2w_center, np.float64)
    out = []
    for t in np.linspace(0, 2 * np.pi * n_rots, n_poses, endpoint=False):
        center = c2w[:3, 3] + c2w[:3, :3] @ (
            np.asarray([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * np.asarray(radii))
        z = normalize(c2w[:3, :3] @ np.asarray([0, 0, focus_depth]) + c2w[:3, 3] - center)
        pose = np.eye(4)
        pose[:3, :] = viewmatrix(z, c2w[:3, 1], center)
        out.append(pose)
    return np.stack(out)


def recenter_poses(poses):
    """Recenter a pose set around its average pose (pose_utils.py:456-490).

    poses: [N, 3, 4] -> [N, 3, 4], convention preserved.
    """
    poses = np.asarray(poses, np.float64)
    c2w = np.concatenate([poses_avg(poses), [[0, 0, 0, 1.0]]], 0)
    bottom = np.tile([[[0, 0, 0, 1.0]]], (poses.shape[0], 1, 1))
    hom = np.concatenate([poses[:, :3, :4], bottom], 1)
    out = np.linalg.inv(c2w) @ hom
    return out[:, :3, :4]


def rotmat_between(a, b):
    """Rotation taking direction a to b (pose_utils rotmat, provider.py:60)."""
    a, b = normalize(np.asarray(a, np.float64)), normalize(np.asarray(b, np.float64))
    v = np.cross(a, b)
    c = np.dot(a, b)
    s = np.linalg.norm(v)
    kmat = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + kmat + kmat @ kmat * ((1 - c) / (s ** 2 + 1e-10))


def closest_point_2_lines(oa, da, ob, db):
    """Point closest to both rays + parallelism weight (pose_utils.py:610-622)."""
    da, db = normalize(np.asarray(da)), normalize(np.asarray(db))
    c = np.cross(da, db)
    denom = np.linalg.norm(c) ** 2
    t = np.asarray(ob) - np.asarray(oa)
    ta = np.linalg.det([t, db, c]) / (denom + 1e-10)
    tb = np.linalg.det([t, da, c]) / (denom + 1e-10)
    ta, tb = min(ta, 0.0), min(tb, 0.0)
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def preprocess_pose_array_sphere(poses, n_subsample=100, seed=0):
    """Sphere preprocessing of a c2w pose set (provider.py:358-408):
    recenter, axis flips into rub, rotate average up to +z, shift to the
    center of attention (closest point of ray pairs), rescale radius to 1.

    poses: [N, 4, 4] -> [N, 4, 4]
    """
    poses = np.array(poses, np.float64, copy=True)
    N = len(poses)
    poses[:, :3, :] = recenter_poses(poses[:, :3, :])

    poses[:, 0:3, 1] *= -1
    poses[:, 0:3, 2] *= -1
    poses = poses[:, [1, 0, 2, 3], :]
    poses[:, 2, :] *= -1

    up = poses[:, 0:3, 1].sum(0)
    Rm = rotmat_between(up, [0, 0, 1])
    Rm = np.pad(Rm, [0, 1])
    Rm[-1, -1] = 1
    poses = Rm @ poses

    rng = np.random.default_rng(seed)
    idxs = rng.integers(0, N, size=min(n_subsample, N))
    sub = poses[idxs]
    totw, totp = 0.0, np.zeros(3)
    for i in range(len(sub)):
        mf = sub[i, :3, :]
        for j in range(len(sub)):
            mg = sub[j, :3, :]
            p, w = closest_point_2_lines(mf[:, 3], mf[:, 2], mg[:, 3], mg[:, 2])
            if w > 0.01:
                totp += p * w
                totw += w
    totp /= max(totw, 1e-10)
    poses[:, :3, 3] -= totp
    avglen = np.linalg.norm(poses[:, :3, 3], axis=-1).mean()
    poses[:, :3, 3] *= 1.0 / avglen
    return poses
