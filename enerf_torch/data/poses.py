"""Host-side pose interpolation (numpy + scipy).

The port's copy of the numpy part of enerf_tpu/data/poses.py (reference
pose_utils.py:138-160): Slerp rotations + cubic translations at query
times, used once when a dataset is built.  The on-device slerp
(`interp_pose_device`, precompute_evs_poses=0) is not ported yet.
"""

import numpy as np
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


def mat_to_quat_np(rot):
    """[..., 3, 3] -> [..., 4] (w, x, y, z)."""
    q = R.from_matrix(np.asarray(rot).reshape(-1, 3, 3)).as_quat()  # xyzw
    q = np.concatenate([q[:, 3:4], q[:, :3]], axis=1)
    return q.reshape(np.asarray(rot).shape[:-2] + (4,))
