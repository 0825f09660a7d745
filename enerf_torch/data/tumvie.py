"""The TUM-VIE dataset format (real event-camera data, mocap poses):
loader and writer.

Counterpart of enerf_tpu/data/tumvie.py (reference nerf/provider.py):
  - load_event_data_tumvie (:148-244): the H5 event stream sliced into
    windows centred between image timestamps, undistorted through the
    rectify map, polarity {0, 1} -> {-1, +1}, us -> ns, the windows shrunk
    when their total exceeds 10 s;
  - convert_tumvie_to_posesBds_and_hfPoses (:812-867): the mocap marker
    quatlist (us), the calib_undist.json + mocap-imu-calib.json
    extrinsics, c2w = T_mocap_marker @ inv(T_imu_marker) @ T_imu_cam, the
    optional sphere preprocessing, rub + nerf_matrix_to_ngp;
  - the stereo rig: frame cameras 0 / 1, event cameras 2 / 3 (:504-533),
    the event camera at 1280 x 720.
H5 files go through the port's own HDF5 reader and writer (utils/hdf5.py)
and images through its PNG codec (utils/png.py): the card has neither
h5py nor OpenCV.
"""

import glob
import json
import os

import numpy as np
from scipy.spatial.transform import Rotation as Rot

from enerf_torch.data.h5events import EventSlicer, write_event_h5, write_rectify_map
from enerf_torch.data.poses import (
    get_hom_trafos, make_pose_interpolator, nerf_matrix_to_ngp, preprocess_pose_array_sphere,
)
from enerf_torch.utils import hdf5
from enerf_torch.utils.png import write_png

MAX_EVENT_WINDOW_US = 10 * 1e6  # provider.py:189


def _quat_dict_to_hom(d):
    out = np.eye(4)
    out[:3, :3] = Rot.from_quat([d["qx"], d["qy"], d["qz"], d["qw"]]).as_matrix()
    out[:3, 3] = [d["px"], d["py"], d["pz"]]
    return out


def event_window_centers(tss_imgs_us):
    """Window centres between image timestamps (provider.py:174-179)."""
    dT_us = np.diff(tss_imgs_us).mean()
    c = np.insert(tss_imgs_us, 0, tss_imgs_us[0] - 2 * dT_us)
    c = np.append(c, c[-1] + 2 * dT_us)
    c = c[:-1] + np.diff(c) / 2.0
    assert np.all(np.diff(c) > 0)
    return c


def slice_events_per_frame(slicer, tss_imgs_us, rectify_map=None,
                           max_window_us=MAX_EVENT_WINDOW_US):
    """Windowed, undistorted events per image (provider.py:186-244).

    Returns (events [M, 4] (x, y, t_ns, pol in +-1), frame_ids [M]).
    """
    centers = event_window_centers(tss_imgs_us)
    dT_us = 0.0
    total = centers[-1] - centers[0]
    if total > max_window_us:
        dT_us = (total - max_window_us) / (2 * len(tss_imgs_us))

    out, fids = [], []
    for i in range(len(tss_imgs_us)):
        ev = slicer.get_events(int(centers[i] + dT_us), int(centers[i + 1] - dT_us))
        if ev is None or ev["t"].size == 0:
            continue
        n = ev["t"].size
        tmp = np.zeros((n, 4))
        if rectify_map is not None:
            rect = rectify_map[ev["y"].astype(np.int64), ev["x"].astype(np.int64)]
            tmp[:, 0] = rect[..., 0]
            tmp[:, 1] = rect[..., 1]
        else:
            tmp[:, 0] = ev["x"]
            tmp[:, 1] = ev["y"]
        tmp[:, 2] = ev["t"] * 1000.0  # us -> ns
        p = ev["p"].astype(np.float64)
        tmp[:, 3] = p * 2.0 - 1.0 if set(np.unique(p)) <= {0.0, 1.0} else p
        out.append(tmp)
        fids.append(np.full(n, i, np.int64))
    if not out:
        return np.zeros((0, 4)), np.zeros((0,), np.int64)
    return np.concatenate(out), np.concatenate(fids)


def read_events(h5_path, rmap_path, tss_imgs_us):
    """The H5 stream sliced per image, through the rectify map when there
    is one (rmap_path None: the raw pixel coordinates)."""
    rectify_map = None
    if rmap_path:
        with hdf5.File(rmap_path) as f:
            rectify_map = np.asarray(f["rectify_map"])
    with hdf5.File(h5_path) as f:
        return slice_events_per_frame(EventSlicer(f), tss_imgs_us, rectify_map)


def read_frames(img_paths, tss_us, idxs, interp, to_final, hf_ts_us, out_dim_color,
                downscale):
    """(images [F, H, W, C], stamps [F] us, final poses [F, 4, 4]) of the
    frames `idxs` of a sequence (all of them with None): the frame camera's
    pose interpolated at each stamp, clipped to the pose list's span."""
    from enerf_torch.data.provider import read_image

    if idxs is not None:
        tss_us, img_paths = tss_us[idxs], [img_paths[i] for i in idxs]
    images = np.stack([read_image(p, out_dim_color, downscale) for p in img_paths])
    poses = np.stack([to_final(np.vstack([p, [0, 0, 0, 1]]))
                      for p in interp(np.clip(tss_us, hf_ts_us[0], hf_ts_us[-1]))])
    return images, tss_us, poses


def add_val_frames(out, val_idxs, img_paths, tss_us, *frames_args):
    """The frames `val_idxs` of the whole sequence (those past its end
    dropped) as out's val_images, val_tss_imgs_ns and val_poses."""
    keep = [i for i in val_idxs if i < len(tss_us)]
    images, ts, poses = read_frames(img_paths, tss_us, keep, *frames_args)
    out.update(val_images=images, val_tss_imgs_ns=ts * 1000.0, val_poses=poses)


def load_tumvie_dataset(datadir, scale=0.33, out_dim_color=1, downscale=1,
                        pp_poses_sphere=True, cam="left", hotpixs=False, select_idxs=None,
                        e2vid=0, images_corrupted=False, val_idxs=None):
    """A TUM-VIE-format directory -> the provider dict (images, tss_imgs_ns,
    poses, intrinsics, intrinsics_evs, hf_ts, hf_poses, events,
    event_frame_ids, H, W, H_ev, W_ev): the images, and the event windows
    around them, of `select_idxs` (all frames without).  With `val_idxs`
    (indices into the whole sequence) also the val_images,
    val_tss_imgs_ns and val_poses of those frames."""
    from enerf_torch.data.provider import resolve_image_dir, rub_from_rdf

    suffix = cam + ("_hotpixs" if hotpixs else "")
    with open(os.path.join(datadir, "calib_undist.json")) as f:
        calib = json.load(f)["value0"]
    with open(os.path.join(datadir, "mocap-imu-calib.json")) as f:
        calib.update(json.load(f)["value0"])
    cam_id = 0 if cam == "left" else 1
    cam_id_evs = 2 if cam == "left" else 3
    intr = calib["intrinsics_undistorted"][cam_id]
    intr_evs = calib["intrinsics_undistorted"][cam_id_evs]
    T_imu_cam = _quat_dict_to_hom(calib["T_imu_cam"][cam_id])
    T_imu_evcam = _quat_dict_to_hom(calib["T_imu_cam"][cam_id_evs])
    T_imu_marker = _quat_dict_to_hom(calib["T_imu_marker"])

    # mocap poses -> camera c2w (provider.py:856-860)
    mocap_files = [f for f in glob.glob(os.path.join(datadir, "*mocap*.txt"))
                   if "pp_mocap" not in f]
    quatlist = np.loadtxt(mocap_files[0], skiprows=1)
    assert quatlist.shape[1] == 8
    hf_ts_us = quatlist[:, 0]
    T_w_marker = get_hom_trafos(Rot.from_quat(quatlist[:, 4:8]).as_matrix(), quatlist[:, 1:4])

    def cam_chain(T_imu_x):
        return np.einsum("nij,jk->nik", T_w_marker, np.linalg.inv(T_imu_marker) @ T_imu_x)

    if pp_poses_sphere:
        # spherified in the frame camera's system, then mapped over
        hf_rgb = preprocess_pose_array_sphere(cam_chain(T_imu_cam))
        hf_ev = np.einsum("nij,jk->nik", hf_rgb, np.linalg.inv(T_imu_cam) @ T_imu_evcam)

        def to_final(p):
            return nerf_matrix_to_ngp(p, scale=scale)
    else:
        hf_rgb, hf_ev = cam_chain(T_imu_cam), cam_chain(T_imu_evcam)

        def to_final(p):
            return nerf_matrix_to_ngp(rub_from_rdf(p[None])[0], scale=scale)

    # images: clean / e2vid / corrupted (reference provider.py:540-545, 731-735)
    clean_dir = os.path.join(datadir, f"{cam}_images_undistorted")
    imgdir, _ = resolve_image_dir(datadir, "tumvie", e2vid, images_corrupted,
                                  default_dir=clean_dir)
    tss_all = np.loadtxt(os.path.join(clean_dir, f"image_timestamps_{cam}.txt"))
    paths_all = sorted(glob.glob(os.path.join(imgdir, "*.jpg"))
                       + glob.glob(os.path.join(imgdir, "*.png")))
    frames_args = (make_pose_interpolator(hf_ts_us, hf_rgb), to_final, hf_ts_us,
                   out_dim_color, downscale)
    images, tss_imgs_us, img_poses = read_frames(paths_all, tss_all, select_idxs, *frames_args)
    H, W = images.shape[1:3]
    if downscale > 1:
        # the frame camera's intrinsics follow the resize; the event
        # camera keeps its full resolution, as in the reference
        intr = {k: (v / downscale if k in ("fx", "fy", "cx", "cy") else v)
                for k, v in intr.items()}

    h5_path = glob.glob(os.path.join(datadir, f"*events_{suffix}.h5"))[0]
    rmap = glob.glob(os.path.join(datadir, f"*rectify_map_{cam}.h5"))
    events, frame_ids = read_events(h5_path, rmap[0] if rmap else None, tss_imgs_us)
    out = {
        "images": images,
        "tss_imgs_ns": tss_imgs_us * 1000.0,
        "poses": img_poses,
        "intrinsics": (intr["fx"], intr["fy"], intr["cx"], intr["cy"]),
        "intrinsics_evs": (intr_evs["fx"], intr_evs["fy"], intr_evs["cx"], intr_evs["cy"]),
        "hf_ts": hf_ts_us * 1000.0,
        "hf_poses": np.stack([to_final(p) for p in hf_ev]),
        "events": events,
        "event_frame_ids": frame_ids,
        "H": H, "W": W, "H_ev": 720, "W_ev": 1280,
    }
    if val_idxs is not None:
        add_val_frames(out, val_idxs, paths_all, tss_all, *frames_args)
    return out


def save_tumvie_dataset(data, datadir, scale=0.33):
    """Write the simulator's output (synthetic.simulate_events) in the
    TUM-VIE layout: left_images_undistorted/ (8-bit PNG) with
    image_timestamps_left.txt, mocap_data.txt (4 poses per frame),
    calib_undist.json + mocap-imu-calib.json (identity extrinsics),
    events_left.h5 (us, ms_to_idx, under events/) and an identity
    rectify_map_left.h5."""
    from enerf_torch.data.provider import raw_rdf_from_ngp

    H, W = data["H"], data["W"]
    imgdir = os.path.join(datadir, "left_images_undistorted")
    os.makedirs(imgdir, exist_ok=True)
    ts_us = data["frame_ts"] * 1e6
    np.savetxt(os.path.join(imgdir, "image_timestamps_left.txt"), ts_us)
    for i, im in enumerate(data["frames"]):
        write_png(os.path.join(imgdir, f"{i:05d}.png"),
                  (np.clip(im[..., 0], 0, 1) * 255).astype(np.uint8))

    # mocap marker poses == camera poses (identity marker / imu / cam calib)
    hf_t = np.linspace(data["frame_ts"][0], data["frame_ts"][-1], 4 * len(ts_us))
    rows = []
    for t in hf_t:
        raw = raw_rdf_from_ngp(data["pose_fn"](t), scale)
        rows.append([t * 1e6, *raw[:3, 3], *Rot.from_matrix(raw[:3, :3]).as_quat()])
    np.savetxt(os.path.join(datadir, "mocap_data.txt"), np.asarray(rows),
               header="ts_us px py pz qx qy qz qw")

    ident = {"px": 0.0, "py": 0.0, "pz": 0.0, "qx": 0.0, "qy": 0.0, "qz": 0.0, "qw": 1.0}
    fx, fy, cx, cy = data["intrinsics"]
    intr = {"fx": fx, "fy": fy, "cx": cx, "cy": cy}
    with open(os.path.join(datadir, "calib_undist.json"), "w") as f:
        json.dump({"value0": {"intrinsics_undistorted": [intr, intr, intr, intr],
                              "T_imu_cam": [ident, ident, ident, ident]}}, f)
    with open(os.path.join(datadir, "mocap-imu-calib.json"), "w") as f:
        json.dump({"value0": {"T_imu_marker": ident}}, f)

    ev = data["events"]
    ev = ev[np.argsort(ev[:, 2], kind="stable")]
    write_event_h5(os.path.join(datadir, "events_left.h5"), ev[:, 0], ev[:, 1], ev[:, 2] * 1e6,
                   (ev[:, 3] > 0).astype(np.int8), grouped=True)
    rmap = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1)
    write_rectify_map(os.path.join(datadir, "rectify_map_left.h5"), rmap.astype(np.float32))
    return datadir
