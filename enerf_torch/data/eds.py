"""The EDS dataset format (real event sequences, stamped ground-truth
poses): loader and writer.

Counterpart of enerf_tpu/data/eds.py (reference nerf/provider.py):
  - load_event_data_EDS (:249-328): events.h5 with its t_offset, windows
    centred between image timestamps, the rectify_map_calib0.h5
    undistortion, polarity -> +-1, us -> ns;
  - convert_EDS_to_posesBds_and_hfPoses (:770-810): the
    stamped_groundtruth_us.txt quatlist (the event camera's c2w), the
    hard-coded calib0 extrinsics T_ev_rgb (:538-566),
    images_timestamps_us.txt, rub + nerf_matrix_to_ngp (eds configs always
    set pp_poses_sphere=0, main_nerf.py:81-82).
H5 files go through the port's own HDF5 code, images through its PNG
codec.
"""

import glob
import json
import os

import numpy as np
from scipy.spatial.transform import Rotation as Rot

from enerf_torch.data.h5events import write_event_h5
from enerf_torch.data.poses import get_hom_trafos, make_pose_interpolator, nerf_matrix_to_ngp
from enerf_torch.data.tumvie import add_val_frames, read_events, read_frames
from enerf_torch.utils.png import write_png

# reference provider.py:556-566 (calib0 camera extrinsics)
T_EV_RGB_CALIB0 = np.asarray([
    [0.9998964430808897, -0.0020335804041023736, -0.014246672065022661, -0.00011238613157578769],
    [0.001703024953250547, 0.9997299470300024, -0.023176123864880376, -0.0005981481496958399],
    [0.014289955220253567, 0.02314946137886846, 0.9996298813149167, -0.004416681577516066],
    [0.0, 0.0, 0.0, 1.0],
])


def load_eds_dataset(datadir, scale=0.33, out_dim_color=1, downscale=1, calibstr="calib0",
                     hotpixs=False, select_idxs=None, intrinsics=None, intrinsics_evs=None,
                     e2vid=0, images_corrupted=False, val_idxs=None):
    """An EDS-format directory -> the provider dict (as
    load_tumvie_dataset's, val frames included; the event camera at the
    images' size).  intrinsics / intrinsics_evs (fx, fy, cx, cy) override
    the calib JSON."""
    from enerf_torch.data.provider import resolve_image_dir, rub_from_rdf

    calib_path = os.path.join(datadir, f"calib_undist_{calibstr}.json")
    if intrinsics is None and os.path.exists(calib_path):
        with open(calib_path) as f:
            calib = json.load(f)
        intr, intr_evs = calib["intrinsics_undistorted"][:2]
        intrinsics = (intr["fx"], intr["fy"], intr["cx"], intr["cy"])
        intrinsics_evs = (intr_evs["fx"], intr_evs["fy"], intr_evs["cx"], intr_evs["cy"])

    # ground-truth poses: the EVENT camera's c2w (rdf)
    quatlist = np.loadtxt(os.path.join(datadir, "stamped_groundtruth_us.txt"), skiprows=1)
    assert quatlist.shape[1] == 8
    hf_ts_us = quatlist[:, 0]
    hf_ev_raw = get_hom_trafos(Rot.from_quat(quatlist[:, 4:8]).as_matrix(), quatlist[:, 1:4])

    def to_final(p):
        return nerf_matrix_to_ngp(rub_from_rdf(p[None])[0], scale=scale)

    # images: clean / e2vid / corrupted (reference provider.py:505-510, 731-735)
    imgdir = os.path.join(datadir, f"images_undistorted_{calibstr}")
    if not os.path.isdir(imgdir):
        imgdir = os.path.join(datadir, "images")
    imgdir, _ = resolve_image_dir(datadir, "eds", e2vid, images_corrupted, default_dir=imgdir)
    tss_all = np.loadtxt(os.path.join(datadir, "images_timestamps_us.txt"))
    paths_all = sorted(glob.glob(os.path.join(imgdir, "*.png"))
                       + glob.glob(os.path.join(imgdir, "*.jpg")))
    # the frame camera: T_w_rgb = T_w_ev @ T_ev_rgb (the reference's convention)
    interp_rgb = make_pose_interpolator(hf_ts_us,
                                        np.einsum("nij,jk->nik", hf_ev_raw, T_EV_RGB_CALIB0))
    frames_args = (interp_rgb, to_final, hf_ts_us, out_dim_color, downscale)
    images, tss_imgs_us, img_poses = read_frames(paths_all, tss_all, select_idxs, *frames_args)
    H, W = images.shape[1:3]
    if intrinsics is not None and downscale > 1:
        # the frame camera's intrinsics follow the resize (events keep the
        # full event-camera resolution, as in the reference)
        intrinsics = tuple(v / downscale for v in intrinsics)
    if intrinsics is None:
        f = 0.7 * W
        intrinsics = intrinsics_evs = (f, f, W / 2.0, H / 2.0)

    h5_path = os.path.join(datadir, "events.h5")
    if hotpixs:
        h5_path = glob.glob(os.path.join(datadir, "events_hotpixs_*.h5"))[0]
    rmap = os.path.join(datadir, f"rectify_map_{calibstr}.h5")
    events, frame_ids = read_events(h5_path, rmap if os.path.exists(rmap) else None,
                                    tss_imgs_us)
    out = {
        "images": images,
        "tss_imgs_ns": tss_imgs_us * 1000.0,
        "poses": img_poses,
        "intrinsics": intrinsics,
        "intrinsics_evs": intrinsics_evs,
        "hf_ts": hf_ts_us * 1000.0,
        "hf_poses": np.stack([to_final(p) for p in hf_ev_raw]),
        "events": events,
        "event_frame_ids": frame_ids,
        "H": H, "W": W, "H_ev": H, "W_ev": W,
    }
    if val_idxs is not None:
        add_val_frames(out, val_idxs, paths_all, tss_all, *frames_args)
    return out


def save_eds_dataset(data, datadir, scale=0.33, t_offset=0):
    """Write the simulator's output (synthetic.simulate_events) in the EDS
    layout: images/ (8-bit PNG) with images_timestamps_us.txt,
    stamped_groundtruth_us.txt (the event camera's c2w, 4 per frame),
    calib_undist_calib0.json and events.h5 (us, ms_to_idx, t_offset).
    The frame camera is the event camera (identity extrinsics are a valid
    calib for fixtures).  With t_offset (us) the image and pose stamps are
    absolute (shifted by it) and the H5 times relative, as in EDS files."""
    from enerf_torch.data.provider import raw_rdf_from_ngp

    os.makedirs(os.path.join(datadir, "images"), exist_ok=True)
    ts_us = data["frame_ts"] * 1e6 + t_offset
    np.savetxt(os.path.join(datadir, "images_timestamps_us.txt"), ts_us)
    for i, im in enumerate(data["frames"]):
        write_png(os.path.join(datadir, "images", f"frame_{i:010d}.png"),
                  (np.clip(im[..., 0], 0, 1) * 255).astype(np.uint8))

    hf_t = np.linspace(data["frame_ts"][0], data["frame_ts"][-1], 4 * len(ts_us))
    rows = []
    for t in hf_t:
        raw = raw_rdf_from_ngp(data["pose_fn"](t), scale)
        rows.append([t * 1e6 + t_offset, *raw[:3, 3], *Rot.from_matrix(raw[:3, :3]).as_quat()])
    np.savetxt(os.path.join(datadir, "stamped_groundtruth_us.txt"), np.asarray(rows),
               header="ts_us px py pz qx qy qz qw")

    ev = data["events"]
    ev = ev[np.argsort(ev[:, 2], kind="stable")]
    write_event_h5(os.path.join(datadir, "events.h5"), ev[:, 0], ev[:, 1], ev[:, 2] * 1e6,
                   (ev[:, 3] > 0).astype(np.int8), t_offset=t_offset)

    fx, fy, cx, cy = data["intrinsics"]
    intr = {"fx": fx, "fy": fy, "cx": cx, "cy": cy}
    with open(os.path.join(datadir, "calib_undist_calib0.json"), "w") as f:
        json.dump({"intrinsics_undistorted": [intr, intr]}, f)
    return datadir
