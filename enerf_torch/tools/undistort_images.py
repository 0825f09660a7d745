"""Undistort frames and build the event camera's rectify map, without
OpenCV.

Counterpart of scripts/undistort_images.py (reference
scripts/undistort_images_tumvie.py / _eds.py), with the same flags,
outputs and file names, on the port's camera models (utils/camera.py) and
image codecs (utils/png.py, utils/jpeg.py):

  python -m enerf_torch.tools.undistort_images --datadir SEQ \\
      --calib calibration.json --cam 0 --model radtan --out_suffix calib0

undistorts every frame matching --img_glob into
SEQ/images_undistorted_<suffix>/ (each keeps its basename, so .jpg frames
come out as JPEG), writes SEQ/rectify_map_<suffix>.h5 (the undistorted
target coordinate of every pixel) and SEQ/calib_undist_<suffix>.json (the
undistorted intrinsics).  The calibration json is {"intrinsics": [{"fx",
"fy", "cx", "cy", "k1", "k2", "p1", "p2"[, "k3", "k4"]}, ...]}; the model
is 'radtan' (OpenCV's, alpha 0) or 'fisheye' (equidistant, balance 0).

  python -m enerf_torch.tools.undistort_images --e2vid \\
      --indir SEQ/e2vids/left/e2vid_up4_freq0/e2calib/ --calib calibration.json \\
      --cam 0 --model radtan

undistorts E2VID reconstructions with the event camera's model (fisheye at
balance 0.5) into the sibling e2calib_undistorted/%021d.png, with
calib_undist_e2vid.json beside it; for radtan it checks the first frame's
remap against a direct undistortion (PSNR > 50).
"""

import argparse
import glob
import json
import os

import numpy as np

from enerf_torch.data.h5events import write_rectify_map
from enerf_torch.data.provider import read_unchanged, write_image
from enerf_torch.utils import camera


def build_maps(intr, H, W, model, balance=0.0):
    """(map1, map2, Knew, rectify_map [H, W, 2] float32) of one camera."""
    K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])
    if model == "fisheye":
        D = np.array([intr.get(k, 0.0) for k in ("k1", "k2", "k3", "k4")])
        Knew = camera.fisheye_estimate_new_camera_matrix(K, D, (W, H), np.eye(3),
                                                         balance=balance)
        m1, m2 = camera.fisheye_init_undistort_rectify_map(K, D, np.eye(3), Knew, (W, H))
        pts = camera.fisheye_undistort_points(_grid_pts(H, W), K, D, R=np.eye(3), P=Knew)
    else:
        # OpenCV's radtan order (k1, k2, p1, p2[, k3]): k3 when the
        # calibration gives it (the 5-term model)
        D = np.array([intr.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3")])
        if intr.get("k3") is None:
            D = D[:4]
        Knew = camera.get_optimal_new_camera_matrix(K, D, (W, H), 0)
        m1, m2 = camera.init_undistort_rectify_map(K, D, np.eye(3), Knew, (W, H))
        pts = camera.undistort_points(_grid_pts(H, W), K, D, R=np.eye(3), P=Knew)
    return m1, m2, Knew, pts.reshape(H, W, 2)


def _grid_pts(H, W):
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    return np.stack([xs, ys], -1).reshape(-1, 1, 2)


def _read_color(path):
    """cv2.imread(path) (IMREAD_COLOR): 8-bit BGR, gray repeated, alpha
    dropped."""
    im = read_unchanged(path)
    if im.dtype == np.uint16:
        im = (im >> 8).astype(np.uint8)
    if im.ndim == 2:
        return np.repeat(im[..., None], 3, -1)
    return im[..., :3]


def _intrinsics_json(Knew):
    return {"intrinsics_undistorted": [{
        "fx": float(Knew[0, 0]), "fy": float(Knew[1, 1]),
        "cx": float(Knew[0, 2]), "cy": float(Knew[1, 2]),
    }]}


def undistort_e2vid(args):
    """Undistort E2VID reconstructions into e2calib_undistorted/."""
    with open(args.calib) as f:
        intr = json.load(f)["intrinsics"][args.cam]
    imgs = sorted(glob.glob(os.path.join(args.indir, "*.png")))
    if not imgs:
        raise SystemExit(f"no .png frames under {args.indir}")
    H, W = _read_color(imgs[0]).shape[:2]
    balance = 0.5 if args.model == "fisheye" else 0.0
    m1, m2, Knew, _ = build_maps(intr, H, W, args.model, balance=balance)

    outdir = os.path.join(os.path.dirname(args.indir.rstrip("/")), "e2calib_undistorted")
    os.makedirs(outdir, exist_ok=True)
    for i, p in enumerate(imgs):
        im = _read_color(p)
        und = camera.remap_linear(im, m1, m2)
        if args.model == "radtan" and i == 0:
            # a direct undistortion and the precomputed remap must agree
            # (catches a wrong new camera matrix)
            K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])
            D = np.array([intr.get(k, 0.0) for k in ("k1", "k2", "p1", "p2")])
            direct = camera.undistort(im, K, D, Knew)
            mse = np.mean((direct.astype(np.float32) - und.astype(np.float32)) ** 2)
            psnr = -10 * np.log10(max(mse, 1e-10)) + 20 * np.log10(255.0)
            if not psnr > 50:
                raise ValueError(f"undistort/remap disagree (psnr {psnr:.1f})")
        write_image(os.path.join(outdir, f"{i:021d}.png"), und)
    with open(os.path.join(outdir, "..", "calib_undist_e2vid.json"), "w") as f:
        json.dump(_intrinsics_json(Knew), f, indent=2)
    print(f"undistorted {len(imgs)} e2vid frames -> {outdir}")
    return outdir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--datadir")
    ap.add_argument("--calib", required=True)
    ap.add_argument("--cam", type=int, default=0)
    ap.add_argument("--model", default="radtan", choices=["radtan", "fisheye"])
    ap.add_argument("--img_glob", default="images/*.png")
    ap.add_argument("--out_suffix", default="calib0")
    ap.add_argument("--e2vid", action="store_true",
                    help="undistort an E2VID reconstruction folder (--indir) instead of "
                         "dataset frames")
    ap.add_argument("--indir", help="e2vid mode: the e2calib/ input folder")
    args = ap.parse_args(argv)

    if args.e2vid:
        if not args.indir:
            ap.error("--e2vid requires --indir (the e2calib/ folder)")
        undistort_e2vid(args)
        return
    if not args.datadir:
        ap.error("--datadir is required (frame mode)")

    with open(args.calib) as f:
        intr = json.load(f)["intrinsics"][args.cam]
    imgs = sorted(glob.glob(os.path.join(args.datadir, args.img_glob)))
    if not imgs:
        raise SystemExit(f"no images matching {args.img_glob}")
    H, W = _read_color(imgs[0]).shape[:2]
    m1, m2, Knew, rectify_map = build_maps(intr, H, W, args.model)

    outdir = os.path.join(args.datadir, f"images_undistorted_{args.out_suffix}")
    os.makedirs(outdir, exist_ok=True)
    for p in imgs:
        und = camera.remap_linear(read_unchanged(p), m1, m2)
        write_image(os.path.join(outdir, os.path.basename(p)), und)

    write_rectify_map(os.path.join(args.datadir, f"rectify_map_{args.out_suffix}.h5"),
                      rectify_map)
    with open(os.path.join(args.datadir, f"calib_undist_{args.out_suffix}.json"), "w") as f:
        json.dump(_intrinsics_json(Knew), f, indent=2)
    print(f"undistorted {len(imgs)} images -> {outdir}; wrote rectify map + intrinsics")


if __name__ == "__main__":
    main()
