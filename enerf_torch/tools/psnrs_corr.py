"""Offline affine-corrected PSNR and SSIM of saved raw renders against GT
images.

Counterpart of scripts/psnrs_corr.py (reference scripts/psnrs_corr.py):
recomputes the event-only (a, b) log-correction metrics from a
workspace's renders without rendering again, with the port's metrics and
image readers (no OpenCV):

  python -m enerf_torch.tools.psnrs_corr --pred_dir WS/validation/raw --gt_dir GTS/

pairs the sorted *.npy predictions (gray, or RGB taken to luma) with the
sorted *.png GT images (read as cv2's IMREAD_GRAYSCALE), fits
log(gt) ~ a * log(pred) + b over all of them and prints a, b and the mean
corrected PSNR and SSIM.
"""

import argparse
import glob
import os

import numpy as np

from enerf_torch.data.provider import read_gray
from enerf_torch.train.metrics import psnr, solve_normal_equations, ssim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_dir", required=True, help="dir of *_raw.npy or *.npy preds")
    ap.add_argument("--gt_dir", required=True, help="dir of gt pngs")
    args = ap.parse_args(argv)

    preds = sorted(glob.glob(os.path.join(args.pred_dir, "*.npy")))
    gts = sorted(glob.glob(os.path.join(args.gt_dir, "*.png")))
    if not preds or len(preds) != len(gts):
        raise SystemExit(f"{len(preds)} predictions (*.npy) and {len(gts)} GT images (*.png): "
                         "need as many of each, and at least one")

    p_list, g_list = [], []
    for pp, gp in zip(preds, gts):
        p = np.load(pp)
        g = read_gray(gp).astype(np.float32) / 255.0
        if p.ndim == 3 and p.shape[-1] == 3:
            p = p @ np.asarray([0.299, 0.587, 0.114], np.float32)
        p_list.append(np.log(255.0 * p.reshape(g.shape) + 1e-3))
        g_list.append(np.log(255.0 * g + 1e-3))

    a, b = solve_normal_equations(np.stack(p_list), np.stack(g_list))
    print(f"affine correction: a={a:.4f} b={b:.4f}")
    psnrs, ssims = [], []
    for pl, gl in zip(p_list, g_list):
        pc = np.exp(pl * a + b)
        gt255 = np.exp(gl)
        psnrs.append(psnr(pc, gt255, max_val=255.0))
        ssims.append(ssim(pc, gt255, data_range=255.0))
    print(f"psnr-corrected mean = {np.mean(psnrs):.4f}")
    print(f"ssim-corrected mean = {np.mean(ssims):.4f}")
    return a, b, float(np.mean(psnrs)), float(np.mean(ssims))


if __name__ == "__main__":
    main()
