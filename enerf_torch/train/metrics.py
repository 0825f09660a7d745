"""Evaluation metrics: PSNR, SSIM, the affine log-intensity correction, LPIPS.

The port's own copy of the numpy code of enerf_tpu/train/metrics.py
(reference nerf/utils.py:44-71, 252-287; skimage SSIM):
  - `psnr` and `PSNRMeter` (max value 1.0);
  - `ssim`, skimage.metrics.structural_similarity's defaults (uniform 7x7
    window, K1 = 0.01, K2 = 0.03, sample covariance);
  - `solve_normal_equations`, the least-squares affine (a, b) that maps the
    predicted log intensity onto the ground truth's over all val images,
    with the reference's nan fallbacks: event-only training is supervised
    only up to an affine map in log space.
  - `compute_lpips` (alex, vgg) through the port's own LPIPS
    (train/lpips.py) on the caller's device, and `lpips_label`: '' with
    calibrated weights, '_rand' with the seeded random features (the port's
    own seeds: its `_rand` values are not the JAX package's).
"""

import numpy as np
from scipy.ndimage import uniform_filter

from enerf_torch.backend import resolve_device
from enerf_torch.train.lpips import lpips_distance, lpips_is_calibrated  # noqa: F401


def psnr(pred, gt, max_val=1.0):
    """Mean PSNR over the whole array (reference PSNRMeter.update)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    mse = np.mean((pred - gt) ** 2)
    if mse == 0:
        return np.inf
    return -10.0 * np.log10(mse) + 20.0 * np.log10(max_val)


def ssim(img0, img1, data_range=1.0, win_size=7):
    """Structural similarity of [H, W] or [H, W, C] float arrays (the mean
    over channels for [H, W, C])."""
    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    if img0.ndim == 3:
        return float(np.mean([ssim(img0[..., c], img1[..., c], data_range, win_size)
                              for c in range(img0.shape[-1])]))
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)  # sample covariance, skimage's default

    def filt(x):
        return uniform_filter(x, size=win_size)

    ux, uy = filt(img0), filt(img1)
    uxx, uyy, uxy = filt(img0 * img0), filt(img1 * img1), filt(img0 * img1)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def solve_normal_equations(preds_log, gts_log):
    """Least-squares fit gts_log ~= a * preds_log + b over arrays of one
    shape -> (a, b); a nan a or b becomes 5.0 (reference utils.py:61-69)."""
    x = np.asarray(preds_log, np.float64).reshape(-1)
    y = np.asarray(gts_log, np.float64).reshape(-1)
    X = np.stack([np.ones_like(x), x], axis=1)
    try:
        b, a = np.linalg.inv(X.T @ X) @ (X.T @ y)
    except np.linalg.LinAlgError:
        a, b = np.nan, np.nan
    if np.isnan(b):
        b = 5.0
    if np.isnan(a):
        a = 5.0
    return float(a), float(b)


def compute_lpips(pred, gt, rgb_channels=3, device=None):
    """(alex, vgg) LPIPS of two [H, W, C] images in [0, 1] (reference
    utils.py:40-41, 1096-1112), on `device` (None: the card).  Grayscale
    (rgb_channels 1) is replicated to 3 channels, as the reference does."""
    device = resolve_device(device)
    return (lpips_distance(pred, gt, "alex", device), lpips_distance(pred, gt, "vgg", device))


def lpips_label():
    """Suffix of the eval keys: '' for calibrated weights, '_rand' for the
    seeded random features."""
    return "" if lpips_is_calibrated() else "_rand"


class PSNRMeter:
    """Running-mean PSNR (reference utils.py:252-287)."""

    def __init__(self):
        self.V = 0.0
        self.N = 0

    def clear(self):
        self.V, self.N = 0.0, 0

    def update(self, preds, truths):
        self.V += psnr(preds, truths)
        self.N += 1

    def measure(self):
        return self.V / max(self.N, 1)

    def report(self):
        return f"PSNR = {self.measure():.6f}"
