"""The port's camera models and remap (enerf_torch/utils/camera.py)
against the cv2 calls of scripts/undistort_images.py: radtan with 4 and 5
terms (EDS-like), fisheye at balance 0 and 0.5 (TUM-VIE-like), on a
48 x 64 and a 96 x 128 camera.  Knew within 1e-6 relative, maps and
points within 1e-3 px where cv2's are finite and not the fisheye
sentinel (the sentinel at the same pixels), remap and undistort
bit-equal."""

import cv2
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch.utils import camera

SIZES = [(48, 64), (96, 128)]
# EDS-like radtan (k1 k2 p1 p2 [k3]) and TUM-VIE-like equidistant (k1..k4);
# the strong fisheye set drives the Newton solve past 90 degrees at the corners
RADTAN = {"radtan4": [-0.36, 0.14, 0.0008, -0.0011],
          "radtan5": [-0.33, 0.12, 0.0005, 0.0012, -0.021]}
FISHEYE = {"tumvie": [0.0348, -0.0101, 0.0037, -0.0011],
           "strong": [0.5, -0.3, 0.4, -0.6]}


def _K(H, W, f):
    return np.array([[f * W, 0, W / 2 - 0.37], [0, f * W * 1.003, H / 2 + 0.61], [0, 0, 1]])


def _grid(H, W):
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    return np.stack([xs, ys], -1).reshape(-1, 1, 2)


def _images(H, W, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W), np.uint8), rng.integers(0, 256, (H, W, 3), np.uint8),
            rng.integers(0, 256, (H, W, 4), np.uint8), rng.integers(0, 65536, (H, W), np.uint16),
            rng.integers(0, 65536, (H, W, 3), np.uint16)]


def _close_rel(a, b, rtol=1e-6):
    assert np.abs(a - b).max() <= rtol * np.abs(b).max(), (a, b)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("model", list(RADTAN))
def test_radtan_matches_cv2(size, model):
    H, W = size
    K, D = _K(H, W, 0.8), np.asarray(RADTAN[model])
    for alpha in (0.0, 1.0):
        ref, _ = cv2.getOptimalNewCameraMatrix(K, D, (W, H), alpha)
        _close_rel(camera.get_optimal_new_camera_matrix(K, D, (W, H), alpha), ref)
    Knew, _ = cv2.getOptimalNewCameraMatrix(K, D, (W, H), 0)
    m1r, m2r = cv2.initUndistortRectifyMap(K, D, np.eye(3), Knew, (W, H), cv2.CV_32FC1)
    m1, m2 = camera.init_undistort_rectify_map(K, D, np.eye(3), Knew, (W, H))
    assert m1.dtype == np.float32 and m1.shape == (H, W)
    assert np.abs(m1 - m1r).max() < 1e-3 and np.abs(m2 - m2r).max() < 1e-3
    # the rectify map: 5 fixed-point iterations, float32 in and out
    pr = cv2.undistortPoints(_grid(H, W), K, D, R=np.eye(3), P=Knew)
    p = camera.undistort_points(_grid(H, W), K, D, R=np.eye(3), P=Knew)
    assert p.dtype == np.float32 and p.shape == pr.shape
    assert np.abs(p - pr).max() < 1e-3
    # normalized points (no P), float64
    pts = np.random.default_rng(0).uniform(0, W, (50, 1, 2))
    np.testing.assert_allclose(camera.undistort_points(pts, K, D),
                               cv2.undistortPoints(pts, K, D), atol=1e-9)
    # remap on cv2's own maps, and cv2.undistort
    for i, img in enumerate(_images(H, W, seed=W)):
        np.testing.assert_array_equal(camera.remap_linear(img, m1r, m2r),
                                      cv2.remap(img, m1r, m2r, cv2.INTER_LINEAR))
        if img.dtype == np.uint8:
            np.testing.assert_array_equal(camera.undistort(img, K, D[:4], Knew),
                                          cv2.undistort(img, K, D[:4], newCameraMatrix=Knew))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("balance", [0.0, 0.5])
@pytest.mark.parametrize("model", list(FISHEYE))
def test_fisheye_matches_cv2(size, balance, model):
    H, W = size
    K, D = _K(H, W, 0.6), np.asarray(FISHEYE[model])
    ref = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(K, D, (W, H), np.eye(3),
                                                                 balance=balance)
    Knew = camera.fisheye_estimate_new_camera_matrix(K, D, (W, H), np.eye(3), balance=balance)
    _close_rel(Knew, ref)
    m1r, m2r = cv2.fisheye.initUndistortRectifyMap(K, D, np.eye(3), ref, (W, H), cv2.CV_32FC1)
    m1, m2 = camera.fisheye_init_undistort_rectify_map(K, D, np.eye(3), ref, (W, H))
    fin = np.isfinite(m1r) & np.isfinite(m2r)
    assert np.array_equal(np.isfinite(m1) & np.isfinite(m2), fin)
    assert np.abs(m1 - m1r)[fin].max() < 1e-3 and np.abs(m2 - m2r)[fin].max() < 1e-3
    pr = cv2.fisheye.undistortPoints(_grid(H, W), K, D, R=np.eye(3), P=ref)
    p = camera.fisheye_undistort_points(_grid(H, W), K, D, R=np.eye(3), P=ref)
    assert p.dtype == np.float32 and p.shape == pr.shape
    sent = (pr == camera.FISHEYE_SENTINEL).all(-1)
    assert np.array_equal((p == camera.FISHEYE_SENTINEL).all(-1), sent)
    if model == "strong":
        assert sent.any()  # the strong model leaves the sentinel at the corners
    assert np.abs(p - pr)[~sent].max() < 1e-3
    for img in _images(H, W, seed=H):
        np.testing.assert_array_equal(camera.remap_linear(img, m1r, m2r),
                                      cv2.remap(img, m1r, m2r, cv2.INTER_LINEAR))


def test_remap_border_and_non_finite_coordinates():
    """Taps outside the image read 0; maps past the edges, negative and
    non-finite coordinates remap as cv2 does."""
    rng = np.random.default_rng(3)
    H, W = 20, 30
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    m1 = rng.uniform(-3, W + 3, (H, W)).astype(np.float32)
    m2 = rng.uniform(-3, H + 3, (H, W)).astype(np.float32)
    m1[0, :4] = [np.inf, -np.inf, np.nan, 1e9]
    np.testing.assert_array_equal(camera.remap_linear(img, m1, m2),
                                  cv2.remap(img, m1, m2, cv2.INTER_LINEAR))
