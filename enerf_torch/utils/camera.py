"""OpenCV's camera models and bilinear remap in float64 numpy, for the
dataset tools (the card's Python has no OpenCV).

Each function is the counterpart of one cv2 call of the undistortion tool
(scripts/undistort_images.py):
  - radtan (OpenCV's k1 k2 p1 p2 [k3]): `get_optimal_new_camera_matrix`
    (alpha 0 .. 1: the inscribed / circumscribed rectangle of a 9 x 9 grid
    of undistorted points), `init_undistort_rectify_map` (CV_32FC1 maps)
    and `undistort_points` (cv2's default criteria: exactly 5 fixed-point
    iterations, not run to convergence; a negative radial factor falls
    back to the distorted point, as cv2 does);
  - fisheye (equidistant k1..k4): `fisheye_estimate_new_camera_matrix`
    (the four edge midpoints, aspect ratio, balance blend, fov_scale 1),
    `fisheye_init_undistort_rectify_map` and `fisheye_undistort_points`
    (Newton on theta, at most 10 iterations, eps 1e-8; (-1e6, -1e6) where
    theta flips sign or does not converge);
  - `remap_linear`: cv2.remap(..., INTER_LINEAR, BORDER_CONSTANT 0) with
    float maps, as OpenCV 5 computes it: float32 with fused multiply-adds;
  - `undistort`: cv2.undistort of uint8 images, which builds CV_16SC2
    maps and so remaps in fixed point: the map in double rounded to 1/32
    pixel, weights from the 32 x 32 bilinear table scaled to 1 << 15,
    taps outside reading 0.
Points come in and go out as cv2 takes and gives them: [N, 1, 2] (or
[N, 2]), float32 in -> float32 out, float64 in -> float64 out.
"""

import numpy as np

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS
FISHEYE_SENTINEL = -1000000.0


def _K(K):
    K = np.asarray(K, np.float64)
    return K[0, 0], K[1, 1], K[0, 2], K[1, 2]


def _radtan_coeffs(D):
    """cv2's 14-term layout from 4, 5 or 8 coefficients."""
    k = np.zeros(14)
    d = np.asarray(D, np.float64).reshape(-1)
    if len(d) not in (4, 5, 8):
        raise ValueError(f"radtan takes 4, 5 or 8 coefficients, got {len(d)}")
    k[:len(d)] = d
    return k


def _as_points(pts):
    a = np.asarray(pts)
    return a.reshape(-1, 2).astype(np.float64), a.shape, a.dtype


def _out_points(xy, shape, dtype):
    out_dtype = np.float32 if dtype == np.float32 else np.float64
    return xy.astype(out_dtype).reshape(shape)


def _rr(R, P):
    RR = np.eye(3) if R is None else np.asarray(R, np.float64).reshape(3, 3)
    if P is not None:
        RR = np.asarray(P, np.float64)[:3, :3] @ RR
    return RR


def undistort_points(pts, K, D, R=None, P=None, iters=5):
    """cv2.undistortPoints(pts, K, D, R=R, P=P) for the radtan model."""
    xy, shape, dtype = _as_points(pts)
    fx, fy, cx, cy = _K(K)
    k = _radtan_coeffs(D)
    u, v = xy[:, 0], xy[:, 1]
    x0 = (u - cx) * (1.0 / fx)
    y0 = (v - cy) * (1.0 / fy)
    x, y = x0.copy(), y0.copy()
    live = np.ones(len(x), bool)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                  / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
        # a negative factor stops the point at its distorted position
        stop = live & (icdist < 0)
        x[stop], y[stop] = x0[stop], y0[stop]
        live &= ~stop
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2 + k[9] * r2 * r2
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2 + k[11] * r2 * r2
        x = np.where(live, (x0 - dx) * icdist, x)
        y = np.where(live, (y0 - dy) * icdist, y)
    RR = _rr(R, P)
    xx = RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]
    yy = RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]
    ww = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
    return _out_points(np.stack([xx * ww, yy * ww], -1), shape, dtype)


def get_optimal_new_camera_matrix(K, D, size, alpha=0.0):
    """cv2.getOptimalNewCameraMatrix(K, D, (W, H), alpha)[0] (new size =
    size, principal point not centred)."""
    W, H = size
    N = 9
    gx, gy = np.meshgrid(np.arange(N, dtype=np.float64), np.arange(N, dtype=np.float64))
    grid = np.stack([gx * (W - 1) / (N - 1), gy * (H - 1) / (N - 1)], -1).reshape(-1, 2)
    p = undistort_points(grid, K, D).reshape(N, N, 2)
    ix0, ix1 = p[:, 0, 0].max(), p[:, N - 1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[N - 1, :, 1].min()
    ox0, ox1 = p[..., 0].min(), p[..., 0].max()
    oy0, oy1 = p[..., 1].min(), p[..., 1].max()
    fx0, fy0 = (W - 1) / (ix1 - ix0), (H - 1) / (iy1 - iy0)
    fx1, fy1 = (W - 1) / (ox1 - ox0), (H - 1) / (oy1 - oy0)
    cx0, cy0 = -fx0 * ix0, -fy0 * iy0
    cx1, cy1 = -fx1 * ox0, -fy1 * oy0
    M = np.eye(3)
    M[0, 0] = fx0 * (1 - alpha) + fx1 * alpha
    M[1, 1] = fy0 * (1 - alpha) + fy1 * alpha
    M[0, 2] = cx0 * (1 - alpha) + cx1 * alpha
    M[1, 2] = cy0 * (1 - alpha) + cy1 * alpha
    return M


def _pixel_rays(P, R, size):
    """Per destination pixel: iR @ (j, i, 1) with iR = inv(P @ R)."""
    W, H = size
    iR = np.linalg.inv(np.asarray(P, np.float64)[:3, :3] @ (np.eye(3) if R is None
                                                           else np.asarray(R, np.float64)))
    j, i = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    return (iR[0, 0] * j + iR[0, 1] * i + iR[0, 2], iR[1, 0] * j + iR[1, 1] * i + iR[1, 2],
            iR[2, 0] * j + iR[2, 1] * i + iR[2, 2])


def _radtan_map(K, D, R, P, size):
    """The undistort map in float64 (u, v) [H, W]."""
    fx, fy, u0, v0 = _K(K)
    k = _radtan_coeffs(D)
    X, Y, Wd = _pixel_rays(P, R, size)
    w = 1.0 / Wd
    x, y = X * w, Y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2) / (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
    u = fx * (x * kr + k[2] * _2xy + k[3] * (r2 + 2 * x2) + k[8] * r2 + k[9] * r2 * r2) + u0
    v = fy * (y * kr + k[2] * (r2 + 2 * y2) + k[3] * _2xy + k[10] * r2 + k[11] * r2 * r2) + v0
    return u, v


def init_undistort_rectify_map(K, D, R, P, size):
    """cv2.initUndistortRectifyMap(K, D, R, P, (W, H), CV_32FC1) -> (map1,
    map2) float32 [H, W]."""
    u, v = _radtan_map(K, D, R, P, size)
    return u.astype(np.float32), v.astype(np.float32)


# ----------------------------------------------------------------------------
# fisheye (equidistant)


def _fisheye_k(D):
    d = np.asarray(D, np.float64).reshape(-1)
    if len(d) != 4:
        raise ValueError(f"fisheye takes 4 coefficients, got {len(d)}")
    return d


def fisheye_undistort_points(pts, K, D, R=None, P=None, max_iter=10, eps=1e-8):
    """cv2.fisheye.undistortPoints(pts, K, D, R=R, P=P)."""
    xy, shape, dtype = _as_points(pts)
    fx, fy, cx, cy = _K(K)
    k = _fisheye_k(D)
    pwx = (xy[:, 0] - cx) / fx
    pwy = (xy[:, 1] - cy) / fy
    theta_d = np.sqrt(pwx * pwx + pwy * pwy)
    theta_d = np.minimum(np.maximum(-np.pi / 2.0, theta_d), np.pi / 2.0)
    theta = theta_d.copy()
    solve = np.abs(theta_d) > eps
    converged = ~solve
    active = solve.copy()
    for _ in range(max_iter):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t6 * t2
        k0t2, k1t4, k2t6, k3t8 = k[0] * t2, k[1] * t4, k[2] * t6, k[3] * t8
        fix = ((theta * (1 + k0t2 + k1t4 + k2t6 + k3t8) - theta_d)
               / (1 + 3 * k0t2 + 5 * k1t4 + 7 * k2t6 + 9 * k3t8))
        theta = np.where(active, theta - fix, theta)
        done = active & (np.abs(fix) < eps)
        converged |= done
        active &= ~done
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(solve, np.tan(theta) / theta_d, 0.0)
    flipped = ((theta_d < 0) & (theta > 0)) | ((theta_d > 0) & (theta < 0))
    ok = converged & ~flipped
    pux, puy = pwx * scale, pwy * scale
    RR = _rr(R, P)
    prx = RR[0, 0] * pux + RR[0, 1] * puy + RR[0, 2]
    pry = RR[1, 0] * pux + RR[1, 1] * puy + RR[1, 2]
    prz = RR[2, 0] * pux + RR[2, 1] * puy + RR[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.stack([prx / prz, pry / prz], -1)
    out[~ok] = FISHEYE_SENTINEL
    return _out_points(out, shape, dtype)


def fisheye_estimate_new_camera_matrix(K, D, size, R=None, balance=0.0, fov_scale=1.0):
    """cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(K, D, (W, H),
    R, balance=balance) (new size = size)."""
    w, h = size
    balance = min(max(balance, 0.0), 1.0)
    pts = np.array([[w // 2, 0], [w, h // 2], [w // 2, h], [0, h // 2]], np.float64)
    pts = fisheye_undistort_points(pts, K, D, R=R)
    cn = pts.mean(axis=0)
    K = np.asarray(K, np.float64)
    aspect = K[0, 0] / K[1, 1]
    cn[1] *= aspect
    pts[:, 1] *= aspect
    minx, maxx = pts[:, 0].min(), pts[:, 0].max()
    miny, maxy = pts[:, 1].min(), pts[:, 1].max()
    f1 = w * 0.5 / (cn[0] - minx)
    f2 = w * 0.5 / (maxx - cn[0])
    f3 = h * 0.5 * aspect / (cn[1] - miny)
    f4 = h * 0.5 * aspect / (maxy - cn[1])
    fmin = min(f1, min(f2, min(f3, f4)))
    fmax = max(f1, max(f2, max(f3, f4)))
    f = balance * fmin + (1.0 - balance) * fmax
    f *= 1.0 / fov_scale if fov_scale > 0 else 1.0
    new_f = np.array([f, f])
    new_c = -cn * f + np.array([w, h * aspect]) * 0.5
    new_f[1] /= aspect
    new_c[1] /= aspect
    return np.array([[new_f[0], 0, new_c[0]], [0, new_f[1], new_c[1]], [0, 0, 1.0]])


def _fisheye_map(K, D, R, P, size):
    fx, fy, cx, cy = _K(K)
    k = _fisheye_k(D)
    X, Y, Wd = _pixel_rays(P, R, size)
    with np.errstate(divide="ignore", invalid="ignore"):
        x, y = X / Wd, Y / Wd
        r = np.sqrt(x * x + y * y)
        theta = np.arctan(r)
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        theta_d = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t6 + k[3] * t8)
        scale = np.where(r == 0, 1.0, theta_d / r)
    u = fx * x * scale + cx
    v = fy * y * scale + cy
    behind = Wd <= 0
    u = np.where(behind, np.where(X > 0, -np.inf, np.inf), u)
    v = np.where(behind, np.where(Y > 0, -np.inf, np.inf), v)
    return u, v


def fisheye_init_undistort_rectify_map(K, D, R, P, size):
    """cv2.fisheye.initUndistortRectifyMap(K, D, R, P, (W, H), CV_32FC1)."""
    u, v = _fisheye_map(K, D, R, P, size)
    return u.astype(np.float32), v.astype(np.float32)


# ----------------------------------------------------------------------------
# remap


def _bilinear_table():
    """cv2's 32 x 32 bilinear table in 1 << 15 fixed point: entry
    (ty * 32 + tx) holds the weights of (y0x0, y0x1, y1x0, y1x1).  The
    products of multiples of 1/32 are exact, so no entry needs cv2's
    adjustment to a sum of 32768."""
    t = np.arange(INTER_TAB_SIZE, dtype=np.int64)
    ty, tx = t[:, None], t[None, :]
    w = [(32 - ty) * (32 - tx), (32 - ty) * tx, ty * (32 - tx), ty * tx]
    return (np.stack([np.broadcast_to(x, (32, 32)) for x in w], -1) * 32).reshape(-1, 4)


_WI = _bilinear_table()


def _fixed_point(u, v):
    """cv2's CV_16SC2 map of float64 coordinates: each rounded (half to
    even) to 1/32 pixel, split into the integer pixel (saturated to int16)
    and the bilinear table's index.  A NaN takes the border."""
    X, Y = (np.clip(np.rint(np.where(np.isnan(m), 0, m) * INTER_TAB_SIZE), -(2 ** 31),
                    2 ** 31 - 1).astype(np.int64) for m in (u, v))
    sx = np.clip(X >> INTER_BITS, -32768, 32767)
    sy = np.clip(Y >> INTER_BITS, -32768, 32767)
    a = (Y & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE + (X & (INTER_TAB_SIZE - 1))
    return sx, sy, a


def _remap_fixed(img, sx, sy, a):
    """The fixed-point bilinear remap of uint8 images (taps outside read 0)."""
    src = np.asarray(img)
    if src.dtype != np.uint8:
        raise TypeError(f"undistort takes uint8 images, got {src.dtype}")
    H, W = src.shape[:2]
    chans = src.reshape(H, W, -1)
    w = _WI[a]
    acc = 0
    for i, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        xx, yy = sx + dx, sy + dy
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        v = chans[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)].astype(np.int64)
        acc = acc + np.where(inside[..., None], v, 0) * w[..., i:i + 1]
    out = np.clip((acc + (1 << 14)) >> 15, 0, 255).astype(np.uint8)
    return out.reshape(sx.shape + src.shape[2:])


def _fma32(a, b, c):
    """fmaf(a, b, c) on float32 arrays: the product is exact in float64, so
    one rounding to float32 follows (a double rounding could differ from
    fmaf only on an exact float32 tie of the float64 sum)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def remap_linear(img, map1, map2):
    """cv2.remap(img, map1, map2, cv2.INTER_LINEAR) with float32 [H, W]
    maps and BORDER_CONSTANT 0, on uint8 or uint16 [h, w] / [h, w, C]
    images.  OpenCV 5's remap with float maps interpolates in float32 with
    fused multiply-adds, along x then y, from the floor of each coordinate
    (taps outside the image, and non-finite coordinates, read 0), and
    rounds half to even."""
    src = np.asarray(img)
    if src.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"remap_linear takes uint8 or uint16 images, got {src.dtype}")
    h, w = src.shape[:2]
    chans = src.reshape(h, w, -1).astype(np.float32)
    mx = np.asarray(map1, np.float32)
    my = np.asarray(map2, np.float32)
    finite = np.isfinite(mx) & np.isfinite(my)
    mx, my = np.where(finite, mx, 0), np.where(finite, my, 0)
    x0, y0 = np.floor(mx), np.floor(my)
    ix = np.clip(x0, -(2 ** 40), 2 ** 40).astype(np.int64)
    iy = np.clip(y0, -(2 ** 40), 2 ** 40).astype(np.int64)
    alpha, beta = (mx - x0)[..., None], (my - y0)[..., None]

    def tap(dx, dy):
        xx, yy = ix + dx, iy + dy
        inside = finite & (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = chans[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, np.float32(0))

    p00, p01, p10, p11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
    v0 = _fma32(alpha, p01 - p00, p00)
    v1 = _fma32(alpha, p11 - p10, p10)
    v = _fma32(beta, v1 - v0, v0)
    hi = 255 if src.dtype == np.uint8 else 65535
    out = np.clip(np.rint(v), 0, hi).astype(src.dtype)
    return out.reshape(mx.shape + src.shape[2:])


def undistort(img, K, D, Knew):
    """cv2.undistort(img, K, D, newCameraMatrix=Knew) (radtan): the map in
    double, rounded to 1/32 pixel as its CV_16SC2 maps are, then the
    fixed-point bilinear remap."""
    H, W = np.asarray(img).shape[:2]
    u, v = _radtan_map(K, D, None, Knew, (W, H))
    return _remap_fixed(img, *_fixed_point(u, v))
