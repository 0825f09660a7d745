"""Run diagnostics: event accumulation images and pose plots.

Counterpart of enerf_tpu/utils/plotting.py (reference utils/plot_utils.py:
render_ev_accumulation :13, the pose visualizers :486-652 and the
workspace dumps of provider.py:760, 1126, 1353-1359).

The numeric images are computed with torch on the provider's device and
written by the port's PNG writer; their pixels equal the JAX package's
files (which it builds in BGR for cv2: here RGB).  The four plots need
matplotlib, which draws them headless where it imports; where it does not
(the card's Python), `dump_run_diagnostics` skips them and says so in one
entry of its list.
"""

import os

import numpy as np
import torch

from enerf_torch.utils.png import write_png

PLOTS = ("hf_trajectory.png", "ev_rate.png", "train_poses.png", "train_rays.png")


def render_ev_accumulation(xs, ys, pols, H, W):
    """Events into an RGB image [H, W, 3] uint8 (a tensor on xs's device):
    positive events red, negative blue, on white; a negative event wins a
    pixel that has both (reference plot_utils.py:13)."""
    xs, ys, pols = (torch.as_tensor(a) for a in (xs, ys, pols))
    img = torch.full((H, W, 3), 255, dtype=torch.uint8, device=xs.device)
    xs = xs.long().clamp(0, W - 1)
    ys = ys.long().clamp(0, H - 1)
    pos = pols > 0
    img[ys[pos], xs[pos]] = torch.tensor([255, 0, 0], dtype=torch.uint8, device=xs.device)
    img[ys[~pos], xs[~pos]] = torch.tensor([0, 0, 255], dtype=torch.uint8, device=xs.device)
    return img


def event_histogram(xs, ys, pols, H, W):
    """Signed event-count histogram [H, W] float64 (the sum of polarities
    per pixel), on xs's device."""
    xs, ys, pols = (torch.as_tensor(a) for a in (xs, ys, pols))
    flat = ys.long().clamp(0, H - 1) * W + xs.long().clamp(0, W - 1)
    hist = torch.zeros(H * W, dtype=torch.float64, device=xs.device)
    return hist.index_add_(0, flat, pols.double()).reshape(H, W)


def histogram_image(hist):
    """The histogram as uint8: 127.5 at zero, 0 / 255 at -max / +max."""
    mx = max(float(hist.abs().max()), 1.0)
    return ((hist / mx + 1.0) * 127.5).to(torch.uint8)


def noev_coverage(noev_coords, noev_count, H, W):
    """How often each pixel enters a no-event chunk [H, W] float32: the
    first noev_count[j] coordinates (x, y) of each chunk j."""
    coords = torch.as_tensor(noev_coords)
    count = torch.as_tensor(noev_count, device=coords.device).long()
    keep = torch.arange(coords.shape[1], device=coords.device)[None, :] < count[:, None]
    v = coords[keep].long()
    cov = torch.zeros(H * W, dtype=torch.float32, device=coords.device)
    flat = v[:, 1].clamp(0, H - 1) * W + v[:, 0].clamp(0, W - 1)
    return cov.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32)).reshape(H, W)


def coverage_image(cov):
    mx = max(float(cov.max()), 1.0)
    return (cov / mx * 255).to(torch.uint8)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, path, plt):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def plot_poses(path, poses, title="poses", axis_len=0.1, stride=1):
    """3D pose (camera frustum axes) plot written to `path` (png)."""
    plt = _pyplot()
    poses = np.asarray(poses)[::stride]
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    for p in poses:
        o = p[:3, 3]
        for k, c in zip(range(3), "rgb"):
            d = p[:3, k] * axis_len
            ax.plot([o[0], o[0] + d[0]], [o[1], o[1] + d[1]], [o[2], o[2] + d[2]], c)
    ax.scatter(poses[:, 0, 3], poses[:, 1, 3], poses[:, 2, 3], s=2, c="k")
    ax.set_title(title)
    return _save(fig, path, plt)


def plot_trajectory_timeline(path, ts, poses, title="trajectory"):
    """Per-axis translation curves over time; poses [N, 3] or [N, 3/4, 4]."""
    plt = _pyplot()
    poses = np.asarray(poses)
    trans = poses if poses.ndim == 2 else poses[:, :3, 3]
    fig, axes = plt.subplots(3, 1, figsize=(10, 6), sharex=True)
    for k, (axx, lbl) in enumerate(zip(axes, "xyz")):
        axx.plot(ts, trans[:, k])
        axx.set_ylabel(lbl)
    axes[0].set_title(title)
    return _save(fig, path, plt)


def plot_rays_in_box(path, poses, intrinsics, H, W, bound=1.0, n_side=3, length=3.0,
                     title="rays vs scene box"):
    """Central pixel rays from each pose drawn into the scene AABB."""
    plt = _pyplot()
    fx, fy, cx, cy = intrinsics
    poses = np.asarray(poses)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    b = float(bound)
    for s in (-b, b):
        for t in (-b, b):
            ax.plot([-b, b], [s, s], [t, t], "k-", lw=0.4)
            ax.plot([s, s], [-b, b], [t, t], "k-", lw=0.4)
            ax.plot([s, s], [t, t], [-b, b], "k-", lw=0.4)
    us = np.linspace(0.15, 0.85, n_side)
    for p in poses:
        o = p[:3, 3]
        for u in us:
            for v in us:
                d = np.array([(u * W - cx) / fx, (v * H - cy) / fy, 1.0])
                d = p[:3, :3] @ (d / np.linalg.norm(d))
                e = o + d * length
                ax.plot([o[0], e[0]], [o[1], e[1]], [o[2], e[2]], "b-", lw=0.3, alpha=0.5)
        ax.scatter(*o, s=4, c="r")
    ax.set_title(title)
    return _save(fig, path, plt)


def plot_event_rate(path, ts, bins=200, title="event rate"):
    """Events/s over the stream's duration; None for fewer than 2 events."""
    ts = np.asarray(ts, np.float64)
    if ts.size < 2:
        return None
    plt = _pyplot()
    counts, edges = np.histogram(ts, bins=bins)
    widths = np.diff(edges)
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(edges[:-1], counts / np.maximum(widths, 1e-12), width=widths, align="edge")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("events/s")
    ax.set_title(title)
    return _save(fig, path, plt)


def _has_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def dump_run_diagnostics(workspace, provider):
    """Per-run dataset diagnostics into workspace/diagnostics (the role of
    the reference's automatic plot dumps).  Returns the paths written, plus
    a "(skipped: ...)" entry naming the plots when matplotlib is missing
    and a "(failed: ...)" entry for an error: diagnostics never fail a run."""
    ddir = os.path.join(workspace, "diagnostics")
    os.makedirs(ddir, exist_ok=True)
    written = []
    plots = _has_matplotlib()
    if not plots:
        written.append("(skipped: no matplotlib, so no " + ", ".join(PLOTS) + ")")
    try:
        if hasattr(provider, "chains"):  # event provider
            ch, H, W = provider.chains, provider.H, provider.W
            p = os.path.join(ddir, "ev_accumulation.png")
            write_png(p, render_ev_accumulation(ch.xs, ch.ys, ch.pols, H, W).cpu().numpy())
            written.append(p)
            p = os.path.join(ddir, "ev_histogram.png")
            write_png(p, histogram_image(event_histogram(ch.xs, ch.ys, ch.pols, H, W)).cpu().numpy())
            written.append(p)
            if plots:
                written.append(plot_trajectory_timeline(
                    os.path.join(ddir, "hf_trajectory.png"), _host(provider.key_ts),
                    _host(provider.key_trans), title="pose keyframes (hf)"))
                p = plot_event_rate(os.path.join(ddir, "ev_rate.png"), _host(ch.ts))
                if p:
                    written.append(p)
            # negative-sampling coverage: which pixels ever enter a
            # no-event chunk
            if getattr(provider, "noev_coords", None) is not None:
                p = os.path.join(ddir, "noev_coverage.png")
                cov = noev_coverage(provider.noev_coords, provider.noev_count, H, W)
                write_png(p, coverage_image(cov).cpu().numpy())
                written.append(p)
        if plots and getattr(provider, "train_poses", None) is not None:
            written.append(plot_poses(os.path.join(ddir, "train_poses.png"),
                                      _host(provider.train_poses), title="train poses"))
            if getattr(provider, "intrinsics", None) is not None:
                written.append(plot_rays_in_box(
                    os.path.join(ddir, "train_rays.png"), _host(provider.train_poses)[:8],
                    provider.intrinsics, provider.H, provider.W))
    except Exception as e:  # diagnostics must never kill training
        written.append(f"(failed: {type(e).__name__}: {e})")
    return written
