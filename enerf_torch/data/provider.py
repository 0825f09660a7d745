"""Dataset providers: event supervision + frame views, device-resident.

Counterpart of enerf_tpu/data/provider.py (reference nerf/provider.py).
This port has the synthetic branch of `make_providers`, the
`EventProvider` for event-only training (per-event poses precomputed on
the host, or interpolated on the device per batch with
precompute_evs_poses=0), its no-event pairs (negative_event_sampling), and
the `FramesProvider` as the source of validation and test views.
Everything a step samples lives on the provider's device, and every draw
comes from the caller's torch.Generator, so a batch costs no host-device
transfer and no sync.
"""

import numpy as np
import torch

from enerf_torch.data import synthetic
from enerf_torch.data.events import build_event_chains, sample_event_batch
from enerf_torch.data.poses import interp_pose_device, make_pose_interpolator, mat_to_quat_np
from enerf_torch.data.rays import get_event_rays


class FramesProvider:
    """Frame views (reference NeRFDataset); the port uses it for val and
    test views."""

    def __init__(self, images, poses, intrinsics):
        self.poses = np.asarray(poses, np.float32)
        self.intrinsics = intrinsics
        self.H, self.W = images.shape[1:3]
        self._images_np = images

    def val_views(self):
        return [{"pose": self.poses[i], "intrinsics": self.intrinsics,
                 "H": self.H, "W": self.W, "gt": self._images_np[i]}
                for i in range(len(self._images_np))]

    def test_views(self):
        return self.val_views()


def noev_arrays(events, H, W, chunk_frac=0.05):
    """Per time chunk, the pixels with no event in it (reference
    provider.py:1281-1351), padded to one array: (coords [J, Pmax, 2] f32
    (x, y), counts [J] int32, t0 [J] f32, t1 [J] f32).  A chunk's row is its
    pixel list tiled up to Pmax, so a draw below its count is uniform."""
    ev = np.asarray(events)
    t0, t1 = float(ev[:, 2].min()), float(ev[:, 2].max())
    n_chunks = max(int(1.0 / chunk_frac), 1)
    edges = np.linspace(t0, t1, n_chunks + 1)
    chunk_of = np.clip(np.searchsorted(edges, ev[:, 2], side="right") - 1, 0, n_chunks - 1)
    all_pix = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).reshape(-1, 2)
    coords = []
    for j in range(n_chunks):
        m = chunk_of == j
        has = np.zeros(H * W, bool)
        pix = ev[m, 1].astype(np.int64) * W + ev[m, 0].astype(np.int64)
        has[np.clip(pix, 0, H * W - 1)] = True
        coords.append(all_pix[~has].astype(np.float32))
    counts = [len(c) for c in coords]
    pmax = max(max(counts), 1)
    pad = np.zeros((n_chunks, pmax, 2), np.float32)
    for j, c in enumerate(coords):
        if len(c):
            pad[j] = np.tile(c, (-(-pmax // len(c)), 1))[:pmax]
    return (pad, np.asarray(counts, np.int32), edges[:-1].astype(np.float32),
            edges[1:].astype(np.float32))


class EventProvider:
    """Event-supervision provider (reference EventNeRFDataset) for one event
    stream: per-pixel chains built once on the host, batches sampled on
    `device`."""

    def __init__(self, events, hf_ts, hf_poses, intrinsics, H, W, batch_size_evs=4096,
                 accumulate_evs=False, acc_max_num_evs=0, steps_per_epoch=100,
                 precompute_evs_poses=True, negative_event_sampling=False,
                 noev_chunk_frac=0.05, device="cpu"):
        self.device = torch.device(device)
        self.chains, ev_ts_sorted = build_event_chains(events, device=self.device)
        # keyframe poses as (quat, trans) for the device interpolation
        hf_poses = np.asarray(hf_poses, np.float64)
        self.key_ts = torch.as_tensor(np.asarray(hf_ts, np.float64), dtype=torch.float32,
                                      device=self.device)
        self.key_quats = torch.as_tensor(mat_to_quat_np(hf_poses[:, :3, :3]),
                                         dtype=torch.float32, device=self.device)
        self.key_trans = torch.as_tensor(hf_poses[:, :3, 3], dtype=torch.float32,
                                         device=self.device)
        self.poses_evs = None
        if precompute_evs_poses:
            # exact host Slerp + cubic per event (48 bytes/event on the device)
            interp = make_pose_interpolator(hf_ts, hf_poses)
            self.poses_evs = torch.as_tensor(interp(ev_ts_sorted), device=self.device)
        self.noev_coords = None
        if negative_event_sampling and len(events):
            arrs = noev_arrays(events, H, W, noev_chunk_frac)
            self.noev_coords, self.noev_count, self.noev_t0, self.noev_t1 = (
                torch.as_tensor(a, device=self.device) for a in arrs)
        self.use_no_ev = True  # the trainer's epoch gate (epoch_start_noEvLoss)
        self.intrinsics = intrinsics
        self.H, self.W = H, W
        self.batch_size_evs = batch_size_evs
        self.accumulate_evs = accumulate_evs
        self.acc_max_num_evs = acc_max_num_evs
        self.steps_per_epoch = steps_per_epoch

    def _event_poses(self, idx):
        """Poses of flat event indices: the precomputed gather or the device
        interpolation (precompute_evs_poses=0)."""
        if self.poses_evs is not None:
            return self.poses_evs[idx]
        return interp_pose_device(self.key_ts, self.key_quats, self.key_trans,
                                  self.chains.ts[idx])

    def _no_event_rays(self, generator):
        """batch_size_evs // 2 pixel rays without events, at two sorted random
        times of one random chunk (reference provider.py:1443-1486)."""
        dev, n_no = self.device, self.batch_size_evs // 2
        j = torch.randint(0, self.noev_coords.shape[0], (1,), device=dev, generator=generator)
        count = self.noev_count[j].long().clamp(min=1)
        sel = (torch.rand(n_no, device=dev, generator=generator) * count).long()
        xy = self.noev_coords[j, torch.minimum(sel, count - 1)]  # [n_no, 2]
        u = torch.rand(n_no, 2, device=dev, generator=generator)
        tt = (self.noev_t0[j] + (self.noev_t1[j] - self.noev_t0[j]) * u).sort(dim=1).values
        p1, p2 = (interp_pose_device(self.key_ts, self.key_quats, self.key_trans, tt[:, i])
                  for i in (0, 1))
        rays = get_event_rays(xy[:, 0], xy[:, 1], p1, p2, self.intrinsics)
        return {k.replace("evs", "no_evs"): v for k, v in rays.items()}

    def train_step_batch(self, generator=None):
        """One event batch (reference collate provider.py:1363-1499):
        paired rays at the poses of each sampled event and its successor,
        plus the no-event pairs when they are on."""
        samp = sample_event_batch(
            self.chains, 0, self.batch_size_evs, generator=generator,
            accumulate=self.accumulate_evs, acc_max_num_evs=self.acc_max_num_evs)
        i0, i1 = samp["idx_start"], samp["idx_end"]
        rays = get_event_rays(self.chains.xs[i0], self.chains.ys[i0],
                              self._event_poses(i0), self._event_poses(i1),
                              self.intrinsics)
        batch = dict(rays, pols=samp["pols"])
        if self.noev_coords is not None and self.use_no_ev:
            batch.update(self._no_event_rays(generator))
        return batch


def make_providers(cfg, device="cpu"):
    """(train_provider, val_provider) for mode=synthetic: the in-process
    event simulator (enerf_tpu's make_providers, synthetic branch)."""
    if cfg.mode != "synthetic":
        raise NotImplementedError(f"enerf_torch: dataset mode {cfg.mode!r}")
    if not (cfg.events and cfg.event_only):
        raise NotImplementedError("enerf_torch: only event_only=1 training")
    data = synthetic.simulate_events(
        H=cfg.H, W=cfg.W, C=abs(cfg.C_thres) if cfg.C_thres > 0 else 0.2,
        n_frames=cfg.syn_frames, rich=int(cfg.syn_rich))
    images = (data["frames"] if cfg.out_dim_color == 1
              else np.repeat(data["frames"], 3, -1))
    va_idx = [i for i in (cfg.val_idxs or range(len(images))) if i < len(images)]
    val = FramesProvider(images[va_idx], data["poses"][va_idx], data["intrinsics"])
    train = EventProvider(
        data["events"], data["frame_ts"], data["poses"], data["intrinsics"],
        data["H"], data["W"], batch_size_evs=cfg.batch_size_evs,
        accumulate_evs=bool(cfg.accumulate_evs), acc_max_num_evs=cfg.acc_max_num_evs,
        precompute_evs_poses=bool(cfg.precompute_evs_poses),
        negative_event_sampling=bool(cfg.negative_event_sampling), device=device)
    return train, val
