"""Dataset providers: event supervision + frame views, device-resident.

Counterpart of enerf_tpu/data/provider.py (reference nerf/provider.py).
This slice ports the synthetic branch of `make_providers`, the
`EventProvider` for event-only training with per-event poses precomputed
on the host, and the `FramesProvider` as the source of validation views.
Everything a step samples lives on the provider's device, so a batch costs
no host-device transfer.
"""

import numpy as np
import torch

from enerf_torch.data import synthetic
from enerf_torch.data.events import build_event_chains, sample_event_batch
from enerf_torch.data.poses import make_pose_interpolator
from enerf_torch.data.rays import get_event_rays


class FramesProvider:
    """Frame views (reference NeRFDataset); the port uses it for val views."""

    def __init__(self, images, poses, intrinsics):
        self.poses = np.asarray(poses, np.float32)
        self.intrinsics = intrinsics
        self.H, self.W = images.shape[1:3]
        self._images_np = images

    def val_views(self):
        return [{"pose": self.poses[i], "intrinsics": self.intrinsics,
                 "H": self.H, "W": self.W, "gt": self._images_np[i]}
                for i in range(len(self._images_np))]


class EventProvider:
    """Event-supervision provider (reference EventNeRFDataset) for one event
    stream: per-pixel chains and per-event poses built once on the host,
    batches sampled on `device`."""

    def __init__(self, events, hf_ts, hf_poses, intrinsics, batch_size_evs=4096,
                 accumulate_evs=False, acc_max_num_evs=0, steps_per_epoch=100,
                 device="cpu"):
        self.device = torch.device(device)
        self.chains, ev_ts_sorted = build_event_chains(events, device=self.device)
        # exact host Slerp + cubic per event (48 bytes/event on the device)
        interp = make_pose_interpolator(hf_ts, hf_poses)
        self.poses_evs = torch.as_tensor(interp(ev_ts_sorted), device=self.device)
        self.intrinsics = intrinsics
        self.batch_size_evs = batch_size_evs
        self.accumulate_evs = accumulate_evs
        self.acc_max_num_evs = acc_max_num_evs
        self.steps_per_epoch = steps_per_epoch

    def train_step_batch(self, generator=None):
        """One event batch (reference collate provider.py:1363-1499):
        paired rays at the poses of each sampled event and its successor."""
        samp = sample_event_batch(
            self.chains, 0, self.batch_size_evs, generator=generator,
            accumulate=self.accumulate_evs, acc_max_num_evs=self.acc_max_num_evs)
        i0, i1 = samp["idx_start"], samp["idx_end"]
        rays = get_event_rays(self.chains.xs[i0], self.chains.ys[i0],
                              self.poses_evs[i0], self.poses_evs[i1],
                              self.intrinsics)
        return dict(rays, pols=samp["pols"])


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
        batch_size_evs=cfg.batch_size_evs, accumulate_evs=bool(cfg.accumulate_evs),
        acc_max_num_evs=cfg.acc_max_num_evs, device=device)
    return train, val
