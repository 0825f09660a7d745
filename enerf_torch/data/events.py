"""Per-pixel event chains + batch sampling.

Counterpart of enerf_tpu/data/events.py (reference provider.py:1146-1219,
1363-1448).  Chains are built once on the host (one vectorized lexsort:
frame, then pixel, then time); sampling runs on the chains' device.  The
frame and pixel bounds are kept twice: as numpy on the host, for a frame
given as an int (one event window), and on the device, for a frame drawn
there (the per-image windows of tumvie / eds), so that neither costs a
device sync.

The JAX package leans on gathers that clamp out-of-range indices; here
every index is clamped explicitly, since PyTorch raises on the CPU and
faults on the card.
"""

from typing import NamedTuple

import numpy as np
import torch


class EventChains(NamedTuple):
    """Flat, frame/pixel-major, time-sorted event arrays.  Events with fewer
    than 2 occurrences at their pixel are dropped (reference provider.py:1164)."""
    xs: torch.Tensor              # [M] f32 pixel x
    ys: torch.Tensor              # [M] f32 pixel y
    ts: torch.Tensor              # [M] f32 timestamp
    pols: torch.Tensor            # [M] f32 polarity (+-1)
    cum_pols: torch.Tensor        # [M] f32 inclusive cumsum of pols
    num_successors: torch.Tensor  # [M] int64 later events at the same pixel
    group_offset: torch.Tensor    # [P] int64 start of each pixel group
    group_count: torch.Tensor     # [P] int64 events in each pixel group
    frame_bounds: np.ndarray      # [F, 2] (start, end) into the flat arrays
    pixel_bounds: np.ndarray      # [F, 2] (start, end) into the group arrays
    frame_bounds_dev: torch.Tensor  # the same two, int64 on the device
    pixel_bounds_dev: torch.Tensor


def build_event_chains(events, frame_ids=None, n_frames=1, device="cpu"):
    """[M, 4] (x, y, t, pol) events -> (EventChains, sorted event times)."""
    ev = np.asarray(events, np.float64)
    M = ev.shape[0]
    if frame_ids is None:
        frame_ids = np.zeros(M, np.int64)
        n_frames = 1
    frame_ids = np.asarray(frame_ids, np.int64)
    W = int(ev[:, 0].max()) + 2 if M else 2
    H = int(ev[:, 1].max()) + 2 if M else 2

    pix = ev[:, 1].astype(np.int64) * W + ev[:, 0].astype(np.int64)
    order = np.lexsort((ev[:, 2], pix, frame_ids))
    ev, pix, frame_ids = ev[order], pix[order], frame_ids[order]
    key = frame_ids * np.int64(W) * H + pix
    new_group = np.ones(M, bool)
    new_group[1:] = key[1:] != key[:-1]
    group_id = np.cumsum(new_group) - 1
    counts = np.bincount(group_id)

    # drop groups with < 2 events (no successor possible)
    keep = (counts >= 2)[group_id]
    ev, frame_ids, group_id = ev[keep], frame_ids[keep], group_id[keep]
    if ev.shape[0] == 0:
        raise ValueError(
            "no event chains: no pixel has >= 2 events within a frame "
            "interval — the event stream is too sparse for the chosen "
            "frame grouping (reference provider.py:1164 filter)")
    _, group_id = np.unique(group_id, return_inverse=True)
    counts = np.bincount(group_id)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    num_succ = counts[group_id] - (np.arange(ev.shape[0]) - offsets[group_id]) - 1

    frame_bounds = np.zeros((n_frames, 2), np.int64)
    pixel_bounds = np.zeros((n_frames, 2), np.int64)
    group_frame = frame_ids[offsets]
    for f in range(n_frames):
        idx = np.nonzero(frame_ids == f)[0]
        if idx.size:
            frame_bounds[f] = (idx[0], idx[-1] + 1)
        gidx = np.nonzero(group_frame == f)[0]
        if gidx.size:
            pixel_bounds[f] = (gidx[0], gidx[-1] + 1)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    chains = EventChains(
        xs=dev(ev[:, 0], torch.float32),
        ys=dev(ev[:, 1], torch.float32),
        ts=dev(ev[:, 2], torch.float32),
        pols=dev(ev[:, 3], torch.float32),
        cum_pols=dev(np.cumsum(ev[:, 3]), torch.float32),
        num_successors=dev(num_succ, torch.int64),
        group_offset=dev(offsets, torch.int64),
        group_count=dev(counts, torch.int64),
        frame_bounds=frame_bounds,
        pixel_bounds=pixel_bounds,
        frame_bounds_dev=dev(frame_bounds, torch.int64),
        pixel_bounds_dev=dev(pixel_bounds, torch.int64),
    )
    return chains, ev[:, 2].copy()


def sample_event_batch(chains, frame, batch_size, *, generator=None,
                       accumulate=False, acc_max_num_evs=0, draws=None):
    """Sample (event, successor) index pairs (reference provider.py:1367-1405).

    frame: an int (its bounds read on the host) or a [1] int64 tensor on
    the chains' device (its bounds gathered there: no sync).
    draws: optional (r [B] int in [0, max(n, 1)), u [B] f32 in [0, 1)) —
    the offset into the frame's range and the successor draw; otherwise
    drawn from `generator` on the chains' device.
    Returns dict(idx_start, idx_end [B] int64, pols [B] f32).
    """
    dev = chains.xs.device
    M = chains.xs.shape[0]
    if isinstance(frame, torch.Tensor):
        bounds = chains.frame_bounds_dev if accumulate else chains.pixel_bounds_dev
        lo, hi = bounds.index_select(0, frame)[0]
        if draws is None:
            # uniform in [0, max(n, 1)) without reading n on the host (a
            # modulo bias below n / 2^62)
            r = torch.randint(0, 2 ** 62, (batch_size,), device=dev,
                              generator=generator) % (hi - lo).clamp(min=1)
    else:
        bounds = chains.frame_bounds if accumulate else chains.pixel_bounds
        lo, hi = (int(v) for v in bounds[frame])
        if draws is None:
            r = torch.randint(0, max(hi - lo, 1), (batch_size,), device=dev,
                              generator=generator)
    if draws is None:
        u = torch.rand(batch_size, device=dev, generator=generator)
    else:
        r, u = (torch.as_tensor(v, device=dev) for v in draws)
    r = r.to(torch.int64)
    if accumulate:
        eidx = (lo + r).clamp(0, M - 1)
        # last event at a pixel has no successor -> step back one
        eidx = torch.where(chains.num_successors[eidx] == 0, eidx - 1, eidx).clamp(0, M - 1)
        nsucc = chains.num_successors[eidx]
        if acc_max_num_evs:
            nsucc = nsucc.clamp(max=acc_max_num_evs + 1)
        end = (eidx + 1 + (u * nsucc.float()).to(torch.int64)).clamp(max=M - 1)
        return {"idx_start": eidx, "idx_end": end,
                "pols": chains.cum_pols[end] - chains.cum_pols[eidx]}

    g = (lo + r).clamp(0, chains.group_count.shape[0] - 1)
    cnt = chains.group_count[g]
    # uniform among the first (count-1) events of the pixel (successor exists)
    k = (u * (cnt - 1).float()).to(torch.int64)
    eidx = (chains.group_offset[g] + k).clamp(0, M - 2)
    end = eidx + 1
    return {"idx_start": eidx, "idx_end": end, "pols": chains.pols[end]}
