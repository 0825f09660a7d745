"""Per-pixel event chains + batch sampling.

Counterpart of enerf_tpu/data/events.py (reference provider.py:1146-1219,
1363-1448).  Chains are built once, on the chains' device (the sort by
frame, then pixel, then time is kernel E1 on the card,
data/native_events.py); sampling runs there too.  The
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

from enerf_torch.data import native_events


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
    """[M, 4] (x, y, t, pol) events -> (EventChains, sorted event times).

    The events go to `device` once; the sort and the group tables run
    there (native_events: kernel E1 on the card, the plain lexsort on the
    CPU), and so does the rest: the < 2 filter, the group ids made dense
    again, the successors, cum_pols and the bounds.  Both routes give the
    same chains bit for bit.  The pixel key comes from float32
    coordinates, as in the JAX package's native path."""
    ev = np.asarray(events, np.float64)
    M = ev.shape[0]
    if frame_ids is None:
        frame_ids = np.zeros(M, np.int64)
        n_frames = 1
    frame_ids = np.asarray(frame_ids, np.int64)
    W = int(ev[:, 0].max()) + 2 if M else 2
    dev = torch.device(device)
    evd = torch.as_tensor(ev, device=dev)
    fid = torch.as_tensor(frame_ids, device=dev)

    order, group_id, counts = native_events.sort_and_count(
        evd[:, 0], evd[:, 1], evd[:, 2], fid, W)
    # drop groups with < 2 events (no successor possible); the kept groups
    # are numbered again in order
    keep_group = counts >= 2
    keep = keep_group[group_id]
    sel = order[keep]
    if sel.numel() == 0:
        raise ValueError(
            "no event chains: no pixel has >= 2 events within a frame "
            "interval — the event stream is too sparse for the chosen "
            "frame grouping (reference provider.py:1164 filter)")
    dense = torch.cumsum(keep_group, 0) - 1
    group_id = dense[group_id[keep]]
    counts, offsets, num_succ = native_events.group_tables(group_id, int(dense[-1]) + 1)
    ev_s = evd[sel]
    frames = fid[sel]

    def bounds(sorted_ids):
        f = torch.arange(n_frames, dtype=sorted_ids.dtype, device=dev)
        lo = torch.searchsorted(sorted_ids, f)
        hi = torch.searchsorted(sorted_ids, f, right=True)
        has = hi > lo
        return torch.stack([torch.where(has, lo, 0), torch.where(has, hi, 0)], 1)

    frame_bounds = bounds(frames)
    pixel_bounds = bounds(frames[offsets])
    ts_sorted = ev_s[:, 2]
    chains = EventChains(
        xs=ev_s[:, 0].float(),
        ys=ev_s[:, 1].float(),
        ts=ts_sorted.float(),
        pols=ev_s[:, 3].float(),
        # exact for integer polarities on either device
        cum_pols=torch.cumsum(ev_s[:, 3], 0).float(),
        num_successors=num_succ,
        group_offset=offsets,
        group_count=counts,
        frame_bounds=frame_bounds.cpu().numpy(),
        pixel_bounds=pixel_bounds.cpu().numpy(),
        frame_bounds_dev=frame_bounds,
        pixel_bounds_dev=pixel_bounds,
    )
    return chains, ts_sorted.contiguous().cpu().numpy()


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
