"""The event chains' sort and group tables: kernel E1 on the card.

Counterpart of enerf_tpu/data/native_events.py, the ctypes bindings of the
JAX package's host C++ library (native/event_preproc.cpp), with the same
four functions on tensors:

  - sort_events_by_pixel(xs, ys, ts, frame_ids, W, H) -> (order, group_id,
    n_groups): the stable order of the events by (frame, pixel, time), the
    pixel trunc(y) * W + trunc(x) taken from float32 coordinates, as the
    library takes it; ties in time keep their index order;
  - group_tables(group_id, n_groups) -> (counts, offsets, num_succ);
  - ms_to_idx(ts, tick): the first event at or after each tick;
  - window_indices(ts, t_start, t_end): [i0, i1) with t_start <= ts < t_end.

sort_and_count is sort_events_by_pixel with each group's count beside it,
which the sort has at hand: build_event_chains takes it, so that its < 2
filter needs no group-table pass over all the events.

The device decides.  On CPU tensors each function runs its plain version
(numpy's lexsort, bincount and searchsorted), which gives the library's
output exactly.  On CUDA tensors the sort and the group tables launch
kernel E1 (csrc/event_chains.cu, built with nvcc at first use), and
ms_to_idx / window_indices run torch.searchsorted on the card.  There is no
fallback: a missing toolchain raises.

E1 sorts by a counting sort over the composite key (frame - min frame) * P
+ (pixel - min pixel), P the pixel range: a pre-pass of reductions (the
key's range, whether the times are sorted; the host reads them once), a
histogram whose atomics also rank each event within its key, a scan, a
scatter by those ranks (not stable), then a fix-up that sorts each key's
events back into (time, index) order and writes their group number, one
thread a short group and one block a long one (a hot pixel).  Its result is the plain version's
order exactly.  Keys are offset by their minimum, so a pixel below 0 (a
rectify map can send border events there) is counted, not written out of
range; the JAX library's counting sort indexes out of its arrays there.
E1 takes at most 2^30 keys (MAX_KEYS) and raises above that.

`sort_events_by_pixel.launches` counts E1's sort launches (through
either sort function) and `group_tables.launches` its group-table launches
(CUDA path only).  Each runs only when chains are built, never in
a training step.
"""

import ctypes

import numpy as np
import torch

MAX_KEYS = 1 << 30  # E1's counters: frames x pixel range, at most


def sort_plain(xs, ys, ts, frame_ids, W):
    """Plain version of E1's sort on numpy arrays -> (order, group_id,
    counts): lexsort by (frame, pixel, time), the pixel trunc(y_f32) * W +
    trunc(x_f32) (event_preproc.cpp:36), groups where (frame, pixel)
    changes, each group's count."""
    pix = (np.asarray(ys).astype(np.float32).astype(np.int64) * np.int64(W)
           + np.asarray(xs).astype(np.float32).astype(np.int64))
    frame_ids = np.asarray(frame_ids).astype(np.int32).astype(np.int64)
    order = np.lexsort((np.asarray(ts, np.float64), pix, frame_ids))
    pix, fr = pix[order], frame_ids[order]
    new_group = np.ones(len(order), bool)
    new_group[1:] = (pix[1:] != pix[:-1]) | (fr[1:] != fr[:-1])
    group_id = np.cumsum(new_group) - 1
    counts = np.diff(np.append(np.flatnonzero(new_group), len(order)))
    return order, group_id, counts


def group_tables_plain(group_id, n_groups):
    """Plain version of E1's group tables on numpy arrays."""
    group_id = np.asarray(group_id, np.int64)
    counts = np.bincount(group_id, minlength=n_groups).astype(np.int64)
    offsets = np.zeros(n_groups, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    num_succ = offsets[group_id] + counts[group_id] - np.arange(len(group_id)) - 1
    return counts, offsets, num_succ


def _lib():
    from enerf_torch.ops.cuda_build import load_library
    lib = load_library("event_chains")
    if lib.e1_prepass.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.e1_prepass.argtypes = [vp, vp, vp, vp, i64, i32, vp, vp]
        lib.e1_histogram.argtypes = [vp, vp, vp, i64, i32, i64, i64, i64, vp, vp, vp, vp]
        lib.e1_scan.argtypes = [vp, i64, i32, vp, vp, vp]
        lib.e1_scatter.argtypes = [vp, vp, i64, vp, vp, vp]
        lib.e1_fixup.argtypes = [vp, vp, vp, vp, i64, vp, i32, vp, vp, vp, vp, vp]
        lib.e1_group_tables.argtypes = [vp, i64, i64, vp, vp, vp, vp, vp, vp]
        lib.e1_scan_workspace.argtypes = [i64]
        lib.e1_scan_workspace.restype = i64
        lib.e1_big_capacity.argtypes = [i64]
        lib.e1_big_capacity.restype = i64
        for fn in (lib.e1_prepass, lib.e1_histogram, lib.e1_scan, lib.e1_scatter, lib.e1_fixup,
                   lib.e1_group_tables):
            fn.restype = ctypes.c_int
    return lib


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"E1 {what} launch failed: cudaError {err}")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _sort_cuda(xs, ys, ts, frame_ids, W, marks=None):
    """E1's sort on CUDA tensors.  marks: a list that gets (stage, CUDA
    event) after each stage, for the smoke's split."""
    dev = xs.device
    n = xs.numel()
    if n >= 2 ** 31:
        raise ValueError(f"E1 sorts fewer than 2^31 events (its per-key counters are "
                         f"int32), got {n}")
    lib = _lib()

    def mark(stage):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        mark("start")
        red = torch.empty(5, dtype=torch.int64, device=dev)
        _check(lib.e1_prepass(_ptr(xs), _ptr(ys), _ptr(ts), _ptr(frame_ids), n, int(W),
                              _ptr(red), stream), "pre-pass")
        fmin, fmax, pmin, pmax, unsorted = red.tolist()  # the one read of the pre-pass
        mark("prepass")
        P = pmax - pmin + 1
        K = (fmax - fmin + 1) * P
        if K > MAX_KEYS:
            raise ValueError(
                f"E1 takes at most 2^30 keys (frames x pixel range): frames {fmin}..{fmax} "
                f"and pixels {pmin}..{pmax} make {K}")
        key = torch.empty(n, dtype=torch.int32, device=dev)
        rank = torch.empty(n, dtype=torch.int32, device=dev)
        count = torch.zeros(K, dtype=torch.int32, device=dev)
        _check(lib.e1_histogram(_ptr(xs), _ptr(ys), _ptr(frame_ids), n, int(W), fmin, pmin, P,
                                _ptr(key), _ptr(rank), _ptr(count), stream), "histogram")
        mark("histogram")
        start = torch.empty(K + 1, dtype=torch.int64, device=dev)
        gbase = torch.empty(K + 1, dtype=torch.int64, device=dev)
        ws = torch.empty(lib.e1_scan_workspace(K + 1), dtype=torch.int64, device=dev)
        _check(lib.e1_scan(_ptr(count), K, 0, _ptr(start), _ptr(ws), stream), "scan")
        _check(lib.e1_scan(_ptr(count), K, 1, _ptr(gbase), _ptr(ws), stream), "scan")
        mark("scan")
        order = torch.empty(n, dtype=torch.int64, device=dev)
        _check(lib.e1_scatter(_ptr(key), _ptr(rank), n, _ptr(start), _ptr(order), stream),
               "scatter")
        mark("scatter")
        n_groups = int(gbase[K].item())  # sizes the counts
        tmp = torch.empty(n, dtype=torch.int64, device=dev)
        group_id = torch.empty(n, dtype=torch.int64, device=dev)
        counts = torch.empty(n_groups, dtype=torch.int64, device=dev)
        big = torch.empty(lib.e1_big_capacity(n), dtype=torch.int32, device=dev)
        n_big = torch.zeros(1, dtype=torch.int32, device=dev)
        _check(lib.e1_fixup(_ptr(order), _ptr(tmp), _ptr(start), _ptr(gbase), K, _ptr(ts),
                            int(unsorted), _ptr(group_id), _ptr(counts), _ptr(big),
                            _ptr(n_big), stream), "fix-up")
        mark("fixup")
    return order, group_id, counts


def sort_and_count(xs, ys, ts, frame_ids, W, marks=None):
    """[M] tensors (xs, ys rounded to float32, ts float64, frame ids int32)
    -> (order [M] int64, group_id [M] int64, counts [G] int64): E1 on CUDA
    tensors, the plain version on CPU tensors.  The key's range comes from
    the events."""
    dev = xs.device
    if xs.numel() == 0:
        return tuple(torch.zeros(0, dtype=torch.int64, device=dev) for _ in range(3))
    xs, ys = (v.to(torch.float32).contiguous() for v in (xs, ys))
    ts = ts.to(torch.float64).contiguous()
    frame_ids = frame_ids.to(torch.int32).contiguous()
    if not xs.is_cuda:
        return tuple(torch.from_numpy(a) for a in sort_plain(
            xs.numpy(), ys.numpy(), ts.numpy(), frame_ids.numpy(), W))
    if not all(v.device == dev for v in (ys, ts, frame_ids)):
        raise ValueError("E1 takes xs, ys, ts and frame_ids on one CUDA device")
    out = _sort_cuda(xs, ys, ts, frame_ids, W, marks)
    sort_events_by_pixel.launches += 1
    return out


def sort_events_by_pixel(xs, ys, ts, frame_ids, W, H, marks=None):
    """sort_and_count's order and group ids, and the number of groups: the
    JAX library's signature (H is its argument, unused here)."""
    order, group_id, counts = sort_and_count(xs, ys, ts, frame_ids, W, marks)
    return order, group_id, counts.numel()


sort_events_by_pixel.launches = 0


def group_tables(group_id, n_groups):
    """group_id [M] int64 (in [0, n_groups)) -> (counts [G], offsets [G],
    num_succ [M]) int64: E1's group tables on CUDA tensors, the plain
    version on CPU tensors."""
    if not group_id.is_cuda:
        return tuple(torch.from_numpy(a) for a in group_tables_plain(group_id.numpy(),
                                                                     n_groups))
    dev = group_id.device
    group_id = group_id.to(torch.int64).contiguous()
    n = group_id.numel()
    lib = _lib()
    with torch.cuda.device(dev):
        count = torch.zeros(max(n_groups, 1), dtype=torch.int32, device=dev)
        offs = torch.empty(n_groups + 1, dtype=torch.int64, device=dev)
        counts = torch.empty(n_groups, dtype=torch.int64, device=dev)
        num_succ = torch.empty(n, dtype=torch.int64, device=dev)
        ws = torch.empty(lib.e1_scan_workspace(n_groups + 1), dtype=torch.int64, device=dev)
        _check(lib.e1_group_tables(_ptr(group_id), n, n_groups, _ptr(count), _ptr(offs),
                                   _ptr(counts), _ptr(num_succ), _ptr(ws),
                                   torch.cuda.current_stream(dev).cuda_stream), "group tables")
    group_tables.launches += 1
    return counts, offs[:n_groups], num_succ


group_tables.launches = 0


def ms_to_idx(ts, tick):
    """Sorted times [N] float64 -> [int(ts[-1] / tick) + 1] int64: the index
    of the first event at or after ms * tick, for each ms.  This is the
    library's rule (event_preproc.cpp:88-101: the last time truncated, float
    targets), which h5events.compute_ms_to_idx, the loaders' table, does not
    follow exactly (the largest time floored, integer targets from
    ms_start), so each keeps its own."""
    ts = ts.to(torch.float64).contiguous()
    if ts.numel() == 0:
        return torch.zeros(0, dtype=torch.int64, device=ts.device)
    m = int(float(ts[-1]) / tick) + 1
    targets = torch.arange(m, dtype=torch.float64, device=ts.device) * float(tick)
    return torch.searchsorted(ts, targets)


def window_indices(ts, t_start, t_end):
    """(i0, i1) over sorted times: t_start <= ts[i] < t_end for i0 <= i < i1."""
    ts = ts.to(torch.float64).contiguous()
    bounds = torch.tensor([float(t_start), float(t_end)], dtype=torch.float64,
                          device=ts.device)
    i0, i1 = torch.searchsorted(ts, bounds).tolist()
    return i0, i1
