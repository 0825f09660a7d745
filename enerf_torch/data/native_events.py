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

E1 is a stable least-significant-digit radix sort of the int32 composite
key (frame - min frame) * P + (pixel - min pixel), P the pixel range,
carrying int32 event indices, so that its cost grows with the number of
events M and not with the key space K = frames x P: a pre-pass of
reductions (the key's range, whether the times are sorted; the host reads
them once and plans the digits with digit_plan), one histogram of every
digit, then a pass a digit (each tile of 4096 keys ranked stably in
shared memory, its buckets' offsets found by a decoupled look-back over the
tiles before it, its keys and indices stored as runs), then one streaming
pass over the sorted keys for the group ids and each group's count.  A
sort that starts in index order ends in (key, index) order, which is
lexsort's order when the times are sorted; when they are not, a fix-up
sorts each group's events by (time, index), one thread a short group and
one block a long one (a hot pixel).  Its result is the plain version's
order exactly.  Keys are offset by their minimum, so a pixel below 0 (a
rectify map can send border events there) is sorted, not written out of
range; the JAX library's counting sort indexes out of its arrays there.
E1 takes at most 2^30 keys (MAX_KEYS) and raises above that.  Bound: bytes
(36 B an event read and written at least; the passes move ~100).

`sort_events_by_pixel.launches` counts E1's sort launches (through
either sort function) and `group_tables.launches` its group-table launches
(CUDA path only).  Each runs only when chains are built, never in
a training step.
"""

import ctypes

import numpy as np
import torch

MAX_KEYS = 1 << 30  # E1's int32 keys: frames x pixel range, at most
MAX_DIGIT = 11      # bits of a radix pass's digit: 2048 buckets, at most


def digit_plan(K):
    """The digits E1's radix passes take for keys in [0, K), least
    significant first: b = ceil(log2 K) bits (0 for K = 1, which needs no
    pass) in the fewest passes of at most MAX_DIGIT bits, split as evenly
    as they go (25 bits: 9, 8, 8)."""
    b = (int(K) - 1).bit_length()
    d = -(-b // MAX_DIGIT)
    return [b // d + (p < b % d) for p in range(d)]


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
        plan = [i32] * 4 + [vp]  # d, the digits' bits, the workspace
        lib.e1_histogram.argtypes = [vp, vp, vp, i64, i32, i64, i64, i64] + plan + [vp]
        lib.e1_pass.argtypes = ([vp, vp, vp, i64, i32, i64, i64, i64, vp, vp, i32] + plan
                                + [vp] * 4)
        lib.e1_groups.argtypes = [vp, i64] + plan + [vp] * 3
        lib.e1_single_key.argtypes = [i64, vp, vp, vp, vp]
        lib.e1_fixup.argtypes = [vp, vp, i64, vp, vp, vp, vp, vp, vp]
        lib.e1_group_tables.argtypes = [vp, i64, i64, vp, vp, vp, vp, vp]
        lib.e1_big_capacity.argtypes = [i64]
        lib.e1_sort_workspace.argtypes = [i64] + [i32] * 4
        for fn in (lib.e1_big_capacity, lib.e1_sort_workspace):
            fn.restype = i64
        lib.e1_tile.argtypes = []
        for fn in (lib.e1_prepass, lib.e1_histogram, lib.e1_pass, lib.e1_groups,
                   lib.e1_single_key, lib.e1_fixup, lib.e1_group_tables, lib.e1_tile):
            fn.restype = ctypes.c_int
    return lib


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"E1 {what} launch failed: cudaError {err}")


def _ptr(x, word=0):
    """x's address, `word` elements in."""
    return ctypes.c_void_p(x.data_ptr() + word * x.element_size())


def _sort_cuda(xs, ys, ts, frame_ids, W, marks=None):
    """E1's sort on CUDA tensors.  marks: a list that gets (stage, CUDA
    event) after each stage, for the smoke's split."""
    dev = xs.device
    n = xs.numel()
    if n >= 2 ** 31:
        raise ValueError(f"E1 sorts fewer than 2^31 events (its positions are int32), got {n}")
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
        plan = digit_plan(K)
        order = torch.empty(n, dtype=torch.int64, device=dev)
        group_id = torch.empty(n, dtype=torch.int64, device=dev)
        if not plan:
            counts = torch.empty(1, dtype=torch.int64, device=dev)
            _check(lib.e1_single_key(n, _ptr(order), _ptr(group_id), _ptr(counts), stream),
                   "single key")
            mark("single key")
            tmp = torch.empty(n, dtype=torch.int64, device=dev) if unsorted else None
        else:
            digits = (len(plan), *plan, *[0] * (3 - len(plan)))  # at most 3 of <= 11 bits
            ws = torch.zeros(lib.e1_sort_workspace(n, *digits), dtype=torch.int64,
                             device=dev)  # laid out by the .cu
            digits += (_ptr(ws),)
            _check(lib.e1_histogram(_ptr(xs), _ptr(ys), _ptr(frame_ids), n, int(W), fmin, pmin,
                                    P, *digits, stream), "histogram")
            mark("histogram")
            # two sets of int32 keys then int32 values, each in one int64
            # tensor of n: pass p writes set p % 2 and reads the other
            sets = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
            halves = [(_ptr(t), ctypes.c_void_p(t.data_ptr() + 4 * n)) for t in sets]
            for p, w in enumerate(plan):
                src, dst = halves[(p + 1) % 2], halves[p % 2]
                _check(lib.e1_pass(_ptr(xs), _ptr(ys), _ptr(frame_ids), n, int(W), fmin, pmin,
                                   P, *src, p, *digits, *dst, _ptr(order), stream),
                       f"pass {p}")
                mark(f"pass {p} ({w} bits)")
            # the last pass read the other set (or none): it holds the counts now
            counts = sets[len(plan) % 2]
            _check(lib.e1_groups(halves[(len(plan) - 1) % 2][0], n, *digits, _ptr(group_id),
                                 _ptr(counts), stream), "groups")
            mark("groups")
            tmp = sets[(len(plan) - 1) % 2]  # the sorted keys, read
        if unsorted:
            big = torch.empty(lib.e1_big_capacity(n), dtype=torch.int32, device=dev)
            n_big = torch.zeros(1, dtype=torch.int32, device=dev)
            _check(lib.e1_fixup(_ptr(order), _ptr(tmp), n, _ptr(group_id), _ptr(counts),
                                _ptr(ts), _ptr(big), _ptr(n_big), stream), "fix-up")
            mark("fixup")
        n_groups = int(group_id[n - 1]) + 1  # the one read after the sort
        mark("group count read")
    return order, group_id, counts[:n_groups]


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
    """group_id [M] int64, non-decreasing in [0, n_groups) as the sort gives
    it -> (counts [G], offsets [G], num_succ [M]) int64: E1's group tables
    on CUDA tensors, the plain version on CPU tensors.  E1 takes each
    group's offset where a run of its id starts, so on the card ids that
    decrease or leave [0, n_groups) raise ValueError (one host read); the
    plain version, like the JAX library's histogram, returns tables for any
    ids in range."""
    if not group_id.is_cuda:
        return tuple(torch.from_numpy(a) for a in group_tables_plain(group_id.numpy(),
                                                                     n_groups))
    dev = group_id.device
    group_id = group_id.to(torch.int64).contiguous()
    n = group_id.numel()
    lib = _lib()
    with torch.cuda.device(dev):
        offs = torch.empty(n_groups + 1, dtype=torch.int64, device=dev)
        counts = torch.empty(n_groups, dtype=torch.int64, device=dev)
        num_succ = torch.empty(n, dtype=torch.int64, device=dev)
        bad = torch.zeros(1, dtype=torch.int32, device=dev)
        _check(lib.e1_group_tables(_ptr(group_id), n, n_groups, _ptr(offs), _ptr(counts),
                                   _ptr(num_succ), _ptr(bad),
                                   torch.cuda.current_stream(dev).cuda_stream),
               "group tables")
    group_tables.launches += 1
    if int(bad):
        raise ValueError(f"E1's group tables take ids non-decreasing in [0, {n_groups}), "
                         "as the sort gives them")
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
