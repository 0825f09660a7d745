"""Reductions of a torch.profiler Chrome trace over the measured window.

The window is the host annotation `WINDOW` the harness records around it
(or another annotation, for a probe's own trace).
Device activity is every kernel, copy and memset the trace holds inside
it; its busy time is the union of their intervals (kernels of several
streams that overlap count once), so busy <= window by construction.  An
idle gap is a stretch of the window with no device activity; it is named
by the innermost host event (an operator, a runtime call or an
annotation) that covers the gap's middle, or `host (no event)` where the
host was in code the profiler does not record.
"""

import bisect
import json
import os

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _top(totals, n=10):
    return [[k, v / 1e6] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def reduce_events(events, window=WINDOW):
    """Chrome trace events -> dict(window_s, busy_s, device_ops, idle_gaps,
    kernels: the name of every kernel that ran in the window), times in
    seconds; None when the trace holds no window annotation."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == window
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev, by_name, kernels = [], {}, set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
        if t > s:
            dev.append((s, t))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s)
            if e["cat"] == "kernel":
                kernels.add(e["name"])
    merged = _merge(dev)
    busy = sum(t - s for s, t in merged)
    gaps, cursor = [], lo
    for s, t in merged:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if hi > cursor:
        gaps.append((cursor, hi))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("name") != window)
    starts = [h[0] for h in host]
    idle, active, nxt = {}, [], 0
    for s, t in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + t)
        hi_i = bisect.bisect_right(starts, mid)
        while nxt < hi_i:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        name = max(active)[2] if active else "host (no event)"
        idle[name] = idle.get(name, 0.0) + (t - s)
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "device_ops": _top(by_name), "idle_gaps": _top(idle), "kernels": sorted(kernels)}


def reduce_file(path, window=WINDOW):
    with open(path) as f:
        return reduce_events(json.load(f).get("traceEvents", []), window)


def traced(fn, device, workdir, window=WINDOW):
    """fn() under torch.profiler, annotated as `window`; the trace reduced
    (the trace file goes under `workdir` and is removed)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        with record_function(window):
            fn()
    finally:
        prof.stop()
    path = os.path.join(workdir, f"{window}.json")
    prof.export_chrome_trace(path)
    del prof
    out = reduce_file(path, window)
    os.remove(path)
    return out
