"""The port's registry of spans and counters, and torch.profiler traces.

Spans.  `with span(name):` around a layer's work records, for each
instance, its host start and end (`time.perf_counter_ns`) and its parent,
and opens a `torch.profiler.record_function(name)` range (inert unless a
profiler runs; under one the span sits in the Chrome trace beside the
kernels).  When the span's work runs on a card (`span(name, device)` with
a CUDA device) it also launches a device mark (csrc/span_mark.cu, one
thread) on that device's current stream at its start and at its end:
each mark writes the card's
global nanosecond timer and the span's id into a ring of RING_SLOTS slots
in device memory (1 MiB), so the two marks bracket the span's work on the
stream.  Under a CUDA graph capture the marks become graph nodes, and
every replay of the graph records every span of the captured step again,
with no host sync; such a span is "graphed", and its path starts at the
capture (the spans around the capture on the host are not its parents,
since a replay runs wherever it is called).  A span whose work runs on
the host (no device, or a CPU one) launches no mark, whatever else the
process runs on a card, and its device fields stay None: a host number is
never given under a device name.

The span stack is one for the process, not one a thread: the table VJP
(`encode.bwd`), which autograd runs on its own thread, nests under the
`step.backward` span whose thread waits in `loss.backward()`.

Counters.  `count(name, n)` adds n to a named counter.  A CUDA graph
capture runs the host code once and no kernel, so `recording` takes, around
a capture, what the capture added to each count, as a `Replay`: the kernel
wrappers' `launches` (the marks' among them) and the registry's counters
apart, and sets the counts back; `replayed(replay)` adds that once for
each replay (train/chunk.py).

Reading.  `snapshot()` drains the ring (one synchronize and one copy; also
done before a launch or a replay whose marks would overwrite marks not yet
read) and returns, for each span path, its instance count, the instances
that ran in a graph replay, host seconds (instances the host ran; a
capture runs none), device seconds and device self seconds (the device
time less what its child spans cover); every counter; and a clock pair
(host perf_counter_ns, device global timer ns) taken at the drain, which
puts host spans and device marks on one time line.  `reset()` drops the
totals (the `--profile` window starts from nothing).

Traces.  The trainer's `--profile N` hook (train/trainer.py) starts a
torch.profiler trace after step N and stops it after step 2N, into
<workspace>/profile/, where `stop_trace` also writes the registry's
snapshot of those steps (`spans_<stamp>.json`).
"""

import ctypes
import json
import os
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

RING_SLOTS = 1 << 16  # marks the ring holds (16 bytes each: 1 MiB a card)
CLOCK = 0  # the span id of the drain's clock mark
PROFILED = ("step.batch", "step.forward", "step.backward", "step.optim", "encode.fwd",
            "encode.bwd")  # the spans of the --profile line


class _Registry:
    def __init__(self):
        self.lock = threading.RLock()
        self.stack = []   # open spans, innermost last
        self.ids = {}     # (path, graphed) -> span id (1, 2, ...)
        self.keys = [None]  # span id -> (path, graphed)
        self.rings = {}   # CUDA device index -> _Ring
        self.drained = 0  # span_mark.launches at the last drain
        self.clock = None
        self.reset()

    def reset(self):
        self.stats = {}   # path -> [count, graphed, host ns, device ns or None]
        self.counters = {}
        self.lost = 0     # marks overwritten before a drain read them

    def sid(self, path, graphed):
        key = (path, graphed)
        if key not in self.ids:
            self.ids[key] = len(self.keys)
            self.keys.append(key)
        return self.ids[key]

    def stat(self, path):
        if path not in self.stats:
            self.stats[path] = [0, 0, 0, None]
        return self.stats[path]


_REG = _Registry()


class _Ring:
    """One card's ring: RING_SLOTS (time ns, tag) pairs and, after them, the
    count of marks written (`mem`, int64); `read` counts the marks drained,
    `open` holds each span id's start times not yet ended."""

    def __init__(self, device, slots=RING_SLOTS):
        self.slots = slots
        self.mem = torch.zeros(2 * slots + 1, dtype=torch.int64, device=device)
        self.ptrs = (self.mem.data_ptr(), self.mem.data_ptr() + 16 * slots)  # ring, count
        self.read = 0
        self.open = {}

    def take(self, mem):
        """The marks written since the last take, from `mem` (a host copy of
        self.mem) -> (ended: [(span id, start ns, end ns)], clock ns or
        None, marks lost: overwritten before they were read)."""
        mem = np.asarray(mem, dtype=np.int64)
        head = int(mem[2 * self.slots])
        new = head - self.read
        lost = max(0, new - self.slots)
        if lost:  # a start whose end may be lost pairs with nothing
            self.open = {}
        order = np.arange(head - min(new, self.slots), head) % self.slots
        words = mem[:2 * self.slots].reshape(self.slots, 2)[order]
        self.read = head
        ended, clock = [], None
        for t, tag in words.tolist():
            sid = tag >> 1
            if sid == CLOCK:
                clock = t
            elif tag & 1 == 0:
                self.open.setdefault(sid, []).append(t)
            elif self.open.get(sid):
                ended.append((sid, self.open[sid].pop(), t))
        return ended, clock, lost


def _lib():
    from enerf_torch.ops.cuda_build import load_library
    fn = load_library("span_mark").span_mark_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_ulonglong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(ring, tag, dev):
    err = _lib()(*ring.ptrs, ring.slots, tag, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"span mark launch failed: cudaError {err}")


def _card(device):
    """The CUDA device index that `device` (a torch.device or its name;
    None for work on the host) names, or None off the card."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


def span_mark(tag, dev):
    """Launch one device mark of `tag` (span id * 2, + 1 at the end) on the
    current stream of CUDA device `dev`; the ring is made at the device's
    first mark, which cannot be inside a capture."""
    reg = _REG
    capturing = torch.cuda.is_current_stream_capturing()
    if dev not in reg.rings:
        if capturing:
            raise RuntimeError("the span registry's first mark on a card is inside a CUDA "
                               "graph capture; run the step once eagerly first")
        reg.rings[dev] = _Ring(torch.device("cuda", dev))
    if not capturing:  # a capture's marks are made room for at each replay
        _make_room(1)
    _launch(reg.rings[dev], tag, dev)
    with reg.lock:
        span_mark.launches += 1


span_mark.launches = 0  # marks launched, a replay's included (`replayed`)


class span:
    """`with span(name, device) as s:` records one instance of the span
    `name` under the innermost open span, with device marks where `device`
    (where the span's work runs) is a CUDA device (see the module
    docstring); `s.host_s` is its host seconds once the block has ended."""

    __slots__ = ("name", "path", "graphed", "sid", "host_s", "_card", "_rf", "_t0")

    def __init__(self, name, device=None):
        self.name, self.host_s, self._card = name, None, _card(device)

    def __enter__(self):
        reg = _REG
        marks = self._card is not None
        self.graphed = marks and torch.cuda.is_current_stream_capturing()
        with reg.lock:
            parent = next((s for s in reversed(reg.stack) if s.graphed == self.graphed), None)
            self.path = self.name if parent is None else f"{parent.path}/{self.name}"
            self.sid = reg.sid(self.path, self.graphed)
            reg.stack.append(self)
        try:
            if marks:
                span_mark(2 * self.sid, self._card)
        except BaseException:
            with reg.lock:
                reg.stack.remove(self)
            raise
        self._rf = record_function(self.name).__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        reg = _REG
        dt = time.perf_counter_ns() - self._t0
        self._rf.__exit__(None, None, None)
        try:
            if self._card is not None:
                span_mark(2 * self.sid + 1, self._card)
        finally:
            with reg.lock:
                reg.stack.remove(self)
                self.host_s = dt / 1e9
                if not self.graphed:
                    st = reg.stat(self.path)
                    st[0] += 1
                    st[2] += dt
        return False


def count(name, n=1):
    """Add n to the counter `name`."""
    with _REG.lock:
        _REG.counters[name] = _REG.counters.get(name, 0) + int(n)


class Replay:
    """What one replay of a captured graph adds to the counts: `launches`,
    {kernel wrapper: launches}, and `counters`, {counter name: n}."""

    __slots__ = ("launches", "counters")

    def __init__(self):
        self.launches, self.counters = {}, {}


class recording:
    """`with recording(owners) as replay:` around a CUDA graph's capture:
    when the block ends, replay.launches holds what the capture added to
    `launches` of each object of `owners` and of span_mark (0 included),
    replay.counters what it added to each registry counter it bumped, and
    the counts are set back, as the capture ran nothing."""

    def __init__(self, owners=()):
        self.owners = tuple(dict.fromkeys((*owners, span_mark)))

    def __enter__(self):
        with _REG.lock:
            self.launches = [o.launches for o in self.owners]
            self.counters = dict(_REG.counters)
            self.replay = Replay()
        return self.replay

    def __exit__(self, *exc):
        with _REG.lock:
            for o, b in zip(self.owners, self.launches):
                self.replay.launches[o] = o.launches - b
                o.launches = b
            for k, v in _REG.counters.items():
                if v != self.counters.get(k, 0):
                    self.replay.counters[k] = v - self.counters.get(k, 0)
            _REG.counters = self.counters
        return False


def replayed(replay):
    """Add one replay's counts (a `Replay` of `recording`); call it before
    the replay, so that the ring has room for the replay's marks."""
    _make_room(replay.launches.get(span_mark, 0))
    with _REG.lock:
        for o, n in replay.launches.items():
            o.launches += n
        for k, n in replay.counters.items():
            _REG.counters[k] = _REG.counters.get(k, 0) + n


def _make_room(n):
    if _REG.rings and span_mark.launches + n - _REG.drained > RING_SLOTS - len(_REG.rings):
        _drain()


def _drain():
    """Read every ring's new marks into the totals: per card one
    synchronize, a clock mark and one copy."""
    reg = _REG
    with reg.lock:
        for dev, ring in reg.rings.items():
            with torch.cuda.device(dev):
                torch.cuda.synchronize()
                host_ns = time.perf_counter_ns()
                _launch(ring, 2 * CLOCK, dev)
                span_mark.launches += 1
                mem = ring.mem.cpu()
            ended, clock, lost = ring.take(mem)
            reg.lost += lost
            reg.clock = {"host_ns": host_ns, "device_ns": clock}
            _record(ended)
        reg.drained = span_mark.launches


def _record(ended):
    """Add the device time of each ended (span id, start ns, end ns); a
    graphed instance also counts as one instance of its span."""
    with _REG.lock:
        for sid, t0, t1 in ended:
            path, graphed = _REG.keys[sid]
            st = _REG.stat(path)
            st[3] = (st[3] or 0) + (t1 - t0)
            if graphed:
                st[0] += 1
                st[1] += 1


def snapshot():
    """The registry's totals since the start (or the last `reset`):
    {"spans": {path: {count, graphed, host_s, device_s, device_self_s}},
    "counters": {name: n}, "clock": {host_ns, device_ns},
    "lost_marks": n}.  Device fields are None where no mark was read."""
    reg = _REG
    with reg.lock:
        if reg.rings:
            _drain()
        else:
            reg.clock = {"host_ns": time.perf_counter_ns(), "device_ns": None}
        spans = {p: {"count": c, "graphed": g, "host_s": h / 1e9,
                     "device_s": None if d is None else d / 1e9, "device_self_s": None}
                 for p, (c, g, h, d) in reg.stats.items()}
        covered = {}
        for p, s in spans.items():
            if "/" in p and s["device_s"] is not None:
                parent = p.rsplit("/", 1)[0]
                covered[parent] = covered.get(parent, 0.0) + s["device_s"]
        for p, s in spans.items():
            if s["device_s"] is not None:
                s["device_self_s"] = s["device_s"] - covered.get(p, 0.0)
        return {"spans": spans, "counters": dict(reg.counters), "clock": reg.clock,
                "lost_marks": reg.lost}


def reset():
    """Drop the totals and counters (marks already launched are read first
    and dropped with them); open spans and the rings stay."""
    with _REG.lock:
        if _REG.rings:
            _drain()
        _REG.reset()


def per_step_ms(snap, steps):
    """{span name: ms a step} over `steps` steps of each span of PROFILED
    that ran, from the device's time where the marks give it for every one
    of them, else the host's -> (ms, "device" | "host")."""
    found = {name: [s for p, s in snap["spans"].items() if p.rsplit("/", 1)[-1] == name]
             for name in PROFILED}
    found = {name: v for name, v in found.items() if v}
    on_device = bool(found) and all(s["device_s"] is not None for v in found.values() for s in v)
    key = "device_s" if on_device else "host_s"
    ms = {name: 1e3 * sum(s[key] for s in v) / max(steps, 1) for name, v in found.items()}
    return ms, "device" if on_device else "host"


def start_trace(cuda):
    """A started torch.profiler session (CPU, plus CUDA when `cuda`)."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, logdir):
    """Stop `prof`, write its Chrome trace and the registry's snapshot
    (spans_<stamp>.json) into logdir; returns the trace's path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    stamp = f"{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
    path = os.path.join(logdir, f"trace_{stamp}.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(logdir, f"spans_{stamp}.json"), "w") as f:
        json.dump(snapshot(), f, indent=1)
    return path
