"""Profiling helpers: torch.profiler traces and step timing.

Counterpart of enerf_tpu/utils/profiling.py (there over jax.profiler):
`trace` captures a profiler trace of a block (host activity, and the
card's kernels and copies when the device is CUDA) and writes it as a
Chrome trace (chrome://tracing, Perfetto); `StepTimer` times steps on the
host clock after synchronising the device.  The trainer's `--profile N`
hook (train/trainer.py) starts a trace after step N and stops it after
step 2N, into <workspace>/profile/.
"""

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


def start_trace(cuda):
    """A started torch.profiler session (CPU, plus CUDA when `cuda`)."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, logdir):
    """Stop `prof` and write its Chrome trace into logdir; returns the path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir, cuda=None):
    """Capture a profiler trace around a block; yields a dict whose "path"
    is the trace file once the block has ended.

    with profiling.trace("/tmp/trace") as out:
        step(...)
    print(out["path"])
    """
    cuda = torch.cuda.is_available() if cuda is None else cuda
    out = {"path": None}
    prof = start_trace(cuda)
    try:
        yield out
    finally:
        if cuda:
            torch.cuda.synchronize()
        out["path"] = stop_trace(prof, logdir)


class StepTimer:
    """Per-step wall time, the device synchronised before the clock is read."""

    def __init__(self, device=None):
        self.device = device
        self.times = []

    def _sync(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def measure(self):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.times.append(time.perf_counter() - t0)

    def mean_ms(self, skip_first=1):
        t = self.times[skip_first:] or self.times
        return 1000.0 * sum(t) / len(t)
