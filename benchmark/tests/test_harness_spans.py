"""The readers of device time by layer (metrics/step_*_ms.py,
encode_fwd_ms.py, encode_bwd_ms.py over spans.py): what they read from a
made-up snapshot of the program's span registry, and that they read
nothing on the CPU or from a program without the registry."""

import types

import pytest

from benchmark import harness
from benchmark.tests.tiny_cells import run_tiny

STEP_METRICS = ("step_batch_ms", "step_forward_ms", "step_backward_ms", "step_optim_ms",
                "encode_fwd_ms.train", "encode_bwd_ms")
NEW = STEP_METRICS + ("encode_fwd_ms.render",)


def _span(count, graphed, device_s):
    return {"count": count, "graphed": graphed, "host_s": 0.5, "device_s": device_s,
            "device_self_s": None}


def _snapshot():
    """Set-up's capture (an eager first step under window.warmup), then 10
    replays of the captured step, a probe's encode with no parent, and
    views: one of set-up's 6,552 rays and two of 480 x 640."""
    rays = 6552 + 2 * 480 * 640
    return {
        "spans": {
            "window.warmup": _span(1, 0, 2.0),
            "window.warmup/step": _span(1, 0, 1.9),
            "window.warmup/step/step.forward/encode.fwd": _span(2, 0, 1.0),
            "step": _span(10, 10, 10.0),
            "step/step.batch": _span(10, 10, 0.02),
            "step/step.forward": _span(10, 10, 7.0),
            "step/step.forward/encode.fwd": _span(20, 20, 6.0),
            "step/step.backward": _span(10, 10, 2.9),
            "step/step.backward/encode.bwd": _span(20, 20, 1.5),
            "step/step.optim": _span(10, 10, 0.03),
            "encode.fwd": _span(4, 0, 2.0),
            "render.view": _span(3, 0, 16.0),
            "render.view/encode.fwd": _span(123, 0, 0.7 * rays / 1e5),
        },
        "counters": {"render.rays": rays},
        "clock": {"host_ns": 1, "device_ns": 2}, "lost_marks": 0}


def _read(name, snap, monkeypatch, window):
    from enerf_torch.utils import profiling
    monkeypatch.setattr(profiling, "snapshot", lambda: snap, raising=False)
    return harness.reader(name).read(types.SimpleNamespace(window=window))


def test_the_readers_take_the_replayed_step_and_the_views(monkeypatch):
    train = {"seconds": 10.0, "steps": 10}
    want = {"step_batch_ms": 2.0, "step_forward_ms": 700.0, "step_backward_ms": 290.0,
            "step_optim_ms": 3.0, "encode_fwd_ms.train": 600.0, "encode_bwd_ms": 150.0}
    for name, ms in want.items():
        assert _read(name, _snapshot(), monkeypatch, train) == pytest.approx(ms), name
    # ms a view of 480 x 640, whatever set-up's partial view added
    render = {"seconds": 16.0, "views": 2, "view_sizes": [(480, 640)] * 2}
    assert _read("encode_fwd_ms.render", _snapshot(), monkeypatch, render) == \
        pytest.approx(1e3 * 0.7 * 480 * 640 / 1e5)
    # a step span some of whose instances ran eagerly is not split
    snap = _snapshot()
    snap["spans"]["step/step.batch"] = _span(11, 10, 0.02)
    assert _read("step_batch_ms", snap, monkeypatch, train) is None
    assert _read("step_optim_ms", snap, monkeypatch, train) is None


@pytest.mark.parametrize("name", NEW)
def test_the_readers_read_nothing_without_device_marks_or_a_registry(name, monkeypatch):
    window = {"seconds": 1.0, "steps": 3, "views": 1, "view_sizes": [(30, 40)]}
    snap = _snapshot()
    for s in snap["spans"].values():
        s["device_s"] = None
    assert _read(name, snap, monkeypatch, window) is None
    from enerf_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")  # the program before the registry
    assert harness.reader(name).read(types.SimpleNamespace(window=window)) is None


@pytest.mark.parametrize("cell", ["spiral1_nerf.train", "spiral1_nerf.render"])
def test_a_traced_cpu_run_reports_none_of_them(cell):
    r = run_tiny(cell, trace=True)
    assert r["correct"]
    assert not set(NEW) & set(r["metrics"])
