"""The trace reduction: union of device intervals, gaps named by the host."""

from benchmark import devtrace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_union_top_ops_and_named_gaps():
    events = [
        ev("user_annotation", devtrace.WINDOW, 100.0, 100.0),
        ev("kernel", "a", 90.0, 20.0),      # clipped to 100..110
        ev("kernel", "b", 105.0, 10.0),     # overlaps a: counted once
        ev("gpu_memcpy", "copy", 150.0, 10.0),
        ev("kernel", "a", 190.0, 20.0),     # clipped to 190..200
        ev("cuda_runtime", "cudaStreamSynchronize", 112.0, 40.0),
        ev("cpu_op", "aten::mul", 161.0, 30.0),
    ]
    r = devtrace.reduce_events(events)
    assert r["window_s"] == 100e-6
    assert abs(r["busy_s"] - 35e-6) < 1e-12  # 100..115, 150..160, 190..200
    assert r["device_ops"][0] == ["a", 20e-6]
    gaps = dict(r["idle_gaps"])
    assert abs(gaps["cudaStreamSynchronize"] - 35e-6) < 1e-12
    assert abs(gaps["aten::mul"] - 30e-6) < 1e-12
    assert r["busy_s"] <= r["window_s"]
    assert r["kernels"] == ["a", "b"]  # kernels alone, not the copy


def test_no_window_no_reading():
    assert devtrace.reduce_events([ev("kernel", "a", 0.0, 1.0)]) is None
