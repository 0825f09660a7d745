"""Measurements a traced run makes after the window, for the per-layer
readers: the hash-grid encode's forward, the program's hash_encode on one
render's sample positions (the driver's `encode_inputs`), under
torch.profiler.  Its device time is the union of the intervals of its
kernels and copies in that trace.  It counts only while the window still
runs the encode: where the window's trace lacks a kernel that hash_encode
launches (copies and memsets are not compared), the encode is off the
timed path and the probe reads nothing."""

import torch

from benchmark import devtrace

PROBE = "benchmark.probe.hash_encode"


def encode(run, reps=3):
    """run.probes['encode']: the device seconds a call of the program's
    hash_encode takes (forward, no autograd record), its sample and table
    rows, and its kernels; None off the card, without the window's trace,
    or where the window ran none of them."""
    if "encode" in run.probes:
        return run.probes["encode"]
    run.probes["encode"] = None
    if run.device.type != "cuda" or not run.trace:
        return None
    from enerf_torch.ops.hashgrid import hash_encode

    x01, table, meta = run.driver.encode_inputs()

    def calls():
        for _ in range(reps):
            hash_encode(x01, table, meta)
        torch.cuda.synchronize(run.device)

    with torch.no_grad():
        hash_encode(x01, table, meta)
        torch.cuda.synchronize(run.device)
        t = devtrace.traced(calls, run.device, run.workdir, PROBE)
    missing = sorted(set(t["kernels"]) - set(run.trace["kernels"])) if t else None
    if not t or not t["busy_s"] or missing:
        run.probes["encode_missing_from_window"] = missing
        return None
    run.probes["encode"] = {"seconds": t["busy_s"] / reps, "samples": x01.shape[0],
                            "rows": table.shape[0], "kernels": len(t["kernels"])}
    return run.probes["encode"]
