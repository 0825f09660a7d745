"""One run of one cell: set-up, the measured window, the trace, the
metrics and the check that decides `correct`.

Everything that belongs to one cell is found by name: the configuration
in configs/<config>.json (its `data.kind` names the module of inputs/ that
makes the run's inputs), the traffic mix in traffic/<traffic>.json (its
`driver` names the module of drivers/ that drives it), the limits of the
numbers compared in limits/<workload>.json and each metric's reader in
metrics/<metric>.py, or metrics/<metric less its last .suffix>.py where
one reader serves e.g. both `x.train` and `x.render` (`read(run)`, and for
a per-layer metric that measures after the window, `probe(run)`).  A new
cell, configuration, dataset kind, mix, driver or metric is new files and
BENCHMARK.json entries.

The program under test is enerf_torch, through its own entry points: the
config parser, the providers' constructors, the Trainer, its training
window (Trainer._chunk) and Trainer.render_view.  The weights and inputs
are the benchmark's, made from the seed, and handed to the program and to
the reference alike.
"""

import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchmark import devtrace, named

ROOT = named.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "enerf_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix, limits and
    the metrics it reports."""

    def __init__(self, bench, name, root=ROOT):
        matches = [w for w in bench["workloads"] if w["name"] == name]
        if not matches:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = matches[0]
        self.name = name
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = cfgs[self.workload["config"]]
        self.root = Path(root)
        self.config_file = load_json(self.root / self.config_entry["file"])
        self.traffic = load_json(self.root / "benchmark" / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.driver = named.module("drivers", self.traffic["driver"], self.root)
        limits = self.root / "benchmark" / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.exists() else {}
        self.chips = int(self.workload["chips"])
        self.run_seconds = bench["run_seconds"]

        def applies(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    @property
    def cfg(self):
        """The configuration as run: the published keys over the defaults
        the run relies on."""
        return {**self.config_file["defaults"], **self.config_file["config"]}


def reader(name, root=ROOT):
    """The metric's reader: benchmark/metrics/<name>.py under `root`, or
    the file of the name less its last `.suffix` where <name>.py is not
    there."""
    if not named.path("metrics", name, root).exists() and "." in name:
        name = name.rsplit(".", 1)[0]
    return named.module("metrics", name, root)


class Run:
    """What one run measured, for the metric readers: `spans` (seconds of
    calls into the program, from the benchmark's clock or the program's
    own load clocks), `window` (the driver's window: seconds and the work
    done), `trace` (devtrace's reduction; traced runs only), `probes`
    (measurements after the window), `setup_s`, `peak_bytes`."""

    def __init__(self, cell, seed, device, t_start):
        self.cell, self.seed, self.device, self.t_start = cell, int(seed), device, t_start
        self.cfg = cell.cfg
        self.spans, self.window, self.probes = {}, {}, {}
        self.trace, self.setup_s, self.peak_bytes = None, None, None
        self.device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu")
        self.workdir = tempfile.mkdtemp(prefix="enerf_bench_")
        self.driver = None

    def clock(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()


def run_cell(cell, seed, seconds, trace, device, t_start=None):
    """One run; returns the result dict (see run.py)."""
    device = torch.device(device)
    run = Run(cell, seed, device, time.time() if t_start is None else t_start)
    try:
        return _run(run, seconds, trace)
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)


def _run(run, seconds, trace):
    cell, device = run.cell, run.device
    run.spans["imports"] = time.time() - run.t_start
    t0 = time.time()
    run.clock()  # the first synchronize makes the device's context
    run.spans["device_init"] = time.time() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.driver = driver = cell.driver.Driver(run)
    driver.setup()
    run.setup_s = run.clock() - run.t_start
    if trace:
        run.trace = devtrace.traced(lambda: driver.window(seconds), run.device, run.workdir)
    else:
        driver.window(seconds)
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    metrics = cell.per_layer if trace else cell.end_to_end
    modules = {m["name"]: reader(m["name"], cell.root) for m in metrics}
    for mod in modules.values():
        if hasattr(mod, "probe"):
            mod.probe(run)
    t_check = time.time()
    numbers = driver.check()
    print("run " + json.dumps({"spans": run.spans, "window": run.window, "setup_s": run.setup_s,
                               "reference_s": time.time() - t_check, "probes": run.probes,
                               "readings": driver.readings}), file=sys.stderr)
    checks = {}
    for name, value in numbers.items():
        limit = cell.limits.get(name)
        checks[name] = {"value": value, "limit": limit}
    correct = bool(checks) and all(
        c["limit"] is not None and c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values())
    out_metrics = {}
    for m in metrics:
        value = modules[m["name"]].read(run)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": driver.attempted, "failed": driver.failed,
              "metrics": out_metrics, "device": device_info(run, trace)}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    return result


def device_info(run, trace):
    if run.device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": run.device_name, "count": run.cell.chips,
                "memory_peak_bytes": run.peak_bytes}
    if trace and run.trace is not None:
        info["busy_s"] = run.trace["busy_s"]
        info["window_s"] = run.trace["window_s"]
    return info


def forbidden_modules():
    """Top-level names of the loaded modules that the program must not load
    (jax, jaxlib, flax, the JAX package), compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
