"""The benchmark's cells cut to a size the CPU runs in seconds, for the
harness's tests: the same keys, drivers and references, a few rays and
samples, two grid levels, few events, small frames."""

from benchmark import harness

TINY = {"batch_size_evs": 64, "num_rays": 64, "num_steps": 8, "num_levels": 2,
        "max_ray_batch": 500}


def tiny_cell(name, root=harness.ROOT):
    bench = harness.load_json(root / "BENCHMARK.json")
    cell = harness.Cell(bench, name, root)
    cf = cell.config_file
    cf["config"].update(TINY)
    cf["defaults"].update({k: v for k, v in TINY.items() if k in cf["defaults"]})
    if cf["data"]["kind"] == "tumvie":
        cf["data"].update(num_events=20000, active_pixels_per_window=300)
    else:
        cf["data"]["camera"].update(W=40, H=30, cx=20.0, cy=15.0, fx=35.0, fy=35.0)
        cf["data"]["image_cells"] = [3, 4]
    return cell


def run_tiny(name, seed=12345, seconds=0.5, trace=False, device="cpu"):
    return harness.run_cell(tiny_cell(name), seed, seconds, trace, device)
