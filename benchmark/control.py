"""The readings that the limits of `correct` are set from, at a cell's own
size (run it on the card; the benchmark's own runs do not run it):

    python3 benchmark/control.py --workload <name> --mode reference --seeds S1 S2 S3
    python3 benchmark/control.py --workload <name> --mode program --seeds S1 ... S12

`reference`: the cell's driver's `control`, the reference put in the
program's place, computed in the precision below the configuration's
(float8 e4m3 where it states bf16 MLPs), and for a training cell also the
reference with half of each batch left out, each compared with the sound
reference as a run compares the program: the upper readings.  `program`:
whole runs of the program with the window the driver's `program_seconds`
gives (the training cells' cut to one step, the render cell's at the
cell's own length), the lower readings.  One JSON line a seed on standard
output.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("reference", "program"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.time()
        if args.mode == "program":
            result = harness.run_cell(cell, seed, cell.driver.program_seconds(cell), False,
                                      device)
            out = {"program": {k: c["value"] for k, c in result["checks"].items()},
                   "correct": result["correct"]}
        else:
            out = cell.driver.control(cell, seed, device)
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.time() - t0,
                          **out}), flush=True)


if __name__ == "__main__":
    main()
