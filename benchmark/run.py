"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the run's JSON result
(`correct`, `attempted`, `failed`, `metrics`, `device`, with --trace 1
also `breakdown`, and last `checks`: each number compared with its
limit); the numbers compared are also the last lines of standard error.
`attempted` counts the window's training steps or views, `failed` those
whose loss or image was not finite.
The run exits non-zero, printing no result, without the cards, or when
jax, jaxlib, flax or the JAX package were loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's build caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "benchmark" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "benchmark" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one process with few threads: set-up's host work (the inputs, the pose
# precompute, the capture) is single-threaded or nearly so
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "4"
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args()

    import torch

    from benchmark import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import enerf_torch  # noqa: F401  (the program; absent outside a checkout)

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: the port may not", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
