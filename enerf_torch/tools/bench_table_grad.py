"""Block-grid table backward microbenchmark: pair_inputs and K2 together.

    python -m enerf_torch.tools.bench_table_grad [--inputs FILE] [--samples N]
        [--device cuda|cpu]
    PYTHONPATH=<checkout> python enerf_torch/tools/bench_table_grad.py ...

The table backward of `block_encode_fast` forms K2's inputs from the saved
positions and the encoding's gradient (`scatter_accum.pair_inputs`), then
runs K2 (`block_table_grad`).  This times each alone and both together on
the same inputs, so that a change to one that moves cost into the other
shows.  Run as a file, it times whichever enerf_torch comes first on
PYTHONPATH: two checkouts compare on the same inputs, card and call.

Inputs: --samples positions uniform in the unit box with an encoding
gradient ~ N(0, 1) from seed 2, at block 4 and block 3 (chip_smoke.py's
phase 3 at its default 131,072), and with --inputs each render of the K2
path's step 1 that chip_smoke.py saves (build/chip_smoke_k2path/step1.pt:
clustered march samples, most of them out of the box, block 4), and the
first of those renders with every sample out of the box (no live pair:
the cost that does not depend on the live pairs).

On the card each time is the mean device time of one call from CUDA graph
replays (10 calls per graph, 3 replays), and the pair together also from
CUDA events around calls enqueued from the host; on the CPU, where K2 is
its plain version, the wall time of one call.  The last line is one JSON
object of every time, in ms.
"""

import argparse
import json
import time

import torch


def device_ms(fn, device, iters=10, replays=3):
    """Mean time of one call of fn: CUDA graph replays on the card, the
    wall clock on the CPU."""
    if device.type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def host_ms(fn, iters=30):
    """Mean time of one call enqueued from the host, CUDA events around
    `iters` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_set(name, x, g_out, oob, meta, device):
    """Times of pair_inputs, K2 and both on one set of samples."""
    from enerf_torch.ops import scatter_accum as sa
    T = meta.total_rows
    pairs = sa.pair_inputs(x, g_out, meta, oob)

    def both():
        return sa.block_table_grad(*sa.pair_inputs(x, g_out, meta, oob), T, meta)

    r = dict(name=name, samples=x.shape[0], pairs=pairs[0].shape[0],
             live=int((pairs[3] != 0).any(dim=1).sum()),
             pair_inputs_ms=device_ms(lambda: sa.pair_inputs(x, g_out, meta, oob), device),
             k2_ms=device_ms(lambda: sa.block_table_grad(*pairs, T, meta), device),
             both_ms=device_ms(both, device))
    if device.type == "cuda":
        r["both_host_ms"] = host_ms(both)
    print(f"[bench_table_grad] {name}: {r['samples']} samples, {r['pairs']} pairs "
          f"({r['live']} live): pair_inputs {r['pair_inputs_ms']:.4f} ms, K2 "
          f"{r['k2_ms']:.4f} ms, both {r['both_ms']:.4f} ms"
          + (f" ({r['both_host_ms']:.4f} ms enqueued from the host)" if "both_host_ms" in r
             else ""), flush=True)
    return r


def run(samples, inputs, device):
    from enerf_torch.models.field import FieldStatic
    metas = {b: FieldStatic(bound=1.0, encoding="blockgrid", grid_block=b).grid_meta
             for b in (4, 3)}
    gen = torch.Generator(device=device).manual_seed(2)
    results = []
    for block, meta in metas.items():
        x = torch.rand(samples, 3, device=device, generator=gen)
        g_out = torch.randn(samples, 2 * meta.num_levels, device=device, generator=gen)
        results.append(time_set(f"uniform blk{block}", x, g_out, None, meta, device))
    if inputs:
        renders = torch.load(inputs, map_location=device)
        for i, r in enumerate(renders):
            results.append(time_set(f"K2 path render {i + 1} blk4", r["x"], r["g_out"],
                                    r["oob"], metas[4], device))
        r = renders[0]
        results.append(time_set("K2 path render 1 blk4, no live pair", r["x"], r["g_out"],
                                torch.ones_like(r["oob"]), metas[4], device))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=4096 * 32)
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_table_grad: no CUDA device (pass --device cpu)")
    print(json.dumps({"bench_table_grad": run(args.samples, args.inputs, device)}))


if __name__ == "__main__":
    main()
