"""Random-row gather microbenchmark on the card: which row rate is attainable?

    python -m enerf_torch.tools.bench_gather [--rows T] [--m M] [--d D ...]
        [--windows W ...] [--device cuda|cpu]

Counterpart of scripts/bench_gather.py.  The encoder forward gathers one
random table row per (sample, level), and the table gradient scatters the
same stream back, so these rates bound both stages.  Variants, in the JAX
script's order, for each row width D:

  index_select random        table.index_select(0, idx): the encoder's path
  index_select sorted        the same on sorted indices, the sort included
  index_add_ random          zeros(T, D).index_add_(0, idx, ones(M, D)): the
                             duplicate-index scatter-add of the table gradient
  group_gather8 W=w          kernel K3 (ops/group_gather.py): M / 8 random
                             8-row groups, the same bytes; w groups in
                             flight per thread block

Timing: each variant runs as chains of 30 iterations in which each
iteration's indices come from the previous iteration's output (an
always-zero bump), 3 chains per timed run after one untimed chain; the
clock ends with torch.cuda.synchronize().  K3 is first held exactly against
its plain version (the whole output on the card; on the CPU, where the
wrapper runs the plain version, the first 64 groups against a row-by-row
take).  A failure raises: nothing is swallowed.
"""

import argparse
import sys
import time

import torch

K = 30  # chained iterations per timed execution


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_chain(step, idx0, device, iters=3):
    """step: idx -> (next_idx, probe).  Returns seconds per chained iteration."""

    def chain(idx):
        probes = []
        for _ in range(K):
            idx, probe = step(idx)
            probes.append(probe)
        return idx, torch.stack(probes).sum()

    out = chain(idx0)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = chain(out[0])  # chain across executions too
    _sync(device)
    return (time.perf_counter() - t0) / (iters * K)


def _bump(idx, probe, modulo):
    """The next indices: idx + 1 + (an always-zero, data-dependent bump)."""
    return (idx + 1 + (probe > 1e30).to(torch.int32)) % modulo


def check_exact(gidx, table, windows):
    """K3 against its plain version; returns True when they are equal."""
    from enerf_torch.ops.group_gather import group_gather, group_gather_reference
    got = group_gather(gidx, table, windows)
    if table.is_cuda:
        return bool(torch.equal(got, group_gather_reference(gidx, table)))
    rows = (gidx[:64, None].long() * 8 + torch.arange(8)).reshape(-1)
    return bool(torch.equal(got[:512], table[rows]))


def run(rows, m, ds, windows, device):
    """Run every variant; returns a list of result dicts (one per line)."""
    from enerf_torch.ops.group_gather import group_gather

    T = rows - rows % 8
    M = m
    results = []
    gen = torch.Generator(device=device)

    def report(D, variant, count, unit, dt, nbytes, extra=""):
        rec = dict(D=D, variant=variant, seconds=dt, per_s=count / dt, unit=unit,
                   rows_per_s=M / dt, gb_per_s=nbytes / dt / 1e9)
        results.append(rec)
        print(f"D={D:4d} {variant:<30s} {count / dt / 1e6:9.1f} M {unit}/s "
              f"{M / dt / 1e6:9.1f} M rows/s {nbytes / dt / 1e9:8.1f} GB/s{extra}", flush=True)

    for D in ds:
        gen.manual_seed(1)
        tbl = torch.randn(T, D, device=device, generator=gen)
        row_b = D * 4
        idx0 = torch.randint(0, T, (M,), device=device, generator=gen.manual_seed(0),
                             dtype=torch.int32)

        def take_step(idx):
            out = tbl.index_select(0, idx)
            return _bump(idx, out[0, 0], T), out[0, 0]

        report(D, "index_select random", M, "rows", timed_chain(take_step, idx0, device),
               M * row_b)

        def sorted_step(idx):
            out = tbl.index_select(0, torch.sort(idx).values)
            return _bump(idx, out[0, 0], T), out[0, 0]

        report(D, "index_select sorted(+sortcost)", M, "rows",
               timed_chain(sorted_step, idx0, device), M * row_b)

        upd = torch.ones(M, D, device=device)

        def scatter_step(idx):
            # the table gradient's mechanism: a duplicate-index add
            out = torch.zeros(T, D, device=device).index_add_(0, idx, upd)
            return _bump(idx, out[0, 0], T), out[0, 0]

        report(D, "index_add_ random", M, "rows", timed_chain(scatter_step, idx0, device),
               M * row_b, " (update-stream bytes)")
        del upd

        # K3: M / 8 groups deliver the same bytes
        MG, TG = M // 8, T // 8
        gidx0 = torch.randint(0, TG, (MG,), device=device, generator=gen.manual_seed(2),
                              dtype=torch.int32)
        for W in windows:
            exact = check_exact(gidx0, tbl, W)
            if not exact:
                raise AssertionError(f"group_gather W={W} D={D} differs from its plain version")

            def k3_step(gidx, W=W):
                out = group_gather(gidx, tbl, W)
                return _bump(gidx, out[0, 0], TG), out[0, 0]

            report(D, f"group_gather8 W={W:2d} random", MG, "grp",
                   timed_chain(k3_step, gidx0, device), MG * 8 * row_b, f"  exact={exact}")
    return results


def main(argv=None):
    from enerf_torch.backend import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=134_272)  # 16 x 8392
    ap.add_argument("--m", type=int, default=1 << 21)
    ap.add_argument("--d", type=int, nargs="*", default=[128])
    ap.add_argument("--windows", type=int, nargs="*", default=[4, 8, 16])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[bench_gather] device {device} ({name}); table {args.rows - args.rows % 8} rows, "
          f"{args.m} rows gathered per iteration, {K} chained iterations x 3 runs")
    return run(args.rows, args.m, args.d, args.windows, device)


if __name__ == "__main__":
    main(sys.argv[1:])
