#!/usr/bin/env python3
"""Chip smoke test of enerf_torch, the PyTorch + CUDA port, on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the result lines):
  1. device: the card's name and power limit (nvidia-smi), CUDA required;
  2. build: every csrc/*.cu kernel, one nvcc each, started together, with
     the -Xptxas -v register / shared-memory / spill lines, and the count of
     tensor-core instructions in K1's SASS and of bulk copies in K3's
     (cuobjdump; K1's bf16 kernel without one fails);
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes, with the stated tolerances; kernel, plain, library and
     bound times and the share of the bound (K1 fused_field_head, timed
     over 6 input sets that together exceed L2; K2 block_table_grad at
     block 4 and 3; K3 group_gather, bit-exact, at the gather benchmark's
     default shape and at the block-grid table's);
  3b. gather benchmark: enerf_torch.tools.bench_gather at its defaults and
     with --rows 97824 --d 250, every variant's rows/s and GB/s (the path
     that runs K3);
  4. main path: the --ff -O event trainer at full field width (16 x 2
     levels, blk4, 2^19 hash budget, hidden 64, geo 15, SH 4) on the
     synthetic event scene, one epoch of 48 steps (occupancy updates at
     steps 0, 16, 32) through train(train, val, 1): a checkpoint and the
     affine-corrected evaluation of 2 val views; then a new Trainer resumed
     from the 'latest' checkpoint must hold the same params, EMA and step;
  5. inference: one validation view through the alive-ray inference renderer;
  6. breakdown: one more step, split into its parts on the host clock;
  7. K2 path: bench.py's march step at its reference shape (16 x 2, blk4,
     separate marches, 8192 rays x 32 samples, compact_frac 0.25, bf16,
     the ball bitfield) with fast_table_grad on (K2) and off (index_add_),
     from the same state with the same noise; step 1's table gradients
     must agree within K2's tolerance, scaled to the gradients' size;
  8. no-event pair: 8 main-path steps with negative_event_sampling and
     precompute_evs_poses=0 (the device slerp); loss_no_evs must be logged
     and finite at every step, and > 0 at one step at least;
  9. default path: configs/synthetic_demo.txt --event_only 0 (the path of
     the published configs: hash grid 16 x 2, 2^19, unfused MLPs, 128
     fixed steps, the frame term), one epoch of 48 steps through
     train(train, val, 1) with a checkpoint and the evaluation of 2 val
     views (the affine correction applied to the same renders), a resumed
     Trainer bit-equal, and one more step split into parts;
 10. frames on the march: --ff -O --event_only 0 --march_warmup 4, 8 steps:
     the trainer's mark_untrained_grid from the first frame camera (its
     share of marked cells > 0 and equal to a direct call's), 4 fixed-step
     steps with remat, 4 march steps
     through K1; loss_frames finite at every step.
Then a `{"kernels": [...]}` line, the card line, and last the result line
`{"ok": true, "device": {...}}`.
"""

import glob
import itertools
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor core, f32 CUDA core

# K1 tolerances against its plain version on the same inputs:
#  - f32: the same f32 arithmetic summed in another order -> rel 1e-4;
#  - bf16: both round activations to bf16 at the same points, but a sum in
#    another order can land on the other side of a bf16 rounding (2^-8
#    relative) and the flip propagates: rgb (a sigmoid) within 1e-2
#    absolute, sigma = exp(logit) within 3e-2 relative.
TOL = {"float32": {"sigma_rel": 1e-4, "rgb_rel": 1e-4},
       "bfloat16": {"sigma_rel": 3e-2, "rgb_abs": 1e-2}}


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available (power limit not measured)"


def time_ms(fn, iters=30, warmup=3):
    """Mean device time of one call, from CUDA events around `iters` calls
    (a caller whose inputs must not be L2-hot rotates them inside `fn`)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=30, replays=3):
    """Mean device time of one call with no host in the way: `iters` calls
    captured in one CUDA graph (after 3 calls outside it), replayed
    `replays` times between CUDA events.  For kernels shorter than the
    host's time to enqueue them, where time_ms would time the host."""
    import torch
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def phase_build():
    from enerf_torch.ops import cuda_build
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(str(cuda_build.CSRC / "*.cu")))
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(cuda_build.compile_library, names))
    for name in names:
        cuda_build.load_library(name)
        ptx = [ln.strip() for ln in cuda_build.BUILD_LOGS.get(name, "").splitlines()
               if any(k in ln for k in ("entry function", "registers", "spill", "smem"))]
        for ln in ptx:
            print(f"[build] {name}: {ln}")
    print(f"[build] ok: {names} in {time.time() - t0:.1f} s")
    sass_counts()
    return names


def sass_functions(name):
    """{kernel symbol: [SASS instruction lines]} of the built csrc/<name>.cu,
    from cuobjdump -sass; raises if the toolkit has no cuobjdump."""
    import shutil
    from enerf_torch.ops import cuda_build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump is not on this machine: the SASS of the kernels "
                           "cannot be counted")
    out = subprocess.run([tool, "-sass", str(cuda_build.compile_library(name))],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            cur = funcs.setdefault(ln.split("Function :")[1].strip(), [])
        elif cur is not None and ln.strip().startswith("/*") and "*/" in ln:
            cur.append(ln.split("*/", 1)[1].strip())
    return funcs


def sass_counts():
    """Tensor-core instructions (HMMA / HGMMA) in K1's SASS and bulk copies
    (UBLKCP) in K3's; K1's bf16 kernel must have tensor-core instructions
    and K3 (the TMA design) bulk copies."""
    def count(funcs, key, ops):
        return {f: sum(any(ins.startswith(op) for op in ops) for ins in body)
                for f, body in funcs.items() if key in f}

    k1 = count(sass_functions("fused_field_head"), "head_", ("HMMA", "HGMMA"))
    k3 = count(sass_functions("group_gather"), "group_gather", ("UBLKCP",))
    bf16 = sum(c for f, c in k1.items() if "bf16" in f)
    print(f"[build] SASS: fused_field_head tensor-core instructions (HMMA/HGMMA) per kernel "
          f"{k1}; group_gather bulk copies (UBLKCP) per kernel {k3} (design kept: TMA bulk "
          f"copies through a shared-memory ring with L2 evict_last / evict_first policies)")
    if not bf16:
        raise AssertionError("K1's bf16 kernel has no tensor-core instruction in its SASS")
    if not sum(k3.values()):
        raise AssertionError("K3 has no bulk-copy instruction in its SASS")


def head_inputs(B, dtype, gen, sets=1):
    """K1's operands at the main path's widths: `sets` pairs of enc [B, 32]
    (16 levels x 2) and SH-4 direction encodings [B, 16], then weights
    drawn like init_field_params (U(+-1/sqrt(fan_in)), [in, out] layout)."""
    import torch
    from enerf_torch.ops.sh import sh_encode

    dev = "cuda"
    xs = []
    for _ in range(sets):
        enc = (torch.rand(B, 32, device=dev, generator=gen) * 2 - 1) * 0.5
        d = torch.randn(B, 3, device=dev, generator=gen)
        xs.append((enc.to(dtype), sh_encode(d / d.norm(dim=-1, keepdim=True), 4).to(dtype)))

    def w(i, o):
        b = 1.0 / math.sqrt(i)
        return (torch.rand(i, o, device=dev, generator=gen) * 2 - 1) * b

    ws = [w(32, 64), w(64, 16), w(31, 64), w(64, 64), w(64, 1)]
    return xs, [a.to(dtype) for a in ws]


def bound_of(B, dtype_name, E=32, D=16, G=15, HS=64, HC=64, C=1):
    """Least time for K1's work: inputs read once, outputs written once,
    18,432 FLOP per sample at the main widths."""
    elt = 2 if dtype_name == "bfloat16" else 4
    n_w = E * HS + HS * (1 + G) + (D + G) * HC + HC * HC + HC * C
    nbytes = B * (E + D) * elt + n_w * elt + B * (1 + C) * 4
    flops = 2.0 * B * n_w
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def rotating(fn, sets):
    """fn over the input sets in turn, one set per call."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def phase_kernels():
    """K1 against its plain version at the main path's B (bf16, the --ff
    path's type, and f32).  The timed launches rotate over 6 input sets
    (82 MB in bf16), so no launch reads inputs left in the 50 MB L2."""
    import torch
    from enerf_torch.ops import fused_mlp

    B = 4096 * 32  # rays x compacted samples per render on the main path
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        xs, ws = head_inputs(B, dt, gen, sets=6)
        with torch.no_grad():
            s_k, c_k = fused_mlp.launch_kernel(*xs[0], *ws)
            s_p, c_p = fused_mlp.head_reference(*xs[0], *ws)
        torch.cuda.synchronize()
        for a in (s_k, c_k):
            if not torch.isfinite(a).all():
                raise AssertionError(f"K1 {name}: non-finite output")
        sig_rel = float(((s_k - s_p).abs() / s_p.abs().clamp(min=1e-30)).max())
        rgb_abs = float((c_k - c_p).abs().max())
        rgb_rel = float(((c_k - c_p).abs() / c_p.abs().clamp(min=1e-30)).max())
        max_abs = max(float((s_k - s_p).abs().max()), rgb_abs)
        differ = float(torch.cat([s_k != s_p, (c_k != c_p).reshape(-1)]).float().mean())
        tol = TOL[name]
        ok = sig_rel <= tol["sigma_rel"] and (
            rgb_rel <= tol["rgb_rel"] if "rgb_rel" in tol else rgb_abs <= tol["rgb_abs"])
        with torch.no_grad():
            # device times from CUDA graphs: the bf16 kernel is shorter than
            # the host's time to enqueue a call
            ms = graph_ms(rotating(lambda e, d: fused_mlp.launch_kernel(e, d, *ws), xs))
            plain_ms = graph_ms(rotating(lambda e, d: fused_mlp.head_reference(e, d, *ws), xs))
            host_ms = time_ms(rotating(lambda e, d: fused_mlp.launch_kernel(e, d, *ws), xs))
            extra = dict(host_ms=host_ms)
            timing = f"; one call enqueued from the host {host_ms:.4f} ms"
            if name == "bfloat16":
                # the kernel alone on weights packed once; the packing alone
                pack = fused_mlp.pack_head(*ws)
                kernel_ms = graph_ms(rotating(
                    lambda e, d: fused_mlp.launch_packed(e, d, pack), xs))
                pack_ms = graph_ms(lambda: fused_mlp.pack_head(*ws))
                extra.update(kernel_ms=kernel_ms, pack_ms=pack_ms)
                timing = (f" (the kernel alone {kernel_ms:.4f} ms, pack_head {pack_ms:.4f} ms)"
                          + timing)
        bound_ms, bound_by, nbytes, flops = bound_of(B, name)
        share = bound_ms / ms
        print(f"[kernel] fused_field_head {name} B={B}: sigma rel err {sig_rel:.3e}, "
              f"rgb abs err {rgb_abs:.3e} rel {rgb_rel:.3e}, max abs err {max_abs:.3e}, "
              f"outputs that differ {differ:.4%} (tol {tol}) -> "
              f"{'ok' if ok else 'FAIL'}; launch_kernel {ms:.4f} ms{timing}; plain "
              f"{plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP), share of bound {share:.1%}"
              + (f" ({bound_ms / extra['kernel_ms']:.1%} for the kernel alone)"
                 if "kernel_ms" in extra else "")
              + "; device times from CUDA graphs, 6 rotating input sets")
        if not ok:
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, share_of_bound=share,
                             differ_share=differ, **extra)
        del xs
    # how the bf16 kernel's time grows with B (a fixed cost and a rate)
    sweep = []
    for b in (B // 4, B * 4):
        xs, ws = head_inputs(b, torch.bfloat16, gen, sets=max(2, 6 * B // b))
        pack = fused_mlp.pack_head(*ws)
        with torch.no_grad():
            b_ms = graph_ms(rotating(lambda e, d: fused_mlp.launch_packed(e, d, pack), xs))
        sweep.append(f"B={b} {b_ms:.4f} ms (bound {bound_of(b, 'bfloat16')[0]:.4f} ms)")
        del xs
    print("[kernel] fused_field_head bfloat16, the kernel alone by batch: " + "; ".join(sweep))
    return results


def k2_bound(pairs, total_rows, row_cells):
    """Least time for K2's work: 36 bytes read per (sample, level) pair
    (rid, lo, frac, g as int32 / f32) and the table gradient written once;
    ~47 f32 operations per pair (3 subtractions, 12 weight and 16 gradient
    products, 16 additions)."""
    nbytes = pairs * 36 + total_rows * 2 * row_cells * 4
    flops = pairs * 47.0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def k2_agrees(diff, mag, floor):
    """K2's tolerance: atomics sum in any order, so per cell |diff| <=
    1e-5 * A + floor, A the float64 scatter of |g| * W, and diff is exactly 0
    where A is 0 (cells that no pair adds to).  A NaN fails.  Returns (ok,
    largest |diff| / (1e-5 * A + floor))."""
    ratio = float((diff / (1e-5 * mag + floor)).max())
    return ratio <= 1.0 and bool((diff[mag == 0] == 0).all()), ratio


def k2_magnitude(pair_list, total_rows, meta):
    """A of K2's tolerance: the float64 scatter of |g| * W over the pairs."""
    import torch
    from enerf_torch.ops import scatter_accum as sa
    return sum(sa.block_table_grad_reference(rid, lo, frac, g.abs(), total_rows, meta,
                                             torch.float64)
               for rid, lo, frac, g in pair_list)


def k2_within_bound(got, pairs, total_rows, meta):
    """K2 (or its f32 twin) against the float64 twin, with the absolute
    floor 1e-7 (for g ~ N(0, 1))."""
    import torch
    from enerf_torch.ops import scatter_accum as sa
    ref64 = sa.block_table_grad_reference(*pairs, total_rows, meta, torch.float64)
    return k2_agrees((got.double() - ref64).abs(), k2_magnitude([pairs], total_rows, meta),
                     1e-7)


def hook_k2_inputs(loss, store):
    """Before each block_encode_fast node of loss's graph runs its backward,
    append to `store` the (rid, lo, frac, g) that the node hands K2, formed
    from its saved positions and its incoming gradient."""
    from enerf_torch.ops import scatter_accum as sa
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
        if node.name() == "_BlockEncodeFastBackward":
            def pre(grad_outputs, node=node):
                x, oob = node.saved_tensors
                store.append(sa.pair_inputs(x, grad_outputs[0], node.meta, oob))
            node.register_prehook(pre)


def phase_k2_kernel():
    """K2 against its plain version at the main path's shape: 131,072
    samples (4096 rays x 64 x 0.5) x 16 levels x 2 features, positions in
    the unit box and g ~ N(0, 1) from a seed; block 4 and block 3."""
    import torch
    from enerf_torch.models.field import FieldStatic
    from enerf_torch.ops import scatter_accum as sa
    from enerf_torch.ops.blockgrid import _trilinear_weights

    B = 4096 * 32
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for block in (4, 3):
        meta = FieldStatic(bound=1.0, encoding="blockgrid", grid_block=block).grid_meta
        T, RC = meta.total_rows, meta.row_cells
        x = torch.rand(B, 3, device="cuda", generator=gen)
        g = torch.randn(B, 2 * meta.num_levels, device="cuda", generator=gen)
        pairs = sa.pair_inputs(x, g, meta)
        P = pairs[0].shape[0]
        got = sa.launch_kernel(*pairs, T, meta)
        twin = sa.block_table_grad_reference(*pairs, T, meta)
        torch.cuda.synchronize()
        ok_k, ratio_k = k2_within_bound(got, pairs, T, meta)
        ok_t, ratio_t = k2_within_bound(twin, pairs, T, meta)
        max_abs = float((got - twin).abs().max())
        ms = time_ms(lambda: sa.launch_kernel(*pairs, T, meta))
        plain_ms = time_ms(lambda: sa.block_table_grad_reference(*pairs, T, meta), iters=5)
        # the library call: index_add_ of the prebuilt dense rows, the
        # scatter of the plain version and of the trainer's default backward
        rid, lo, frac, gg = pairs
        rows = (gg[:, :, None] * _trilinear_weights(lo, frac, meta)[:, None, :]).reshape(P, -1)
        rid64, acc = rid.long(), torch.zeros(T, 2 * RC, device="cuda")
        library_ms = time_ms(lambda: acc.index_add_(0, rid64, rows), iters=5)
        del rows, acc
        bound_ms, bound_by, nbytes = k2_bound(P, T, RC)
        ok = ok_k and ok_t
        print(f"[kernel] block_table_grad blk{block} {P} pairs -> [{T}, {2 * RC}]: "
              f"|K2 - f64| / bound {ratio_k:.3e}, |f32 twin - f64| / bound {ratio_t:.3e} "
              f"(bound 1e-5 * sum|g W| + 1e-7), |K2 - twin| max {max_abs:.3e} -> "
              f"exactly 0 where sum|g W| is 0 -> "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({nbytes / 1e6:.1f} MB), share of bound {bound_ms / ms:.1%}")
        if not ok:
            raise AssertionError(f"K2 blk{block} is outside its bound of the float64 twin")
        results[block] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                              share_of_bound=bound_ms / ms)
    return results


def k3_bound(groups, unique_groups, d):
    """Least time for K3's work: every distinct table group read once (a
    group gathered again is reuse, not new traffic), every output group
    written once (32 d bytes each) and each 4-byte index read; no
    arithmetic."""
    nbytes = (unique_groups + groups) * 32 * d + 4 * groups
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def phase_k3_kernel():
    """K3 against its plain version (one index_select, also the library
    call) at the gather benchmark's default shape and at the block-grid
    table's (97,824 rows x 250 f32), 262,144 random groups: bit-exact."""
    import torch
    from enerf_torch.ops import group_gather as gg

    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}
    for rows, d in ((134_272, 128), (97_824, 250)):
        T, groups = rows - rows % 8, (1 << 21) // 8
        table = torch.randn(T, d, device="cuda", generator=gen)
        gidx = torch.randint(0, T // 8, (groups,), device="cuda", generator=gen,
                             dtype=torch.int32)
        got = gg.launch_kernel(gidx, table)
        ref = gg.group_gather_reference(gidx, table)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, ref))
        max_abs = float((got - ref).abs().max())
        del got, ref
        ms = time_ms(lambda: gg.launch_kernel(gidx, table))
        plain_ms = time_ms(lambda: gg.group_gather_reference(gidx, table))
        unique = int(torch.unique(gidx).numel())
        bound_ms, bound_by, nbytes = k3_bound(groups, unique, d)
        print(f"[kernel] group_gather {groups} groups ({unique} distinct) of 8 x {d} f32 "
              f"from [{T}, {d}]: "
              f"bit-exact {exact} (max |diff| {max_abs:.1e}) -> {'ok' if exact else 'FAIL'}; "
              f"kernel {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s moved), plain = library "
              f"(index_select) {plain_ms:.4f} ms, K3 / index_select {ms / plain_ms:.4f}, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e9:.3f} GB), share of "
              f"bound {bound_ms / ms:.1%}")
        if not exact:
            raise AssertionError(f"K3 D={d} differs from its plain version")
        results[d] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms)
    # what holds K3 back: the same 262,144 output groups of 8 x 128 drawn
    # from tables that fit L2, and the output's write alone
    groups, d = (1 << 21) // 8, 128
    out = torch.empty(groups * 8, d, device="cuda")
    zero_ms = time_ms(lambda: out.zero_())
    del out
    sweep = []
    for table_groups in (2048, 4096, 8192):
        table = torch.randn(table_groups * 8, d, device="cuda", generator=gen)
        gidx = torch.randint(0, table_groups, (groups,), device="cuda", generator=gen,
                             dtype=torch.int32)
        k_ms = time_ms(lambda: gg.launch_kernel(gidx, table))
        p_ms = time_ms(lambda: gg.group_gather_reference(gidx, table))
        sweep.append(f"{table.numel() * 4 / 1e6:.1f} MB table: K3 {k_ms:.4f} ms, "
                     f"index_select {p_ms:.4f} ms")
    print(f"[kernel] group_gather by table size ({groups} groups of 8 x {d} f32 each): "
          + "; ".join(sweep) + f"; the output's write alone (zero_ of "
          f"{groups * 32 * d / 1e9:.2f} GB) {zero_ms:.4f} ms")
    return results


def phase_gather_bench():
    """The path that runs K3: the port's gather benchmark at its defaults
    and at the block-grid table's shape, K3's launch count read around it."""
    from enerf_torch.ops import group_gather as gg
    from enerf_torch.tools import bench_gather

    gg.group_gather.launches = 0
    results = bench_gather.main([]) + bench_gather.main(["--rows", "97824", "--d", "250"])
    launches = gg.group_gather.launches
    k3 = [r for r in results if r["variant"].startswith("group_gather8")]
    print(f"[bench] {len(results)} variants timed; K3 launches {launches}")
    if len(results) != 12 or len(k3) != 6 or launches == 0:
        raise AssertionError(f"gather benchmark incomplete: {len(results)} lines, "
                             f"K3 launches {launches}")
    return launches


def smoke_config(workspace, *extra):
    from enerf_torch.config import build_config
    return build_config([
        "--mode", "synthetic", "--H", "64", "--W", "64",
        "--events", "1", "--event_only", "1", "--out_dim_color", "1",
        "--C_thres", "0.2", "--bound", "1", "--lr", "0.005",
        "--ff", "-O", "--num_levels", "16", "--level_dim", "2", "--grid_block", "4",
        "--hidden_dim", "64", "--hidden_dim_color", "64", "--geo_feat_dim", "15",
        "--batch_size_evs", "4096", "--march_samples", "64", "--compact_frac", "0.5",
        "--iters", "48", "--log_every", "8", "--seed", "0",
        "--val_idxs", "0", "--val_idxs", "20", "--eval_interval", "1",
        "--outdir", workspace, *extra])


def phase_main_path(workspace):
    import numpy as np
    import torch
    from enerf_torch.data.provider import make_providers
    from enerf_torch.ops import fused_mlp, scatter_accum
    from enerf_torch.render.march import march_rays
    from enerf_torch.train.trainer import Trainer

    cfg = smoke_config(workspace)
    trainer = Trainer(cfg, device="cuda", workspace=workspace)
    meta = trainer.static.grid_meta
    print(f"[main] field: {meta.num_levels}x{meta.level_dim} levels, blk{meta.block}, "
          f"{meta.total_rows} rows x {meta.row_cells * meta.level_dim} f32 "
          f"({meta.total_rows * meta.row_cells * meta.level_dim * 4 / 1e6:.1f} MB table), "
          f"fused head {trainer.static.use_fused_head}, compute {trainer.static.compute_dtype}")
    t0 = time.time()
    train, val = make_providers(cfg, device=trainer.device)
    print(f"[main] synthetic data {cfg.H}x{cfg.W}: {time.time() - t0:.1f} s; "
          f"{len(val.val_views())} val views")
    steps = 48
    train.steps_per_epoch = steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.fused_field_head.launches = 0
    scatter_accum.block_table_grad.launches = 0
    march_rays.host_syncs = 0
    t0 = time.time()
    trainer.train(train, val, max_epoch=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fused_mlp.fused_field_head.launches
    k2_launches = scatter_accum.block_table_grad.launches
    secs = trainer.epoch_seconds  # the trainer's synchronized split of the epoch
    step_s = secs["steps"]
    losses = [aux["loss"] for _, aux in trainer.history]
    print(f"[main] losses at logged steps: "
          + ", ".join(f"{s}:{aux['loss']:.5f}" for s, aux in trainer.history))
    print(f"[main] train(train, val, 1): {wall:.2f} s = {steps / wall:.3f} steps/s with the "
          f"epoch tail; the {steps} steps {step_s:.2f} s = {steps / step_s:.3f} steps/s "
          f"(3 occupancy updates included); tail "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items() if k != "steps")
          + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"K1 launches {launches} (evaluation included); K2 launches {k2_launches}; "
          f"march host syncs {march_rays.host_syncs} (steps and evaluation)")
    res = trainer.last_eval
    print("[main] eval: " + ", ".join(
        f"{k} {res.get(k)}" for k in ("psnr", "ssim", "affine_a", "affine_b",
                                      "psnr_corrected", "ssim_corrected")))
    if not (len(losses) == steps // cfg.log_every and np.isfinite(losses).all()):
        raise AssertionError(f"main path losses not all finite: {losses}")
    if trainer.occupancy.iter_density != 3:
        raise AssertionError(f"iter_density {trainer.occupancy.iter_density} != 3")
    if launches < 2 * steps:
        raise AssertionError(f"K1 launched {launches} times in {steps} steps")
    if k2_launches:
        raise AssertionError("the main path's table backward is index_add_, yet K2 launched")
    if not all(np.isfinite(res.get(k, np.nan)) for k in ("psnr_corrected", "ssim_corrected")):
        raise AssertionError(f"evaluation gave no finite corrected metrics: {res}")
    return trainer, train, val, launches


def phase_resume(trainer, workspace):
    """A new Trainer resumed from the 'latest' checkpoint holds the saved
    params, EMA weights and step bit for bit."""
    import torch
    from enerf_torch.train.trainer import Trainer

    t0 = time.time()
    resumed = Trainer(trainer.cfg, device="cuda", workspace=workspace, use_checkpoint="latest")
    same = (resumed.state.step == trainer.state.step and resumed.epoch == trainer.epoch
            and all(torch.equal(resumed.state.params[k], p)
                    and torch.equal(resumed.state.ema_params[k], trainer.state.ema_params[k])
                    for k, p in trainer.state.params.items()))
    print(f"[resume] Trainer(ckpt='latest') at step {resumed.state.step}, epoch "
          f"{resumed.epoch}, in {time.time() - t0:.2f} s: params, EMA and step "
          f"{'bit-equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("the resumed trainer differs from the saved state")


def phase_breakdown(trainer, train):
    """Host-clock split of one more main-path step into its parts, each
    ending in a synchronize (so the parts add up to a slower step than the
    loop's, which overlaps host and device)."""
    import torch
    from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
    from enerf_torch.render.march import composite_from_march, march_rays
    from enerf_torch.render.occupancy import update_occupancy
    from enerf_torch.train import losses
    from enerf_torch.train.step import draw_noise

    ss, state, fs = trainer.ss, trainer.state, trainer.ss.field_static
    occ = trainer.occupancy.occ_bitfield
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = parts.get(name, 0.0) + (time.time() - t0) * 1e3
        return out

    batch = timed("batch", lambda: train.train_step_batch(trainer.generator))
    N = batch["pols"].shape[0]
    noise = draw_noise(ss, N, trainer.generator, trainer.device)
    state.zero_grad()
    syncs0 = march_rays.host_syncs
    images = []
    for i in (1, 2):
        o, d = batch[f"rays_evs_o{i}"], batch[f"rays_evs_d{i}"]
        nears, fars = near_far_from_aabb(o, d, aabb_tensor(fs.bound, o.device), ss.min_near)
        ts, dts, valid = timed("march", lambda: march_rays(
            o, d, occ, nears, fars, jitter=noise[f"jitter{i}"],
            num_samples=ss.march_samples, max_steps=ss.max_steps,
            cascades=occ.shape[0], bound=fs.bound, dt_gamma=ss.dt_gamma, perturb=True))
        out = timed("encode + K1 + composite (forward)", lambda: composite_from_march(
            state.params, fs, o, d, ts, dts, valid, nears, fars,
            bg_color=noise["bg"].expand(N, ss.out_dim_color),
            density_scale=ss.density_scale, compact_frac=ss.compact_frac))
        images.append(out["image"])

    def loss_backward():
        delta = (losses.log_intensity(images[1], ss.use_luma, ss.linlog)
                 - losses.log_intensity(images[0], ss.use_luma, ss.linlog))
        losses.event_loss(delta[None], batch["pols"][None, :, None], ss.C_thres).backward()

    timed("loss + backward", loss_backward)
    timed("adam + ema", state.apply_updates)
    timed("occupancy update (1 in 16 steps)", lambda: update_occupancy(
        state.params, fs, trainer.occupancy, trainer.generator,
        density_scale=trainer.cfg.density_scale, density_thresh=trainer.cfg.density_thresh))
    print("[breakdown] one step, ms (host clock, synchronized): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; march host syncs {march_rays.host_syncs - syncs0} (2 marches)")


def phase_inference(trainer, val):
    import numpy as np
    import torch
    from enerf_torch.ops import fused_mlp
    from enerf_torch.render.march import march_rays

    v = val.val_views()[0]
    fused_mlp.fused_field_head.launches = 0
    march_rays.host_syncs = 0
    torch.cuda.synchronize()
    t0 = time.time()
    img, depth = trainer.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
    wall = time.time() - t0
    launches = fused_mlp.fused_field_head.launches
    ok = (np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0 + 1e-6
          and np.isfinite(depth).all())
    print(f"[infer] view {v['H']}x{v['W']}: {wall:.2f} s, image mean {img.mean():.4f} "
          f"in [{img.min():.4f}, {img.max():.4f}], K1 launches {launches}, "
          f"march host syncs {march_rays.host_syncs} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("inference image not finite or outside [0, 1]")
    if launches == 0:
        raise AssertionError("inference did not go through K1")


def phase_k2_path():
    """bench.py's march step (bench.py:295-360) at its reference shape,
    built from the port's modules: 16 x 2 levels, blk4, separate marches,
    8192 rays x 32 samples, compact_frac 0.25, bf16, 1 colour channel, the
    ball bitfield, o = (0, 0, -2.5) and o + 0.01, pols 1, bg 0.5, C 0.2.
    The same steps run from the same state with the same noise, with
    fast_table_grad on (K2) and off (index_add_)."""
    import gc

    import numpy as np
    import torch
    from enerf_torch.models.field import FieldStatic, init_field_params
    from enerf_torch.ops import scatter_accum as sa
    from enerf_torch.render.march import march_rays, render_rays_march
    from enerf_torch.render.occupancy import ball_bitfield
    from enerf_torch.train import losses
    from enerf_torch.train.state import TrainState

    n_rays, steps, dev = 8192, 4, "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    d = torch.randn(n_rays, 3, device=dev, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.tensor([[0.0, 0.0, -2.5]], device=dev).expand(n_rays, 3)
    pols = torch.ones(n_rays, device=dev)
    bg = torch.full((n_rays, 1), 0.5, device=dev)
    bitfield = ball_bitfield(device=dev)
    noise = [(torch.rand(n_rays, device=dev, generator=gen),
              torch.rand(n_rays, device=dev, generator=gen)) for _ in range(steps)]
    runs, pair_log = {True: [], False: []}, []  # pair_log: K2's inputs of step 1
    for fast in (True, False, False, True):  # in turns: one call, one card
        first = not runs[fast]
        static = FieldStatic(bound=1.0, out_dim_color=1, encoding="blockgrid",
                             compute_dtype=torch.bfloat16, grid_block=4, num_levels=16,
                             level_dim=2, fast_table_grad=fast)
        state = TrainState(init_field_params(static, 0, dev), 1e-2, 10000)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sa.block_table_grad.launches = 0
        march_rays.host_syncs = 0
        step_losses, backward_s = [], 0.0
        for i, (j1, j2) in enumerate(noise):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.time()
            state.zero_grad()
            outs = [render_rays_march(state.params, static, bitfield, oo, d, num_samples=32,
                                      max_steps=1024, bg_color=bg, perturb=True, jitter=j,
                                      compact_frac=0.25)
                    for oo, j in ((o, j1), (o + 0.01, j2))]
            ll = [losses.log_intensity(out["image"], False) for out in outs]
            loss = losses.event_loss((ll[1] - ll[0])[None], pols[None, :, None], 0.2)
            if fast and first and i == 0:
                hook_k2_inputs(loss, pair_log)
            torch.cuda.synchronize()
            tb = time.time()
            loss.backward()
            torch.cuda.synchronize()
            if i:
                backward_s += time.time() - tb
            if i == 0 and first:
                grad1 = state.params["hash_table"].grad.clone()
            state.apply_updates()
            step_losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        wall = time.time() - t0
        run = dict(launches=sa.block_table_grad.launches, steps_s=(steps - 1) / wall,
                   backward_ms=backward_s / (steps - 1) * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, base_gib=base / 2**30)
        if first:
            run["grad1"] = grad1
        runs[fast].append(run)
        print(f"[k2path] table backward {'K2' if fast else 'index_add_'}: losses {step_losses}; "
              f"{run['steps_s']:.3f} steps/s over steps 2-{steps}, backward "
              f"{run['backward_ms']:.1f} ms per step (synchronized); peak memory "
              f"{run['peak_gib']:.2f} GiB ({run['base_gib']:.2f} GiB held before); "
              f"K2 launches {run['launches']}; march host syncs "
              f"{march_rays.host_syncs / steps:.1f} per step")
        if not np.isfinite(step_losses).all():
            raise AssertionError(f"K2 path losses not finite: {step_losses}")
        del state
    meta = static.grid_meta
    # the gradients here are ~1e-9, so the floor scales with the data: 1e-7
    # of the largest A, where the kernel phase's g ~ N(0, 1) takes 1e-7
    mag = k2_magnitude(pair_log, meta.total_rows, meta)
    g_fast, g_plain = runs[True][0]["grad1"].double(), runs[False][0]["grad1"].double()
    diff = (g_fast - g_plain).abs()
    floor = 1e-7 * float(mag.max())
    agree, ratio = k2_agrees(diff, mag, floor)
    launches = [r["launches"] for r in runs[True]] + [r["launches"] for r in runs[False]]
    ok = agree and floor > 0 and len(pair_log) == 2 and launches == [2 * steps, 2 * steps, 0, 0]
    print(f"[k2path] step-1 hash_table gradient, K2 vs index_add_: largest |g| "
          f"{float(g_plain.abs().max()):.3e}, largest sum|g W| {float(mag.max()):.3e}, "
          f"max |diff| {float(diff.max()):.3e}, max |diff| / (1e-5 * sum|g W| + "
          f"{floor:.3e}) {ratio:.3e}, exactly 0 where sum|g W| is 0, over "
          f"{sum(p[0].shape[0] for p in pair_log)} pairs of {len(pair_log)} renders -> "
          f"{'ok' if ok else 'FAIL'}")
    for fast in (True, False):
        rs = runs[fast]
        print(f"[k2path] {'K2' if fast else 'index_add_'}, mean of 2 runs: "
              f"{sum(r['steps_s'] for r in rs) / 2:.3f} steps/s, backward "
              f"{sum(r['backward_ms'] for r in rs) / 2:.1f} ms per step, peak memory "
              f"{max(r['peak_gib'] for r in rs):.2f} GiB")
    if not ok:
        raise AssertionError("the K2 path disagrees with the index_add_ path")
    return runs[True][0]["launches"]


def phase_no_event(workspace):
    """8 main-path steps with the no-event pair and the device slerp."""
    import numpy as np
    from enerf_torch.data.provider import make_providers
    from enerf_torch.train.trainer import Trainer

    cfg = smoke_config(workspace, "--negative_event_sampling", "1",
                       "--precompute_evs_poses", "0", "--log_every", "1")
    trainer = Trainer(cfg, device="cuda", workspace=workspace)
    train, _ = make_providers(cfg, device=trainer.device)
    train.steps_per_epoch = 8
    t0 = time.time()
    trainer.train(train, max_epoch=1)
    lne = [aux.get("loss_no_evs", float("nan")) for _, aux in trainer.history]
    print(f"[noev] 8 steps in {time.time() - t0:.2f} s (a checkpoint included): "
          f"loss_no_evs per step {[f'{x:.3e}' for x in lne]}, loss per step "
          f"{[round(aux['loss'], 6) for _, aux in trainer.history]}; "
          f"{train.noev_coords.shape[0]} time chunks, {cfg.batch_size_evs // 2} no-event "
          f"pairs per step (the hinge starts at |delta log I| = C = {cfg.C_thres})")
    # an untrained field changes little between nearby poses, but some step
    # must cross C: a hinge that is always 0 would pass a finite-only check
    if not (len(lne) == 8 and np.isfinite(lne).all() and max(lne) > 0):
        raise AssertionError(f"loss_no_evs not finite, not logged or never > 0: {lne}")


def default_config(workspace):
    from enerf_torch.config import build_config
    return build_config([
        "--config", os.path.join(REPO, "configs", "synthetic_demo.txt"), "--event_only", "0",
        "--iters", "48", "--log_every", "8", "--seed", "0", "--val_idxs", "0",
        "--val_idxs", "20", "--eval_interval", "1", "--outdir", workspace])


def phase_default_path(workspace):
    """configs/synthetic_demo.txt --event_only 0: the hash grid, the unfused
    MLPs, the fixed-step renderer and the frame term, one epoch of 48 steps
    with a checkpoint and the evaluation of 2 val views."""
    import numpy as np
    import torch
    from enerf_torch.data.provider import make_providers
    from enerf_torch.ops import fused_mlp, group_gather, scatter_accum
    from enerf_torch.train.trainer import Trainer

    cfg = default_config(workspace)
    trainer = Trainer(cfg, workspace=workspace)
    meta = trainer.static.grid_meta
    print(f"[default] field: {trainer.static.encoding} {meta.num_levels}x{meta.level_dim}, "
          f"2^{meta.log2_hashmap_size} budget, {meta.total_entries} entries "
          f"({meta.total_entries * meta.level_dim * 4 / 1e6:.1f} MB table, "
          f"{int(meta.is_hashed.sum())} hashed levels), compute {trainer.static.compute_dtype}, "
          f"{cfg.num_steps} fixed steps, occupancy {trainer.occupancy}; "
          f"{cfg.batch_size_evs} event pairs + {cfg.num_rays} frame rays per step")
    t0 = time.time()
    train, val = make_providers(cfg)
    print(f"[default] synthetic data {cfg.H}x{cfg.W} with {train.frames.shape[0]} frames: "
          f"{time.time() - t0:.1f} s")
    steps = 48
    train.steps_per_epoch = steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = (fused_mlp.fused_field_head, scatter_accum.block_table_grad,
              group_gather.group_gather)
    for c in counts:
        c.launches = 0
    t0 = time.time()
    trainer.train(train, val, max_epoch=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = [c.launches for c in counts]
    secs = trainer.epoch_seconds
    hist = trainer.history
    lf = [aux["loss_frames"] for _, aux in hist]
    print("[default] losses at logged steps: " + ", ".join(
        f"{s}: loss {aux['loss']:.5f} evs {aux['loss_evs']:.5f} frames {aux['loss_frames']:.5f}"
        for s, aux in hist))
    print(f"[default] train(train, val, 1): {wall:.2f} s = {steps / wall:.3f} steps/s with the "
          f"epoch tail; the {steps} steps {secs['steps']:.2f} s = "
          f"{steps / secs['steps']:.3f} steps/s; tail "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items() if k != "steps")
          + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
          f"launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]} (none on this path: "
          "the JAX package runs it without Pallas)")
    res = trainer.last_eval
    # with the frame term JAX's evaluation applies no affine correction
    # (trainer.py:687); the smoke applies the event-only correction to the
    # same renders, through the trainer's own function
    views = val.val_views()
    preds = [trainer.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])[0] for v in views]
    corr = trainer.affine_corrected(preds, [v["gt"] for v in views])
    print("[default] eval (trainer): " + ", ".join(f"{k} {res.get(k)}" for k in ("psnr", "ssim"))
          + "; affine-corrected (the same renders): "
          + ", ".join(f"{k} {corr[k]}" for k in ("affine_a", "affine_b", "psnr_corrected",
                                                 "ssim_corrected")))
    if not (len(hist) == steps // cfg.log_every and np.isfinite(lf).all() and max(lf) > 0
            and np.isfinite([aux["loss"] for _, aux in hist]).all()):
        raise AssertionError(f"default path losses not finite or loss_frames never > 0: {hist}")
    if not all(np.isfinite(x) for x in (res.get("psnr", np.nan), res.get("ssim", np.nan),
                                        corr["psnr_corrected"], corr["ssim_corrected"])):
        raise AssertionError(f"evaluation gave no finite metrics: {res}, {corr}")
    return trainer, train


def phase_default_breakdown(trainer, train):
    """Host-clock split of one more default-path step, each part ending in
    a synchronize."""
    import torch
    from enerf_torch.train import losses
    from enerf_torch.train.step import _render, draw_noise

    ss, state = trainer.ss, trainer.state
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = parts.get(name, 0.0) + (time.time() - t0) * 1e3
        return out

    batch = timed("batch", lambda: train.train_step_batch(trainer.generator))
    N, Nf = batch["pols"].shape[0], batch["rays_o"].shape[0]
    noise = draw_noise(ss, N, trainer.generator, trainer.device, n_frames=Nf)
    state.zero_grad()
    bg = noise["bg"].expand(N, ss.out_dim_color)
    outs = [timed("two event renders", lambda i=i: _render(
        state.params, ss, batch[f"rays_evs_o{i}"], batch[f"rays_evs_d{i}"], bg,
        noise[f"jitter{i}"], None)) for i in (1, 2)]
    frame = timed("frame render", lambda: _render(
        state.params, ss, batch["rays_o"], batch["rays_d"], noise["bg_frames"],
        noise["jitter_frames"], None))

    def loss_backward():
        delta = (losses.log_intensity(outs[1]["image"], ss.use_luma, ss.linlog)
                 - losses.log_intensity(outs[0]["image"], ss.use_luma, ss.linlog))
        loss = losses.event_loss(delta[None], batch["pols"][None, :, None], ss.C_thres,
                                 event_only=False)
        loss = loss + ss.weight_loss_rgb * ((frame["image"] - batch["images"]) ** 2).mean()
        loss.backward()

    timed("loss + backward", loss_backward)
    timed("adam + ema", state.apply_updates)
    samples = (2 * N + Nf) * ss.num_steps
    print("[breakdown] default path, one step, ms (host clock, synchronized): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; {samples} samples ({2 * N} event + {Nf} frame rays x {ss.num_steps} steps)")


def phase_march_warmup(workspace):
    """--ff -O --event_only 0 --march_warmup 4: the untrained cells marked
    from the frame poses, steps 0-3 on the fixed-step renderer with remat
    (no K1), steps 4-7 on the march (K1 once per render, 3 renders)."""
    import numpy as np
    import torch
    from enerf_torch.data.provider import make_providers
    from enerf_torch.ops import fused_mlp
    from enerf_torch.render.march import march_rays
    from enerf_torch.render.occupancy import init_occupancy, mark_untrained_grid
    from enerf_torch.train.trainer import Trainer

    cfg = smoke_config(workspace, "--event_only", "0", "--march_warmup", "4",
                       "--log_every", "1")
    trainer = Trainer(cfg, workspace=workspace)
    train, _ = make_providers(cfg)
    train.steps_per_epoch = 8
    # the 40 frame cameras of the orbit see every cell of the grid; the first
    # camera alone leaves some unseen, so the trainer marks from it only
    train.train_poses = train.train_poses[:1]
    fused_mlp.fused_field_head.launches = 0
    march_rays.host_syncs = 0
    t0 = time.time()
    trainer.train(train, max_epoch=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fused_mlp.fused_field_head.launches
    # a cell marked -1 stays -1 through the occupancy updates of the march
    untrained = float((trainer.occupancy.density_grid == -1.0).float().mean())
    one = mark_untrained_grid(init_occupancy(cfg.bound, "cuda"), train.train_poses,
                              train.intrinsics, cfg.bound)
    one_cam = float((one.density_grid == -1.0).float().mean())
    lf = [aux.get("loss_frames", float("nan")) for _, aux in trainer.history]
    print(f"[warmup] 8 steps in {wall:.2f} s (a checkpoint included): cells marked untrained "
          f"{untrained} of the grid from {len(train.train_poses)} frame camera "
          f"({one_cam} by a direct call on the same pose); "
          f"loss_frames per step {[f'{x:.4e}' for x in lf]}; "
          f"K1 launches {launches} (3 renders x 4 march steps = 12); march host syncs "
          f"{march_rays.host_syncs}")
    if not (len(lf) == 8 and np.isfinite(lf).all()):
        raise AssertionError(f"loss_frames not finite at every step: {lf}")
    if launches != 12 or march_rays.host_syncs == 0:
        raise AssertionError(f"expected 4 warm steps without K1 and 4 march steps with it: "
                             f"K1 launches {launches}, host syncs {march_rays.host_syncs}")
    if not (0.0 < untrained == one_cam < 1.0):
        raise AssertionError(f"the trainer marked {untrained} of the cells untrained, "
                             f"a direct mark_untrained_grid call {one_cam}")


def main():
    try:
        import torch
    except ImportError:
        print("[device] FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is false")
        return 1
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")
    sys.path.insert(0, REPO)
    try:
        import enerf_torch  # noqa: F401
    except ImportError:
        print(f"[device] FAIL: enerf_torch is not importable from {REPO}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    try:
        phase_build()
        res = phase_kernels()
        k2 = phase_k2_kernel()
        k3 = phase_k3_kernel()
        k3_launches = phase_gather_bench()
        workspace = os.path.join(REPO, "build", "chip_smoke")
        trainer, train, val, launches = phase_main_path(workspace)
        phase_resume(trainer, workspace)
        phase_inference(trainer, val)
        phase_breakdown(trainer, train)
        del trainer, train, val
        k2_launches = phase_k2_path()
        phase_no_event(os.path.join(REPO, "build", "chip_smoke_noev"))
        workspace = os.path.join(REPO, "build", "chip_smoke_default")
        trainer, train = phase_default_path(workspace)
        phase_resume(trainer, workspace)
        phase_default_breakdown(trainer, train)
        del trainer, train
        phase_march_warmup(os.path.join(REPO, "build", "chip_smoke_warmup"))
    except Exception:  # every phase's failure ends the run non-zero
        traceback.print_exc()
        print("[smoke] FAIL")
        return 1
    bf = res["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "fused_field_head", "route": "cuda",
        "source": "enerf_torch/csrc/fused_field_head.cu",
        "replaces": "enerf_tpu/ops/fused_mlp.py:54",
        "launches": launches, "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
        "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
        "bound_by": bf["bound_by"], "library_ms": None,
        "share_of_bound": bf["share_of_bound"], "kernel_ms": bf["kernel_ms"],
        "pack_ms": bf["pack_ms"], "host_ms": bf["host_ms"], "differ_share": bf["differ_share"],
        "float32": res["float32"],
    }, dict({
        "name": "block_table_grad", "route": "cuda",
        "source": "enerf_torch/csrc/block_table_grad.cu",
        "replaces": "enerf_tpu/ops/scatter_accum.py:46",
        "launches": k2_launches}, **k2[4], block3=k2[3]),
        dict({
            "name": "group_gather", "route": "cuda",
            "source": "enerf_torch/csrc/group_gather.cu",
            "replaces": "scripts/bench_gather.py:62",
            "launches": k3_launches}, **k3[128], block_grid_table=k3[250]),
    ]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
