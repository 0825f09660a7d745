"""The port's training-step benchmark (counterpart of the repo's bench.py:295-383).

    python -m enerf_torch.tools.bench [--mode march|fixed] [--n_rays 8192]
        [--num_samples 32] [--grid_block 3] [--num_levels 8] [--level_dim 4]
        [--compact_frac 0.25] [--share_march 1] [--fast_table_grad 0]
        [--fixed_steps 128 512] [--fixed_rays ...] [--iters 10] [--device cuda|cpu]

--mode march (the default) times bench.py's occupancy-march event step: a
block-grid field (bf16 compute, one colour channel, the fused head K1),
n_rays rays from (0, 0, -2.5) in seeded random directions and their twins
from (0.01, 0.01, -2.49), marched through the ball bitfield (a trained
scene's ~6% of cascade 0) with num_samples live samples, `max_steps` 1024,
jittered starts; with share_march one march (kernel M1) serves both
renders, else each render marches; compact_frac of each ray's samples go
through the field; the C = 0.2 event loss on polarity 1 against a 0.5
background, the backward (K2 with --fast_table_grad 1, else index_add_),
Adam + EMA.  --mode fixed times the uniform fixed-step event step on the
16 x 2, block 4 field, one line per --fixed_steps value (rays from
--fixed_rays, default n_rays).

Each line is bench.py's JSON: the metric (`rays_per_s_per_chip_fwd_bwd_1024steps`,
or `..._fixed{S}steps`), its value (two renders' rays per second of a
step, over --iters steps after one warm-up step, host clock between
device synchronisations) and unit, plus the device, the mean step time
and, on the march, M1's launches and the march's host syncs a step.  On
the CPU it runs the plain versions: the control flow, not a rate of the
card.  bench.py's `vs_baseline` (a TPU calibration) has no counterpart.
"""

import argparse
import json
import time

import torch

from enerf_torch.backend import resolve_device


def _field(device, grid_block, num_levels, level_dim, fast_table_grad):
    from enerf_torch.models.field import FieldStatic, init_field_params
    from enerf_torch.train.state import TrainState
    static = FieldStatic(bound=1.0, out_dim_color=1, encoding="blockgrid",
                         compute_dtype=torch.bfloat16, grid_block=grid_block,
                         num_levels=num_levels, level_dim=level_dim,
                         fast_table_grad=bool(fast_table_grad))
    return static, TrainState(init_field_params(static, 0, device), 1e-2, 10000)


def _rays(n_rays, device):
    gen = torch.Generator(device=device).manual_seed(1)
    d = torch.randn(n_rays, 3, device=device, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.tensor([[0.0, 0.0, -2.5]], device=device).expand(n_rays, 3)
    return o, d, gen


def _timed(step, iters, device):
    """Seconds per step over `iters` steps after one warm-up step."""
    step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / iters


def _device_name(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def bench_march(args, device):
    """bench.py's march step; returns its JSON line as a dict."""
    from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
    from enerf_torch.render.march import composite_from_march, march_rays, render_rays_march
    from enerf_torch.render.occupancy import ball_bitfield, pack_bitfield
    from enerf_torch.train import losses

    static, state = _field(device, args.grid_block, args.num_levels, args.level_dim,
                           args.fast_table_grad)
    n, S, cf = args.n_rays, args.num_samples, args.compact_frac
    o, d, gen = _rays(n, device)
    bits = pack_bitfield(ball_bitfield(device=device))  # packed once, as the trainer does
    pols = torch.ones(n, device=device)
    bg = torch.full((n, 1), 0.5, device=device)
    nears, fars = near_far_from_aabb(o, d, aabb_tensor(1.0, device), 0.2)

    def step():
        j1 = torch.rand(n, device=device, generator=gen)
        j2 = torch.rand(n, device=device, generator=gen)
        state.zero_grad()
        if args.share_march:
            ts, dts, valid = march_rays(o, d, bits, nears, fars, jitter=j1, num_samples=S,
                                        max_steps=1024, cascades=1, bound=1.0, perturb=True)
            outs = [composite_from_march(state.params, static, oo, d, ts, dts, valid, nears,
                                         fars, bg_color=bg, compact_frac=cf)
                    for oo in (o, o + 0.01)]
        else:
            outs = [render_rays_march(state.params, static, bits, oo, d, num_samples=S,
                                      max_steps=1024, bg_color=bg, perturb=True, jitter=j,
                                      compact_frac=cf)
                    for oo, j in ((o, j1), (o + 0.01, j2))]
        ll = [losses.log_intensity(out["image"], False) for out in outs]
        losses.event_loss((ll[1] - ll[0])[None], pols[None, :, None], 0.2).backward()
        state.apply_updates()

    launches, syncs = march_rays.launches, march_rays.host_syncs
    sec = _timed(step, args.iters, device)
    steps = args.iters + 1
    return {"metric": "rays_per_s_per_chip_fwd_bwd_1024steps", "value": 2 * n / sec,
            "unit": "rays/s", "device": _device_name(device), "step_ms": sec * 1e3,
            "march_launches_per_step": (march_rays.launches - launches) / steps,
            "march_host_syncs_per_step": (march_rays.host_syncs - syncs) / steps}


def bench_fixed(args, device):
    """bench.py's fixed-step event step (16 x 2, block 4): one line per
    --fixed_steps value."""
    from enerf_torch.render.renderer import render_rays
    from enerf_torch.train import losses

    static, state = _field(device, 4, 16, 2, 0)
    counts = args.fixed_rays or [args.n_rays] * len(args.fixed_steps)
    if len(counts) != len(args.fixed_steps):
        raise ValueError("--fixed_rays needs one ray count per --fixed_steps value")
    lines = []
    for ns, n in zip(args.fixed_steps, counts):
        o, d, gen = _rays(n, device)
        pols = torch.ones(n, device=device)
        bg = torch.full((n, 1), 0.5, device=device)

        def step(ns=ns, n=n, o=o, d=d, gen=gen, pols=pols, bg=bg):
            state.zero_grad()
            outs = [render_rays(state.params, static, oo, d, num_steps=ns, bg_color=bg,
                                perturb=True, train=True,
                                jitter=torch.rand(n, ns, device=device, generator=gen))
                    for oo in (o, o + 0.01)]
            ll = [losses.log_intensity(out["image"], False) for out in outs]
            losses.event_loss((ll[1] - ll[0])[None], pols[None, :, None], 0.2).backward()
            state.apply_updates()

        sec = _timed(step, args.iters, device)
        lines.append({"metric": f"rays_per_s_per_chip_fwd_bwd_fixed{ns}steps",
                      "value": 2 * n / sec, "unit": "rays/s", "device": _device_name(device),
                      "step_ms": sec * 1e3})
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["march", "fixed"], default="march")
    ap.add_argument("--fixed_steps", type=int, nargs="*", default=[128, 512])
    ap.add_argument("--fixed_rays", type=int, nargs="*", default=None)
    ap.add_argument("--n_rays", type=int, default=8192)
    ap.add_argument("--num_samples", type=int, default=32)
    ap.add_argument("--compact_frac", type=float, default=0.25)
    ap.add_argument("--share_march", type=int, default=1)
    ap.add_argument("--grid_block", type=int, default=3)
    ap.add_argument("--fast_table_grad", type=int, default=0)
    ap.add_argument("--num_levels", type=int, default=8)
    ap.add_argument("--level_dim", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = bench_march(args, device) if args.mode == "march" else bench_fixed(args, device)
    for line in lines if isinstance(lines, list) else [lines]:
        print(json.dumps(line))
    return lines


if __name__ == "__main__":
    main()
