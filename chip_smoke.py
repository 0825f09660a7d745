#!/usr/bin/env python3
"""Chip smoke test of enerf_torch, the PyTorch + CUDA port, on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the result lines):
  1. device: the card's name and power limit (nvidia-smi), CUDA required;
  2. build: every csrc/*.cu kernel, one nvcc each, started together, with
     the -Xptxas -v register / shared-memory / spill lines;
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes, with the stated tolerances; kernel, plain and bound times;
  4. main path: the --ff -O event trainer at full field width (16 x 2
     levels, blk4, 2^19 hash budget, hidden 64, geo 15, SH 4) on the
     synthetic event scene, 48 steps (occupancy updates at steps 0, 16, 32);
  5. inference: one validation view through the alive-ray inference renderer;
  6. breakdown: one more step, split into its parts on the host clock.
Then a `{"kernels": [...]}` line, the card line, and last the result line
`{"ok": true, "device": {...}}`.
"""

import glob
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
    """Mean device time of one call, from CUDA events around `iters` calls."""
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
               if "registers" in ln or "spill" in ln or "smem" in ln]
        for ln in ptx:
            print(f"[build] {name}: {ln}")
    print(f"[build] ok: {names} in {time.time() - t0:.1f} s")
    return names


def head_inputs(B, dtype, gen):
    """K1's operands at the main path's widths: enc [B, 32] (16 levels x 2),
    SH-4 direction encodings [B, 16], and weights drawn like
    init_field_params (U(+-1/sqrt(fan_in)), [in, out] layout)."""
    import torch
    from enerf_torch.ops.sh import sh_encode

    dev = "cuda"
    enc = (torch.rand(B, 32, device=dev, generator=gen) * 2 - 1) * 0.5
    d = torch.randn(B, 3, device=dev, generator=gen)
    denc = sh_encode(d / d.norm(dim=-1, keepdim=True), 4)

    def w(i, o):
        b = 1.0 / math.sqrt(i)
        return (torch.rand(i, o, device=dev, generator=gen) * 2 - 1) * b

    ws = [w(32, 64), w(64, 16), w(31, 64), w(64, 64), w(64, 1)]
    return [a.to(dtype) for a in [enc, denc] + ws]


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


def phase_kernels():
    import torch
    from enerf_torch.ops import fused_mlp

    B = 4096 * 32  # rays x compacted samples per render on the main path
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        args = head_inputs(B, dt, gen)
        with torch.no_grad():
            s_k, c_k = fused_mlp.launch_kernel(*args)
            s_p, c_p = fused_mlp.head_reference(*args)
        torch.cuda.synchronize()
        for a in (s_k, c_k):
            if not torch.isfinite(a).all():
                raise AssertionError(f"K1 {name}: non-finite output")
        sig_rel = float(((s_k - s_p).abs() / s_p.abs().clamp(min=1e-30)).max())
        rgb_abs = float((c_k - c_p).abs().max())
        rgb_rel = float(((c_k - c_p).abs() / c_p.abs().clamp(min=1e-30)).max())
        max_abs = max(float((s_k - s_p).abs().max()), rgb_abs)
        tol = TOL[name]
        ok = sig_rel <= tol["sigma_rel"] and (
            rgb_rel <= tol["rgb_rel"] if "rgb_rel" in tol else rgb_abs <= tol["rgb_abs"])
        with torch.no_grad():
            ms = time_ms(lambda: fused_mlp.launch_kernel(*args))
            plain_ms = time_ms(lambda: fused_mlp.head_reference(*args))
        bound_ms, bound_by, nbytes, flops = bound_of(B, name)
        print(f"[kernel] fused_field_head {name} B={B}: sigma rel err {sig_rel:.3e}, "
              f"rgb abs err {rgb_abs:.3e} rel {rgb_rel:.3e} (tol {tol}) -> "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP)")
        if not ok:
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    return results


def smoke_config(workspace):
    from enerf_torch.config import build_config
    return build_config([
        "--mode", "synthetic", "--H", "64", "--W", "64",
        "--events", "1", "--event_only", "1", "--out_dim_color", "1",
        "--C_thres", "0.2", "--bound", "1", "--lr", "0.005",
        "--ff", "-O", "--num_levels", "16", "--level_dim", "2", "--grid_block", "4",
        "--hidden_dim", "64", "--hidden_dim_color", "64", "--geo_feat_dim", "15",
        "--batch_size_evs", "4096", "--march_samples", "64", "--compact_frac", "0.5",
        "--iters", "48", "--log_every", "8", "--seed", "0",
        "--outdir", workspace])


def phase_main_path(workspace):
    import numpy as np
    import torch
    from enerf_torch.data.provider import make_providers
    from enerf_torch.ops import fused_mlp
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
    print(f"[main] synthetic data {cfg.H}x{cfg.W}: {time.time() - t0:.1f} s")
    steps = 48
    train.steps_per_epoch = steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.fused_field_head.launches = 0
    march_rays.host_syncs = 0
    t0 = time.time()
    trainer.train(train, max_epoch=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fused_mlp.fused_field_head.launches
    syncs = march_rays.host_syncs
    losses = [loss for _, loss in trainer.history]
    print(f"[main] losses at logged steps: "
          + ", ".join(f"{s}:{l:.5f}" for s, l in trainer.history))
    print(f"[main] {steps} steps in {wall:.2f} s = {steps / wall:.3f} steps/s "
          f"(3 occupancy updates included); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 launches {launches}; "
          f"march host syncs {syncs} ({syncs / steps:.1f} per step)")
    if not (len(losses) == steps // cfg.log_every and np.isfinite(losses).all()):
        raise AssertionError(f"main path losses not all finite: {losses}")
    if trainer.occupancy.iter_density != 3:
        raise AssertionError(f"iter_density {trainer.occupancy.iter_density} != 3")
    if launches < 2 * steps:
        raise AssertionError(f"K1 launched {launches} times in {steps} steps")
    return trainer, train, val, launches


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
        workspace = os.path.join(REPO, "build", "chip_smoke")
        trainer, train, val, launches = phase_main_path(workspace)
        phase_inference(trainer, val)
        phase_breakdown(trainer, train)
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
        "float32": res["float32"],
    }]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
