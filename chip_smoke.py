#!/usr/bin/env python3
"""Chip smoke test of enerf_torch, the PyTorch + CUDA port, on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the result lines):
  1. device: the card's name and power limit (nvidia-smi), CUDA required;
  2. build: every csrc/*.cu kernel (K1-K3, M1), one nvcc each, started together, with
     the -Xptxas -v register / shared-memory / spill lines, and the count of
     tensor-core instructions in K1's SASS, of bulk copies in K3's and of
     shared-memory atomics in K2's accumulation (cuobjdump; a kernel
     without its own fails);
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes, with the stated tolerances; kernel, plain, library and
     bound times and the share of the bound (K1 fused_field_head, timed
     over 6 input sets that together exceed L2; K2 block_table_grad at
     block 4 and 3, its pre-pass's plan against the plain plan, the
     pre-pass's time alone and the time of the same pairs sample by sample;
     K3 group_gather, bit-exact, at the gather benchmark's default shape and
     at the block-grid table's); K1 in bf16 also at the grid-free encoders'
     widths, enc 3 wide (the identity, KE = 1) and 39 wide (the frequency
     encoding, KE = 4), padded by the wrapper to 16 KE columns;
  3b. gather benchmark: enerf_torch.tools.bench_gather at its defaults and
     with --rows 97824 --d 250, every variant's rows/s and GB/s (the path
     that runs K3);
  4. main path: the --ff -O event trainer at full field width (16 x 2
     levels, blk4, 2^19 hash budget, hidden 64, geo 15, SH 4) on the
     synthetic event scene, its chains built on the card by E1 and held
     bit for bit, field by field, to the plain build of the same events
     before the steps (E1 launched for the sort and the group tables),
     one epoch of 48 steps as three 16-step
     windows (fuse_steps 16, train/chunk.py: the occupancy update at each
     window's start, one step captured in a CUDA graph and replayed)
     through train(train, val, 1): a checkpoint and the affine-corrected
     evaluation of 2 val views with LPIPS (alex, vgg) on the card, after
     the run diagnostics; one log line a window, state.step 48,
     iter_density 3, M1 launched once a step (both renders of the event
     pair in one march) and no march host sync in the steps; then a new
     Trainer resumed from the 'latest' checkpoint must hold the same
     params, EMA and step;
  5. inference: one validation view through the alive-ray inference
     renderer (M1 a window); the same view with the plain march in M1's
     place within 1e-5, and the view's first and last march windows held
     against `_march` ray by ray, as in 6b;
  6. breakdown: one more step, split into its parts on the host clock;
     then save_mesh(256, 10.0) (query, extraction, write, size) and the
     card's marching_tets on a 64^3 grid of the field equal to the CPU's;
  6b. M1 (the march kernel) against its plain version `_march`: valid
     identical and ts / dts / t_end bit-equal on >= 99.99% of rays (each
     differing ray printed with its first differing slot) at the main
     path's pair 8192 rays x 64 samples (both renders of a main-path batch
     through the trained grid, the step's one launch), one render's 4096 x
     64, and bench.py's 8192 x 32 (the ball bitfield), there also with
     dt_gamma 1/256; kernel, plain and bound times, lookups a ray (mean,
     max), ms per link of the longest chain, the occupied-superblock share
     of each cascade, M1's pre-pass against its plain version and its
     time; where a copy of an older march source with the nested-loop
     kernel's C interface sits at build/march_rays_580e741.cu (git show
     580e741:enerf_torch/csrc/march_rays.cu), that kernel in turns with M1
     at the pair (its two launches), one render and, in phase 5, the first
     and last infer windows;
  6c. window: one main-path window eagerly under
     torch.cuda.set_sync_debug_mode("error") (no host sync), then from one
     state and generator states the graphed window against the eager one
     (loss within 1e-4, params within 2e-2 of the update by norm), in
     turns; the kernel launches a replay adds to the counts (recorded in
     the capture) against the kernels torch.profiler sees in one replay,
     the span marks' against the spans their ring records in that replay;
  7. K2 path: bench.py's march step at its reference shape (16 x 2, blk4,
     separate marches, 8192 rays x 32 samples, compact_frac 0.25, bf16,
     the ball bitfield) with fast_table_grad on (K2) and off (index_add_),
     from the same state with the same noise; step 1's table gradients
     must agree within K2's tolerance, scaled to the gradients' size; then
     K2 alone on each render's step-1 pairs (clustered march samples),
     held to the same tolerance and timed like phase 3; those samples are
     saved to build/chip_smoke_k2path/step1.pt for
     enerf_torch/tools/bench_table_grad.py;
  8. no-event pair: 8 main-path steps with negative_event_sampling and
     precompute_evs_poses=0 (the device slerp); loss_no_evs must be logged
     and finite at every step, and > 0 at one step at least;
  9. default path: configs/synthetic_demo.txt --event_only 0 (the path of
     the published configs: hash grid 16 x 2, 2^19, unfused MLPs, 128
     fixed steps, the frame term), one epoch of 48 steps through
     train(train, val, 1) with a checkpoint and the evaluation of 2 val
     views (the affine correction applied to the same renders), a resumed
     Trainer bit-equal, and one more step split into parts; then the
     --gui viewer on that trainer (GUIRenderer.train_steps(16), 4
     progressive frames, the HTTP server on an ephemeral port: GET /frame
     a PNG of the frame's shape, GET /orbit a new pose; TurntableRecorder,
     3 frames; K1 launches), the command lines `python -m enerf_torch
     ... --test` on its checkpoint (test render and 256^3 mesh) and
     `python -m enerf_torch.tools.render --traj val --n_poses 2`, and one
     720 x 1280 LPIPS pair on the card against the CPU (relative 1e-3);
 10. frames on the march: --ff -O --event_only 0 --march_warmup 4, 8 steps:
     the trainer's mark_untrained_grid from the first frame camera (its
     share of marked cells > 0 and equal to a direct call's), 4 fixed-step
     steps with remat, 4 march steps through K1 (12 launches, one a
     render) and M1 (8: the event pair's one march and the frame render's),
     no march host sync; loss_frames finite at every step;
 11. esim fixture: a 480 x 640, 6-frame esim directory written by the
     port's save_esim_dataset under build/chip_smoke_esim/ (images/,
     images_corrupted/ with seeded noise, events/, poses_all.txt,
     poses_bounds.npy), its seconds; the PNGs read back by the port's
     reader bit-equal to the uint8 written, its decode rate on them and on
     a frame filtered with Paeth on every row;
 12. frames mode at the published width: configs/spiral1/spiral1_nerf.txt
     as published (hash grid 16 x 2, 480 x 640, 30,096 rays x 512 steps)
     on the fixture, with one val index and two 16-step epochs, one graphed
     window each (captured in the first, the graph kept and replayed in
     the second; one capture): steps/s of each epoch, peak memory, the
     checkpoint's and the evaluation's seconds (one 480 x 640 view), PSNR
     and LPIPS; finite losses and PSNR; one more graphed step split into
     its phases by the span registry's device marks; save_mesh(256, 10.0)
     (the per-step path's two epochs beside the windows' were dropped to
     keep the smoke in its time: they matched within 1.01x);
 13. events + frames from the esim loader at the published width:
     configs/shakeCarpet1/shakeCarpet1_enerfBoth.txt (images_corrupted,
     the scene's pose offset), 8 steps: steps/s and peak memory; a
     torch.OutOfMemoryError as published is printed as the config's result
     and the phase reruns with --remat_fixed 1;
 14. frames mode on the march: --ff -O --events 0 --error_map on the
     synthetic scene, 8 steps with an occupancy update and --profile 2:
     K1 launched by the frames step, finite losses, an error map that
     changed, a torch.profiler trace of steps 3-4 that names CUDA kernels;
 15. tumvie fixture: the simulator at the event camera's 720 x 1280, 6
     frames, written by the port's save_tumvie_dataset under
     build/chip_smoke_tumvie/ (PNGs, events_left.h5, rectify_map_left.h5,
     the calib JSONs, mocap_data.txt), its seconds; every H5 dataset read
     back by the port's HDF5 reader equal to the array written, the
     reader's MB/s on t, and one EventSlicer window equal to a numpy mask
     over the arrays written;
 15b. dataset preparation without OpenCV: the fixture's frames distorted
     with an equidistant (fisheye, TUM-VIE's) model and written as JPEG by
     the port's encoder into images/, its events' coordinates distorted the
     same way; `python -m enerf_torch.tools.undistort_images --model
     fisheye --img_glob 'images/*.jpg' --out_suffix left` prepares the
     directory (undistorted JPEG frames, rectify_map_left.h5, Knew), which
     is laid out as the TUM-VIE loader reads it; the tool's frames equal
     this process's remap and encode of the same frames, and their inner
     half the clean frames seen through Knew (PSNR > 30 dB); the decoder's
     and encoder's ms a frame (the fixture's rendered frame, colour 4:2:0
     q95 and gray, and textured frames: 720 x 1280 colour, 1024 x 1024 gray,
     the size of TUM-VIE's frame cameras), the map build's seconds, the
     remap's ms a frame and the tool's seconds;
 15c. event chains (kernel E1, csrc/event_chains.cu): E1 against its plain
     version (the lexsort route), bit-equal on the sort, the group tables
     and every field of build_event_chains, on the events phases 11, 15
     (after 15b's preparation: fractional coordinates through the rectify
     map) and 17 hand their providers, on 10^7 synthetic events at 1280 x
     720 in 19 windows (sorted times, a hot pixel of 10^4 events at equal
     times, fractional coordinates) and on 10^6 with shuffled times; the
     fixtures' events below pixel 0, if any; then 10^8 events made on the
     card: E1's own checks (a permutation, keys non-decreasing, indices
     ascending within a group, the group ids) and at 10^7 and 10^8 E1's
     ms, its digit plan and its split (pre-pass with its host read, the
     digits' histogram, each radix pass, the group pass, the group count's
     host read; no stage over the key space), torch.argsort(stable=True)'s
     ms, the bound in bytes, E1's group tables' ms beside the sort, and
     build_event_chains end to end on the card at both sizes (plain at
     10^7); the split on the 10^6 shuffled times (with the fix-up); E1's
     launches on the main path (phase 4's provider) and in phases 16 and
     17;
 16. configs/mocapDesk2/mocapDesk2_enerf.txt as published (tumvie, event
     only, 2 renders of 20,096 rays x 512 steps, the stereo event views)
     on the directory phase 15b prepared (its JPEG frames decoded by the
     port's decoder), train / val indices cut to its 6 frames: one batch
     under torch.cuda.set_sync_debug_mode("error") (the window is drawn
     on the card), two 16-step epochs (one graphed window each, as in
     12) and one evaluation (a 720 x 1280 frame view and its stereo
     event view): steps/s, peak
     memory (allocated and reserved), each view's seconds, LPIPS, the
     stereo PNG and _raw.npy, finite losses, the run diagnostics (the card
     has no matplotlib: the numeric images only), K1 / K2 / K3 launches on
     the path, the load split (H5 read, chains, pose precompute, the rest);
     a torch.OutOfMemoryError as published is printed as the
     config's result and the phase reruns with --remat_fixed 1;
 17. configs/eds11/eds11_enerf.txt as published (eds, event only, the
     no-event pairs: 2 x 30,096 + 2 x 15,048 rays x 512 steps) on an EDS
     directory written by the port's save_eds_dataset from phase 11's
     480 x 640 simulation with a t_offset of 5 s, 4 steps and one
     evaluation, with phase 16's prints and OOM rule;
 18. background net: the main path's --ff -O with --bg_radius 32 (the bg
     net's 4-level 2-D hash grid and 2 x 64 MLP), 8 steps: finite losses,
     bg_table's gradient non-zero, K1 launched; 4096 rays that miss the box
     render exactly the bg net's colour through the training composite and
     the inference renderer;
 19. grid-free encoders: --ff -O with --encoding frequency and with
     --encoding none, 4 steps each: K1 launched at KE = 4 and KE = 1 only
     (counted by KE at the wrapper's launch_packed), finite losses; then one
     step of each on the fixed-step renderer (the default path's config);
 20. the CLIP step at a published width: configs/spiral1/spiral1_nerf.txt
     as published on phase 11's fixture with --rand_pose 4 --clip_text
     "a photo of a carpet" --bg_radius 32, 10 steps, the 5th and 10th
     rendering a random pose's 173 x 173 rays x 512 steps: steps/s, peak
     memory, loss_clip, a CLIP step's seconds against a GT step's; then 4
     steps of --ff -O --events 0 --rand_pose 1 on the synthetic scene,
     which launch K1;
 21. position gradients: dL/dx of hash_encode and block_encode (16 x 2,
     2^19, block 4) at 1,048,576 points, the card against the CPU on the
     same inputs (relative 1e-5 of the largest |dx|), and the backward's
     time on the card with and without dx;
 22. data parallelism, one rank over NCCL on cuda:0 in this process: the
     main path's trainer (phase 4's config) with a mesh; update_occupancy_
     sharded equal bit for bit to the serial update on the same jitter; one
     data-parallel step of 4096 pairs against the plain step on the same
     batch and noise (deterministic index_add_ on both), max |dparam|
     <= 1e-6, loss within 1e-4 relative; K1's launches in the step, the
     gradient all_reduce's ms;
 23. two ranks over gloo, both on cuda:0 (make_mesh(devices=...); NCCL
     refuses two ranks on one card), started by parallel.mesh.spawn as
     --mesh_shape starts them: (a) phase 22's comparison at 2 x 2048 pairs
     against one process's step on the whole batch (loss rtol 1e-4, params
     atol 1e-5 wherever the gradient is clear of the two sums' rounding,
     the count of entries within it that moved apart), the ranks bit-equal,
     K1's launches and the all_reduce's ms per rank; (c) one validation
     view through make_sharded_render against render_rays_march of the
     whole view (atol 1e-5), K1's launches per rank; (b)
     configs/spiral1_sparse/spiral1_sparse_enerf.txt as published on phase
     11's fixture (event only, C_thres -1: the normalized loss's norm over
     the global batch; 2 x 15,048 pairs x 512 steps a rank), 4 steps:
     steps/s, each rank's peak memory, the all_reduce's ms per step, the
     epoch-end replication check; a torch.OutOfMemoryError as published
     is printed as the result and the phase reruns with --remat_fixed 1;
     (e) --events 0 --rand_pose 1 --clip_text on the default path's config
     (--fuse_steps 1): one data-parallel frame step, then the rand-pose
     CLIP step on both ranks (one pose from the shared generator, the
     gradients meaned), the ranks bit-equal, and one process's CLIP step
     from the same state and draws within 1e-6 by norm of every tensor
     (deterministic index_add_ on both sides).
Then a `{"kernels": [...]}` line, the card line, and last the result line
`{"ok": true, "device": {...}}`.
"""

import gc
import glob
import itertools
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import time
import traceback
import zlib
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
    """Tensor-core instructions (HMMA / HGMMA) in K1's SASS, bulk copies
    (UBLKCP) in K3's and shared-memory atomics (ATOMS, the form of
    red.shared) in K2's accumulation; K1's bf16 kernel must have
    tensor-core instructions, K3 (the TMA design) bulk copies and K2 (the
    shared-memory tile design) shared-memory atomics."""
    def count(funcs, key, ops):
        return {f: sum(any(ins.startswith(op) for op in ops) for ins in body)
                for f, body in funcs.items() if key in f}

    k1 = count(sass_functions("fused_field_head"), "head_", ("HMMA", "HGMMA"))
    k3 = count(sass_functions("group_gather"), "group_gather", ("UBLKCP",))
    k2_funcs = sass_functions("block_table_grad")
    k2 = count(k2_funcs, "accumulate", ("ATOMS",))
    k2_ops = sorted({ins.split()[0] for f, body in k2_funcs.items() if "accumulate" in f
                     for ins in body if ins.startswith(("ATOM", "RED"))})
    bf16 = sum(c for f, c in k1.items() if "bf16" in f)
    print(f"[build] SASS: fused_field_head tensor-core instructions (HMMA/HGMMA) per kernel "
          f"{k1}; group_gather bulk copies (UBLKCP) per kernel {k3} (design kept: TMA bulk "
          f"copies through a shared-memory ring with L2 evict_last / evict_first policies); "
          f"block_table_grad shared-memory atomics (ATOMS) in the accumulation {k2}, its "
          f"atomic opcodes {k2_ops}")
    if not bf16:
        raise AssertionError("K1's bf16 kernel has no tensor-core instruction in its SASS")
    if not sum(k3.values()):
        raise AssertionError("K3 has no bulk-copy instruction in its SASS")
    if not sum(k2.values()):
        raise AssertionError("K2's accumulation has no shared-memory atomic in its SASS")


def head_inputs(B, dtype, gen, sets=1, E=32):
    """K1's operands: `sets` pairs of enc [B, E] (the main path's 16 levels x
    2 = 32; the frequency encoding's 39, the identity's 3) and SH-4
    direction encodings [B, 16], then weights drawn like init_field_params
    (U(+-1/sqrt(fan_in)), [in, out] layout)."""
    import torch
    from enerf_torch.ops.sh import sh_encode

    dev = "cuda"
    xs = []
    for _ in range(sets):
        enc = (torch.rand(B, E, device=dev, generator=gen) * 2 - 1) * 0.5
        d = torch.randn(B, 3, device=dev, generator=gen)
        xs.append((enc.to(dtype), sh_encode(d / d.norm(dim=-1, keepdim=True), 4).to(dtype)))

    def w(i, o):
        b = 1.0 / math.sqrt(i)
        return (torch.rand(i, o, device=dev, generator=gen) * 2 - 1) * b

    ws = [w(E, 64), w(64, 16), w(31, 64), w(64, 64), w(64, 1)]
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
    for E in (3, 39):
        results[f"bfloat16_E{E}"] = head_width(B, E, gen)
    return results


def head_width(B, E, gen):
    """K1 in bf16 at the grid-free encoders' widths (E = 3, the identity:
    KE = 1; E = 39, the frequency encoding: KE = 4): the wrapper pads enc
    to 16 KE columns, 16-byte rows, before the launch.  Against the plain
    version at the same TOL.  The bound counts the function's own bytes
    and operations (the unpadded enc, E first-layer weight rows); the
    padded enc the kernel reads is printed beside it."""
    import torch
    from enerf_torch.ops import fused_mlp

    xs, ws = head_inputs(B, torch.bfloat16, gen, sets=6, E=E)
    ke = fused_mlp.k_steps(E)
    with torch.no_grad():
        s_k, c_k = fused_mlp.launch_kernel(*xs[0], *ws)
        s_p, c_p = fused_mlp.head_reference(*xs[0], *ws)
        torch.cuda.synchronize()
        sig_rel = float(((s_k - s_p).abs() / s_p.abs().clamp(min=1e-30)).max())
        rgb_abs = float((c_k - c_p).abs().max())
        max_abs = max(float((s_k - s_p).abs().max()), rgb_abs)
        tol = TOL["bfloat16"]
        ok = (torch.isfinite(s_k).all() and torch.isfinite(c_k).all()
              and sig_rel <= tol["sigma_rel"] and rgb_abs <= tol["rgb_abs"])
        ms = graph_ms(rotating(lambda e, d: fused_mlp.launch_kernel(e, d, *ws), xs))
        plain_ms = graph_ms(rotating(lambda e, d: fused_mlp.head_reference(e, d, *ws), xs))
    bound_ms, bound_by, nbytes, flops = bound_of(B, "bfloat16", E=E)
    padded_mb = bound_of(B, "bfloat16", E=16 * ke)[2] / 1e6
    print(f"[kernel] fused_field_head bfloat16 E={E} (KE={ke}, enc padded to {16 * ke} columns, "
          f"{32 * ke} bytes a row; {padded_mb:.2f} MB with the padding) B={B}: "
          f"sigma rel err {sig_rel:.3e}, rgb abs err "
          f"{rgb_abs:.3e} (tol {tol}) -> {'ok' if ok else 'FAIL'}; launch_kernel {ms:.4f} ms "
          f"(pack_head and the pad included); plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"by {bound_by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), share of bound "
          f"{bound_ms / ms:.1%}; device times from CUDA graphs, 6 rotating input sets")
    if not ok:
        raise AssertionError(f"K1 at E={E} disagrees with its plain version")
    return dict(E=E, KE=ke, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / ms)


def k2_bound(pairs, live, total_rows, row_cells):
    """Least time for K2's work: g (8 bytes) read of every (sample, level)
    pair, 28 bytes more (rid, lo, frac as int32 / f32) of each of the
    `live` pairs whose g is not all zero, and the table gradient written
    once; ~47 f32 operations per live pair (3 subtractions, 12 weight and
    16 gradient products, 16 additions)."""
    nbytes = pairs * 8 + live * 28 + total_rows * 2 * row_cells * 4
    flops = live * 47.0
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


def k2_measure(pairs, meta, floor):
    """K2 on one set of pairs: its gradient and the f32 plain version's
    against the float64 plain version (k2_agrees with `floor`), the card's
    plan against the plain plan, and the times of the kernel, of its
    pre-pass alone, of the plain version and of the library call
    (index_add_ of the prebuilt dense rows: the scatter of the plain
    version and of the trainer's default backward)."""
    import torch
    from enerf_torch.ops import scatter_accum as sa
    from enerf_torch.ops.blockgrid import _trilinear_weights

    T, RC = meta.total_rows, meta.row_cells
    P = pairs[0].shape[0]
    got = sa.launch_kernel(*pairs, T, meta)
    twin = sa.block_table_grad_reference(*pairs, T, meta)
    ref64 = sa.block_table_grad_reference(*pairs, T, meta, torch.float64)
    mag = k2_magnitude([pairs], T, meta)
    ok_k, ratio_k = k2_agrees((got.double() - ref64).abs(), mag, floor)
    ok_t, ratio_t = k2_agrees((twin.double() - ref64).abs(), mag, floor)
    max_abs = float((got - twin).abs().max())
    del got, twin, ref64, mag
    plan_ok, plan = k2_plan_agrees(pairs, T, meta)
    # device times from CUDA graphs (the wrapper's host time per call is
    # of the kernel's order); the host-enqueued time beside them
    ms = graph_ms(lambda: sa.launch_kernel(*pairs, T, meta), iters=10)
    prepass_ms = graph_ms(lambda: sa.launch_prepass(*pairs, T, meta), iters=10)
    host_ms = time_ms(lambda: sa.launch_kernel(*pairs, T, meta))
    split = kernel_split(lambda: sa.launch_kernel(*pairs, T, meta), ms)
    plain_ms = time_ms(lambda: sa.block_table_grad_reference(*pairs, T, meta), iters=5)
    rid, lo, frac, gg = pairs
    rows = (gg[:, :, None] * _trilinear_weights(lo, frac, meta)[:, None, :]).reshape(P, -1)
    rid64, acc = rid.long(), torch.zeros(T, 2 * RC, device="cuda")
    library_ms = time_ms(lambda: acc.index_add_(0, rid64, rows), iters=5)
    del rows, acc
    live = int((gg != 0).any(dim=1).sum())
    bound_ms, bound_by, nbytes = k2_bound(P, live, T, RC)
    line = (f"|K2 - f64| / bound {ratio_k:.3e}, |f32 twin - f64| / bound {ratio_t:.3e} (bound "
            f"1e-5 * sum|g W| + {floor:.3e}), |K2 - twin| max {max_abs:.3e}, exactly 0 where "
            f"sum|g W| is 0; pre-pass plan = plain plan {plan_ok} ({plan_line(plan)}) -> "
            f"{'ok' if ok_k and ok_t and plan_ok else 'FAIL'}; kernel {ms:.4f} ms (the pre-pass "
            f"alone {prepass_ms:.4f} ms; by kernel {split}; one call enqueued from the host "
            f"{host_ms:.4f} ms), plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB for {live} live pairs), "
            f"share of bound "
            f"{bound_ms / ms:.1%}")
    return dict(ok=ok_k and ok_t and plan_ok, line=line, max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, prepass_ms=prepass_ms, host_ms=host_ms,
                by_kernel=split, pairs=P)


def kernel_split(fn, ms, calls=5):
    """{kernel: mean device ms per call of fn} from torch.profiler over
    `calls` calls; "not measured" where the profiler's kernels do not add
    up to within 20% of fn's device time `ms` (records lost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
        if dev_us > 0 and ev.key != "" and not ev.key.startswith("ProfilerStep"):
            name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
            split[name] = round(split.get(name, 0.0) + dev_us / calls / 1e3, 4)
    if abs(sum(split.values()) - ms) > 0.2 * ms:
        return f"not measured (the profiler's kernels add up to {sum(split.values()):.4f} ms)"
    return split


def hook_k2_inputs(loss, store):
    """Before each block_encode_fast node of loss's graph runs its backward,
    append to `store` what the node forms K2's inputs from: its saved
    positions x, its incoming gradient g_out and its out-of-box mask oob."""
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
                store.append(dict(x=x, g_out=grad_outputs[0].clone(), oob=oob))
            node.register_prehook(pre)


def k2_plan_agrees(pairs, total_rows, meta):
    """K2's pre-pass on the card against its plain version
    (scatter_accum.table_grad_plan): the same tile counts, offsets and work
    list.  Returns (ok, the plain plan)."""
    import torch
    from enerf_torch.ops import scatter_accum as sa
    rid, _, _, g = pairs
    got = sa.device_plan(*pairs, total_rows, meta)
    ref = sa.table_grad_plan(rid, g, total_rows, sa.tile_rows_of(meta))
    return all(torch.equal(got[k], getattr(ref, k)) for k in got), ref


def plan_line(plan):
    shared = plan.chunk_tile[plan.chunk_shared].unique().numel()
    return (f"{plan.counts.numel()} tiles of {plan.tile_rows} rows, {int(plan.offsets[-1])} "
            f"live pairs, {plan.chunk_tile.numel()} chunks, {shared} shared tiles "
            f"({int(plan.chunk_shared.sum())} chunks)")


def phase_k2_kernel():
    """K2 against its plain version at the main path's shape: 131,072
    samples (4096 rays x 64 x 0.5) x 16 levels x 2 features, positions in
    the unit box and g ~ N(0, 1) from a seed; block 4 and block 3.  Its
    pre-pass's plan against the plain plan, the pre-pass's time alone, and
    the kernel's time on the same pairs sample by sample."""
    import torch
    from enerf_torch.models.field import FieldStatic
    from enerf_torch.ops import scatter_accum as sa

    B = 4096 * 32
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for block in (4, 3):
        meta = FieldStatic(bound=1.0, encoding="blockgrid", grid_block=block).grid_meta
        T = meta.total_rows
        x = torch.rand(B, 3, device="cuda", generator=gen)
        g = torch.randn(B, 2 * meta.num_levels, device="cuda", generator=gen)
        pairs = sa.pair_inputs(x, g, meta)
        # the absolute floor 1e-7 for g ~ N(0, 1)
        r = k2_measure(pairs, meta, 1e-7)
        print(f"[kernel] block_table_grad blk{block} {r['pairs']} pairs -> [{T}, "
              f"{2 * meta.row_cells}]: {r['line']}")
        if not r.pop("ok"):
            raise AssertionError(f"K2 blk{block} is outside its bound of the float64 twin, "
                                 "or its pre-pass differs from the plain plan")
        # the same pairs sample by sample (pair_inputs lists them level by level)
        L = meta.num_levels
        by_sample = [a.reshape(L, -1, *a.shape[1:]).transpose(0, 1).reshape(a.shape).contiguous()
                     for a in pairs]
        r["sample_order_ms"] = graph_ms(lambda: sa.launch_kernel(*by_sample, T, meta), iters=10)
        del by_sample
        print(f"[kernel] block_table_grad blk{block}: the same pairs sample by sample "
              f"{r['sample_order_ms']:.4f} ms, level by level {r['ms']:.4f} ms")
        del r["line"], r["pairs"]
        results[block] = r
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
    reset_e1()  # E1 runs where the provider builds the chains
    print(f"[main] field: {meta.num_levels}x{meta.level_dim} levels, blk{meta.block}, "
          f"{meta.total_rows} rows x {meta.row_cells * meta.level_dim} f32 "
          f"({meta.total_rows * meta.row_cells * meta.level_dim * 4 / 1e6:.1f} MB table), "
          f"fused head {trainer.static.use_fused_head}, compute {trainer.static.compute_dtype}")
    t0 = time.time()
    built = record_chain_builds()
    try:
        train, val = make_providers(cfg, device=trainer.device)
    finally:
        built = built()
    print(f"[main] synthetic data {cfg.H}x{cfg.W}: {time.time() - t0:.1f} s; "
          f"{len(val.val_views())} val views; chains built on the card in "
          f"{train.load_seconds['chains']:.3f} s")
    # E1 against its plain version on the main path's own events, before the
    # steps (the plain build launches nothing, so the counts stay the path's)
    if not built or not any(c is train.chains for _, c, _ in built):
        raise AssertionError("the main path's provider built no chains through "
                             "build_event_chains")
    err = max(e1_check_build(*b) for b in built)
    print(f"[main] E1's chains on the main path: {len(built)} build(s) of "
          f"{sum(len(a[0]) for a, _, _ in built)} events, every field bit-equal to the plain "
          f"version's on the same events (max abs err {err})")
    MAIN_E1["max_abs_err"] = err
    steps = 48
    train.steps_per_epoch = steps
    # the steps' march host syncs and M1 launches apart from the evaluation's
    at_eval, evaluate = {}, trainer.evaluate

    def counted_evaluate(*a, **kw):
        at_eval.update(syncs=march_rays.host_syncs, m1=march_rays.launches)
        return evaluate(*a, **kw)

    trainer.evaluate = counted_evaluate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.fused_field_head.launches = 0
    scatter_accum.block_table_grad.launches = 0
    march_rays.host_syncs = march_rays.launches = 0
    t0 = time.time()
    trainer.train(train, val, max_epoch=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    del trainer.evaluate
    launches = fused_mlp.fused_field_head.launches
    k2_launches = scatter_accum.block_table_grad.launches
    step_syncs, step_m1 = at_eval["syncs"], at_eval["m1"]
    secs = trainer.epoch_seconds  # the trainer's synchronized split of the epoch
    step_s = secs["steps"]
    losses = [aux["loss"] for _, aux in trainer.history]
    print(f"[main] window means at logged steps: "
          + ", ".join(f"{s}:{aux['loss']:.5f}" for s, aux in trainer.history))
    print(f"[main] train(train, val, 1): {wall:.2f} s = {steps / wall:.3f} steps/s with the "
          f"epoch tail; the {steps} steps ({steps // cfg.fuse_steps} graphed {cfg.fuse_steps}-step "
          f"windows, the first captured) {step_s:.2f} s = {steps / step_s:.3f} steps/s "
          f"(3 occupancy updates included); tail "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items() if k != "steps")
          + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"K1 launches {launches} (evaluation included); K2 launches {k2_launches}; "
          f"M1 launches {step_m1} in the steps (a replay's counted from the capture, "
          f"held to a profiled replay in phase 6c), {march_rays.launches - step_m1} in the "
          f"evaluation; march host syncs {step_syncs} in the steps, "
          f"{march_rays.host_syncs - step_syncs} in the evaluation (its infer windows)")
    res = trainer.last_eval
    print("[main] eval: " + ", ".join(
        f"{k} {res.get(k)}" for k in ("psnr", "ssim", "affine_a", "affine_b",
                                      "psnr_corrected", "ssim_corrected"))
          + "; " + lpips_text(trainer))
    print(f"[main] {diagnostics_text(trainer)}")
    # one log line a window: JAX's trainer logs when global_step // log_every
    # changes, and each 16-step window crosses a multiple of log_every 8
    if not (len(losses) == steps // cfg.fuse_steps and np.isfinite(losses).all()):
        raise AssertionError(f"main path window losses not one a window, or not finite: "
                             f"{losses}")
    if trainer.state.step != steps or trainer.occupancy.iter_density != 3:
        raise AssertionError(f"step {trainer.state.step} != {steps} or iter_density "
                             f"{trainer.occupancy.iter_density} != 3")
    if launches < 2 * steps:
        raise AssertionError(f"K1 launched {launches} times in {steps} steps")
    if step_m1 != steps or step_syncs:
        raise AssertionError(f"the steps launched M1 {step_m1} times (1 a step expected) and "
                             f"took {step_syncs} march host syncs (0 expected)")
    if k2_launches:
        raise AssertionError("the main path's table backward is index_add_, yet K2 launched")
    if not all(np.isfinite(res.get(k, np.nan)) for k in ("psnr_corrected", "ssim_corrected")):
        raise AssertionError(f"evaluation gave no finite corrected metrics: {res}")
    e1 = e1_launches()
    print(f"[main] E1 launches on the main path: {e1} (sort, group tables)")
    if not (e1[0] and e1[1]):
        raise AssertionError("the main path's chains were not built by E1")
    MAIN_E1["launches"] = e1
    return trainer, train, val, launches, march_rays.launches


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
    from enerf_torch.render.march import composite_from_march, march_rays, march_rays_pair
    from enerf_torch.render.occupancy import clone_occupancy, update_occupancy
    from enerf_torch.train import losses
    from enerf_torch.train.step import draw_noise

    ss, state, fs = trainer.ss, trainer.state, trainer.ss.field_static
    occ = trainer.occupancy.occ_packed
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
    syncs0, launches0 = march_rays.host_syncs, march_rays.launches
    rays = [(batch[f"rays_evs_o{i}"], batch[f"rays_evs_d{i}"]) for i in (1, 2)]
    near_far = [near_far_from_aabb(o, d, aabb_tensor(fs.bound, o.device), ss.min_near)
                for o, d in rays]
    # the step's one march of both renders (train/step.py:_render_pair_march)
    marched = timed("march", lambda: march_rays_pair(
        *zip(*rays), occ, *zip(*near_far), jitter=(noise["jitter1"], noise["jitter2"]),
        num_samples=ss.march_samples, max_steps=ss.max_steps,
        cascades=trainer.occupancy.density_grid.shape[0], bound=fs.bound,
        dt_gamma=ss.dt_gamma, perturb=True))
    images = []
    for (o, d), (nears, fars), (ts, dts, valid) in zip(rays, near_far, marched):
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
    # on a copy: the update writes in place
    occ_copy = clone_occupancy(trainer.occupancy)
    timed("occupancy update (1 in 16 steps)", lambda: update_occupancy(
        state.params, fs, occ_copy, trainer.generator,
        density_scale=trainer.cfg.density_scale, density_thresh=trainer.cfg.density_thresh))
    print("[breakdown] one step, ms (host clock, synchronized): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; march host syncs {march_rays.host_syncs - syncs0}, M1 launches "
          f"{march_rays.launches - launches0} (one march of both renders)")


def phase_inference(trainer, val):
    """One main-path view (64 x 64) through `Trainer.render_view`, the
    alive-ray inference renderer with M1: finite, in [0, 1], through K1.
    Then M1 at the inference renderer's shapes: the same view rendered
    with the plain march `_march` in M1's place, on the same CUDA inputs,
    within 1e-5 of M1's view in image and depth; and the first and the
    last march window of M1's render (t0 carried from the window before,
    dead rays started at or past far) held against `_march` ray by ray
    (m1_compare).  Returns m1_compare's numbers of both windows."""
    import numpy as np
    import torch
    from enerf_torch.ops import fused_mlp
    from enerf_torch.render import march as M

    v = val.val_views()[0]
    fused_mlp.fused_field_head.launches = 0
    M.march_rays.host_syncs = 0
    kernel, windows = M.launch_kernel, []

    def recording(*a, **kw):  # keeps each window's inputs (the call's pre-pass aside)
        windows.append(([x.clone() for x in a], {k: v for k, v in kw.items() if k != "aux"}))
        return kernel(*a, **kw)

    M.launch_kernel = recording
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        img, depth = trainer.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
        wall = time.time() - t0
        launches, syncs = fused_mlp.fused_field_head.launches, M.march_rays.host_syncs
        # the plain march on the same CUDA tensors
        M.launch_kernel = lambda *a, aux=None, **kw: M._march(*a, **kw)
        t0 = time.time()
        img_p, depth_p = trainer.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
        plain_wall = time.time() - t0
    finally:
        M.launch_kernel = kernel
    ok = (np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0 + 1e-6
          and np.isfinite(depth).all())
    print(f"[infer] view {v['H']}x{v['W']}: {wall:.2f} s, image mean {img.mean():.4f} "
          f"in [{img.min():.4f}, {img.max():.4f}], K1 launches {launches}, "
          f"{len(windows)} march windows, march host syncs {syncs} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("inference image not finite or outside [0, 1]")
    if launches == 0:
        raise AssertionError("inference did not go through K1")
    d_img, d_depth = float(np.abs(img - img_p).max()), float(np.abs(depth - depth_p).max())
    same = d_img <= 1e-5 and d_depth <= 1e-5
    print(f"[infer] the same view with the plain march in M1's place ({plain_wall:.2f} s): "
          f"max |diff| image {d_img:.3e}, depth {d_depth:.3e} (tol 1e-5) -> "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("the inference view with M1 disagrees with the plain march's")
    out, old = {}, old_march()
    for tag, i in (("first", 0), ("last", len(windows) - 1)):
        args, kw = windows[i]
        out[tag] = m1_compare(f"infer window {i + 1} of {len(windows)}", *args, **kw)
        if old is not None:
            out[tag]["old"] = m1_against_old(f"infer window {i + 1}", old, out[tag], *args, **kw)
    if old is None:
        print(f"[m1] the old march kernel not measured: no copy of its source at "
              f"{os.path.relpath(OLD_M1, REPO)}")
    return out


# M1's operations a (ray, lookup) pair, counted from the kernel's lookup()
# and its loop (csrc/march_rays.cu's note): 43 float32 operations and ~30
# integer ones, all charged at the float32 rate
M1_OPS_PER_LOOKUP = 43 + 30


def m1_bound(N, S, cascades, lookups):
    """Least time for M1's work: its inputs read once (rays 24 bytes, nears,
    fars, t0 12 bytes a ray; the packed bitfield 8 bytes a superblock), its
    outputs written once (ts, dts 8 bytes and valid 1 a slot, t_end 4 a
    ray), and M1_OPS_PER_LOOKUP operations for each (ray, lookup) pair
    that this run's rays make (counted by the plain version), at the
    float32 rate."""
    nbytes = N * (24 + 12 + 4) + N * S * 9 + cascades * 32 ** 3 * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = lookups * M1_OPS_PER_LOOKUP / PEAK_FLOPS["float32"] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), nbytes


def m1_compare(tag, o, d, bits, nears, fars, t0, **kw):
    """M1 against `_march` on the same inputs: valid identical, and the
    share of rays whose ts, dts and t_end are bit-equal (>= 99.99%); every
    differing ray printed with its first differing slot; M1's pre-pass
    equal to its plain version.  The kernel and the pre-pass are timed
    apart, from CUDA graph replays (the kernel alone is shorter than the
    host's enqueue).  Returns the kernel line's numbers, with lookups a ray
    (the plain version's count), ms per link of the longest chain and the
    occupied share of each cascade's superblocks."""
    import torch
    from enerf_torch.render import march as M

    def bits_of(x):
        return x.contiguous().view(torch.int32)

    cas, bound = kw["cascades"], kw["bound"]
    aux = M.march_prepass(bits, cas, bound)
    aux_same = bool(torch.equal(aux, M.march_aux_reference(bits, cas, bound)))
    got = M.launch_kernel(o, d, bits, nears, fars, t0, aux=aux, **kw)
    lookups0 = M.march_rays.lookups
    ref = M._march(o, d, bits, nears, fars, t0, **kw)
    lookups = M.march_rays.lookups - lookups0
    ray_lookups = M.march_rays.ray_lookups
    torch.cuda.synchronize()
    N, S = got[0].shape
    valid_same = bool(torch.equal(got[2], ref[2]))
    slot_same = ((bits_of(got[0]) == bits_of(ref[0])) & (bits_of(got[1]) == bits_of(ref[1]))
                 & (got[2] == ref[2]))
    ray_same = slot_same.all(1) & (bits_of(got[3]) == bits_of(ref[3]))
    share = float(ray_same.float().mean())
    bad = torch.nonzero(~ray_same).flatten()[:20].tolist()
    for i in bad:
        row = (~slot_same[i]).nonzero().flatten()
        j = int(row[0]) if row.numel() else -1  # -1: only t_end differs

        def slot(out):
            return [float(out[0][i, j]), float(out[1][i, j]), bool(out[2][i, j])]

        print(f"[m1] {tag}: ray {i} differs from slot {j}: kernel ts/dts/valid "
              f"{slot(got) if j >= 0 else ''}, plain {slot(ref) if j >= 0 else ''}, t_end "
              f"{float(got[3][i])} vs {float(ref[3][i])}")
    max_abs = max(float((got[k].float() - ref[k].float()).abs().max()) for k in (0, 1, 3))
    ms = graph_ms(lambda: M.launch_kernel(o, d, bits, nears, fars, t0, aux=aux, **kw),
                  iters=20)
    prepass_ms = graph_ms(lambda: M.march_prepass(bits, cas, bound), iters=20)
    plain_ms = time_ms(lambda: M._march(o, d, bits, nears, fars, t0, **kw), iters=2, warmup=1)
    bound_ms, bound_by, nbytes = m1_bound(N, S, cas, lookups)
    mean_l, max_l = float(ray_lookups.float().mean()), int(ray_lookups.max())
    occupied = (bits.view(cas, -1, 2) != 0).any(-1).float().mean(1).tolist()
    ok = valid_same and share >= 0.9999 and aux_same
    print(f"[m1] {tag}: {N} rays x {S} samples, {int(ref[2].sum())} valid, {lookups} lookups "
          f"(a ray: mean {mean_l:.2f}, max {max_l}): valid identical {valid_same}, rays "
          f"bit-equal {share:.6f} ({N - int(ray_same.sum())} differ), max |diff| {max_abs:.3e}, "
          f"pre-pass equal to its plain version {aux_same} -> {'ok' if ok else 'FAIL'}; kernel "
          f"{ms:.4f} ms ({ms * 1e3 / max(max_l, 1):.3f} us a link of the longest chain), "
          f"pre-pass {prepass_ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms by "
          f"{bound_by} ({nbytes / 1e6:.2f} MB, {lookups} x {M1_OPS_PER_LOOKUP} ops), share of "
          f"bound {bound_ms / ms:.2%}; occupied superblocks a cascade "
          f"{[round(x, 4) for x in occupied]}")
    if not ok:
        raise AssertionError(f"M1 disagrees with its plain version at {tag}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, share_of_bound=bound_ms / ms,
                rays_bit_equal=share, lookups=lookups, lookups_mean=mean_l, lookups_max=max_l,
                ms_per_link=ms / max(max_l, 1), prepass_ms=prepass_ms,
                occupied_superblocks=occupied)


# The nested-loop march kernel of commit 580e741, for a measuring call
# only: a copy of its source (git show 580e741:enerf_torch/csrc/march_rays.cu)
# at this path is built and timed beside M1 in turns; without the file the
# comparison is skipped.
OLD_M1 = os.path.join(REPO, "build", "march_rays_580e741.cu")


def old_march():
    """A launcher of the old march kernel (its C interface) built from
    OLD_M1, or None."""
    import ctypes
    import numpy as np
    import torch
    from enerf_torch.ops import cuda_build
    from enerf_torch.render import march as M
    if not os.path.exists(OLD_M1):
        return None
    lib = os.path.splitext(OLD_M1)[0] + ".so"
    subprocess.run([cuda_build._nvcc(), "-gencode", cuda_build.ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, OLD_M1], check=True)
    fn = ctypes.CDLL(lib).march_rays_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(o, d, bits, nears, fars, t0, *, num_samples, max_steps, cascades, bound,
               dt_gamma):
        N = o.shape[0]
        ts, dts = (torch.empty(N, num_samples, device="cuda") for _ in range(2))
        valid = torch.empty(N, num_samples, dtype=torch.bool, device="cuda")
        t_end = torch.empty(N, device="cuda")
        dt_min = np.float32(2.0 * M.SQRT3 / max_steps)
        k = M.emit_k(max_steps) if dt_gamma == 0.0 else 1
        err = fn(o.data_ptr(), d.data_ptr(), bits.data_ptr(), nears.data_ptr(),
                 fars.data_ptr(), t0.data_ptr(), ts.data_ptr(), dts.data_ptr(),
                 valid.data_ptr(), t_end.data_ptr(), N, num_samples, k, int(dt_gamma == 0.0),
                 cascades, float(dt_min),
                 float(np.float32(2.0 * M.SQRT3 * 2 ** (cascades - 1) / M.GRID_SIZE)),
                 float(np.float32(dt_gamma)), float(np.float32(bound)),
                 float(np.float32(1.0) / dt_min), float(M._inv_hm1()),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the old march kernel failed to launch: cudaError {err}")
        return ts, dts, valid, t_end
    return launch


def m1_against_old(tag, old_launch, m1, o, d, bits, nears, fars, t0, launches=1, **kw):
    """The old march kernel (one launch a render: `launches` of them) and
    M1 (one launch for all the rays, its pre-pass included) in turns on the
    same inputs: old, M1, M1, old, from CUDA graph replays; the old
    kernel's outputs must equal M1's bit for bit.  `m1`: m1_compare's
    numbers."""
    import torch
    from enerf_torch.render import march as M

    parts = [slice(i * o.shape[0] // launches, (i + 1) * o.shape[0] // launches)
             for i in range(launches)]

    def old():
        return [old_launch(o[p], d[p], bits, nears[p], fars[p], t0[p], **kw) for p in parts]

    got, new = old(), M.launch_kernel(o, d, bits, nears, fars, t0, **kw)
    same = all(torch.equal(torch.cat([g[k] for g in got]).view(torch.uint8),
                           new[k].contiguous().view(torch.uint8)) for k in range(4))
    times = {"old": [], "m1": []}
    for side in ("old", "m1", "m1", "old"):
        times[side].append(graph_ms(old if side == "old" else lambda: M.launch_kernel(
            o, d, bits, nears, fars, t0, **kw), iters=10))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    link = 1e3 / max(m1["lookups_max"], 1)
    print(f"[m1] {tag}, in turns with the old march kernel ({launches} launch(es)): old "
          f"{ms['old']:.4f} ms ({ms['old'] * link:.3f} us a link, share of bound "
          f"{m1['bound_ms'] / ms['old']:.2%}), M1 {ms['m1']:.4f} ms with its pre-pass "
          f"({ms['m1'] * link:.3f} us a link, {m1['bound_ms'] / ms['m1']:.2%}): "
          f"{ms['old'] / ms['m1']:.2f}x; longest chain {m1['lookups_max']} lookups; the old "
          f"kernel's outputs {'bit-equal to' if same else 'DIFFER from'} M1's")
    if not same:
        raise AssertionError(f"the old march kernel and M1 disagree at {tag}")
    return dict(old_ms=ms["old"], m1_ms=ms["m1"], old_runs=times["old"],
                m1_runs=times["m1"], old_share_of_bound=m1["bound_ms"] / ms["old"])


def phase_march_kernel(trainer, train):
    """M1 against its plain version at the main path's shapes (both renders
    of a main-path batch, 8192 event rays x 64 samples, jittered, through
    the trained occupancy grid: the step's one launch; and the first
    render's 4096 alone) and at bench.py's (8192 rays x 32 samples from
    (0, 0, -2.5) in random directions, the ball bitfield), the latter also
    with dt_gamma 1/256 (one sample a lookup)."""
    import torch
    from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
    from enerf_torch.render.march import SQRT3
    from enerf_torch.render.occupancy import ball_bitfield, pack_bitfield

    gen = torch.Generator(device="cuda").manual_seed(5)
    ss = trainer.ss
    batch = train.train_step_batch(gen)
    renders = []
    for i in (1, 2):
        o, d = batch[f"rays_evs_o{i}"].contiguous(), batch[f"rays_evs_d{i}"].contiguous()
        nears, fars = near_far_from_aabb(o, d, aabb_tensor(trainer.static.bound, "cuda"),
                                         ss.min_near)
        t0 = nears + (2.0 * SQRT3 / ss.max_steps) * torch.rand(o.shape[0], device="cuda",
                                                               generator=gen)
        renders.append((o, d, nears, fars, t0))
    occ = trainer.occupancy
    kw = dict(num_samples=ss.march_samples, max_steps=ss.max_steps,
              cascades=occ.density_grid.shape[0], bound=trainer.static.bound,
              dt_gamma=ss.dt_gamma)
    old = old_march()
    o, d, nears, fars, t0 = (torch.cat(x) for x in zip(*renders))
    out = {"pair": m1_compare("main path, both renders", o, d, occ.occ_packed, nears, fars, t0,
                              **kw)}
    if old is not None:  # the step's two launches before, its one launch now
        out["pair"]["old"] = m1_against_old("main path, both renders", old, out["pair"], o, d,
                                            occ.occ_packed, nears, fars, t0, launches=2, **kw)
    o, d, nears, fars, t0 = renders[0]
    out["main"] = m1_compare("main path, one render", o, d, occ.occ_packed, nears, fars, t0, **kw)
    if old is not None:
        out["main"]["old"] = m1_against_old("main path, one render", old, out["main"], o, d,
                                            occ.occ_packed, nears, fars, t0, **kw)
    n = 8192
    d = torch.randn(n, 3, device="cuda", generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.tensor([[0.0, 0.0, -2.5]], device="cuda").expand(n, 3).contiguous()
    nears, fars = near_far_from_aabb(o, d, aabb_tensor(1.0, "cuda"), 0.2)
    t0 = nears + (2.0 * SQRT3 / 1024) * torch.rand(n, device="cuda", generator=gen)
    bits = pack_bitfield(ball_bitfield(device="cuda"))
    for gamma, key in ((0.0, "bench"), (1.0 / 256, "bench_dt_gamma")):
        out[key] = m1_compare(f"bench.py, dt_gamma {gamma:g}", o, d, bits, nears, fars, t0,
                              num_samples=32, max_steps=1024, cascades=1, bound=1.0,
                              dt_gamma=gamma)
    return out


def state_snapshot(trainer):
    """Copies of what a training window changes: the state's tensors and
    step, the occupancy's tensors and count, the generators' states."""
    st, occ = trainer.state, trainer.occupancy
    tensors = {(name, k): v.detach().clone()
               for name in ("params", "ema_params", "exp_avg", "exp_avg_sq")
               for k, v in getattr(st, name).items()}
    tensors[("count", None)] = st.count.clone()
    for f in ("density_grid", "occ_bitfield", "mean_density", "occ_packed"):
        tensors[("occ", f)] = getattr(occ, f).clone()
    return dict(tensors=tensors, step=st.step, iter_density=occ.iter_density,
                gens=[g.get_state() for g in (trainer.generator, trainer.rank_generator)])


def state_restore(trainer, snap):
    """Put `snap` back in place (the same tensors: a captured graph reads them)."""
    import torch
    st = trainer.state
    with torch.no_grad():
        for (name, k), v in snap["tensors"].items():
            if name == "occ":
                getattr(trainer.occupancy, k).copy_(v)
            elif name == "count":
                st.count.copy_(v)
            else:
                getattr(st, name)[k].copy_(v)
    st.step = snap["step"]
    trainer.occupancy = trainer.occupancy._replace(iter_density=snap["iter_density"])
    for g, state in zip((trainer.generator, trainer.rank_generator), snap["gens"]):
        g.set_state(state)


def phase_window(trainer, train):
    """One main-path window (train/chunk.py) run eagerly under
    torch.cuda.set_sync_debug_mode("error"): no host sync in its occupancy
    update, batches, marches and steps.  Then, from one state and one set
    of generator states, the eager window against the graphed one (the
    trainer's captured graph, replayed 16 times): the window's mean loss
    within 1e-4 relative, each leaf's params within 2e-2 of the window's
    update by norm and within 2 lr x 16 everywhere (index_add_'s float
    atomics make two runs differ at the rounding level; Adam then steps
    small gradients either way, as between two ranks, dp_check)."""
    import torch
    from enerf_torch.render.march import march_rays

    from enerf_torch.utils import profiling

    chunk = trainer._chunk(train, trainer.cfg.fuse_steps, trainer.state.step)
    K = chunk.chunk_len
    syncs = march_rays.host_syncs
    profiling.snapshot()  # the span marks' ring read now: no drain inside the window
    torch.cuda.synchronize()
    t0 = time.time()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.occupancy, aux = chunk.eager(trainer.state, trainer.occupancy, train,
                                             trainer.generator, trainer.rank_generator)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sync_s = time.time() - t0
    print(f"[window] one {K}-step window eagerly under set_sync_debug_mode('error'): no host "
          f"sync ({sync_s:.2f} s, loss {float(aux['loss']):.6f}, march host syncs "
          f"{march_rays.host_syncs - syncs})")

    snap = state_snapshot(trainer)
    p0 = {k: v for (name, k), v in snap["tensors"].items() if name == "params"}
    runs = {}
    for mode in ("eager", "graph", "graph", "eager"):  # in turns: one card, one call
        state_restore(trainer, snap)
        torch.cuda.synchronize()
        t0 = time.time()
        if mode == "eager":
            occ, aux = chunk.eager(trainer.state, trainer.occupancy, train, trainer.generator,
                                   trainer.rank_generator)
        else:
            occ, aux = chunk(trainer.state, trainer.occupancy, train, trainer.generator,
                             trainer.rank_generator)
        torch.cuda.synchronize()
        sec = time.time() - t0
        trainer.occupancy = occ
        runs.setdefault(mode, []).append(dict(
            s=sec, loss=float(aux["loss"]),
            params={k: v.detach().clone() for k, v in trainer.state.params.items()}))
    e, g = runs["eager"][0], runs["graph"][0]
    lr = trainer.cfg.lr
    worst_rel, worst_abs = 0.0, 0.0
    for k, pe in e["params"].items():
        upd = float(torch.linalg.vector_norm(pe - p0[k]))
        diff = float(torch.linalg.vector_norm(g["params"][k] - pe))
        worst_rel = max(worst_rel, diff / upd if upd else (0.0 if diff == 0 else float("inf")))
        worst_abs = max(worst_abs, float((g["params"][k] - pe).abs().max()))
    loss_rel = abs(g["loss"] - e["loss"]) / abs(e["loss"])
    same = all(torch.equal(g["params"][k], pe) for k, pe in e["params"].items())
    ok = loss_rel <= 1e-4 and worst_rel <= 2e-2 and worst_abs <= 2 * K * lr * (1 + 1e-4)
    print(f"[window] graphed vs eager from one state and draws: window loss "
          f"{g['loss']:.6f} vs {e['loss']:.6f} (rel {loss_rel:.2e}, tol 1e-4); params "
          f"{'bit-equal' if same else 'differ'}: worst leaf ||diff|| / ||update|| "
          f"{worst_rel:.2e} (tol 2e-2), max |diff| {worst_abs:.3e} (tol {2 * K * lr:g}); "
          f"eager {[round(r['s'], 3) for r in runs['eager']]} s, graphed "
          f"{[round(r['s'], 3) for r in runs['graph']]} s a window -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the graphed window disagrees with the eager one")
    per_replay = {c.__name__: n for c, n in chunk.per_replay.launches.items()}
    seen, ring = replay_profile(chunk)
    agree = seen is None or all(seen[k] == n for k, n in per_replay.items() if k != "span_mark")
    marked = 2 * ring == per_replay["span_mark"]
    print(f"[window] kernel launches a replay adds to the counts (recorded in the capture) "
          f"{per_replay}; torch.profiler in one replay: "
          f"{seen if seen is not None else 'no device kernel recorded: not measured'}; the span "
          f"marks' ring in that replay: {ring} spans, each a start and an end mark -> "
          f"{'ok' if agree and marked else 'FAIL'}")
    if not agree:
        raise AssertionError("a replay's launch counts disagree with the profiled replay")
    if not marked:
        raise AssertionError("a replay's span marks disagree with the marks' ring")
    trainer._release_windows()
    return dict(eager_s=[r["s"] for r in runs["eager"]], graph_s=[r["s"] for r in runs["graph"]],
                launches_per_replay=per_replay, profiled_replay=seen)


# the port's kernels by the counter of their wrapper, and the CUDA kernel
# each wrapper launch runs once (csrc/*.cu)
KERNEL_NAMES = {"fused_field_head": ("head_bf16_kernel", "head_f32_kernel"),
                "block_table_grad": ("accumulate_kernel",),
                "group_gather": ("group_gather_kernel",),
                "march_rays": ("march_rays_kernel",),
                "span_mark": ("span_mark_kernel",)}


def replay_profile(chunk):
    """One replay of a window's captured step under torch.profiler ->
    ({counter: the kernels of that wrapper the profiler saw}, or None when
    it recorded no device kernel at all; the span instances whose start
    and end marks the marks' ring recorded in the replay).  The marks are
    held to the ring, not to the profiler: after the smoke's earlier
    phases the profiler misses a replay's first few kernels, the step's
    first two marks among them, which the ring records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from enerf_torch.utils import profiling

    profiling.reset()
    profiling.replayed(chunk.per_replay)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk.graph.replay()
        torch.cuda.synchronize()
    seen, any_kernel = {name: 0 for name in KERNEL_NAMES}, False
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        any_kernel = True
        for name, kernels in KERNEL_NAMES.items():
            seen[name] += any(k in ev.name for k in kernels)
    spans = profiling.snapshot()["spans"].values()
    ring = sum(s["graphed"] for s in spans if s["device_s"] is not None)
    return (seen if any_kernel else None), ring


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
    from enerf_torch.render.occupancy import ball_bitfield, pack_bitfield
    from enerf_torch.train import losses
    from enerf_torch.train.state import TrainState

    n_rays, steps, dev = 8192, 4, "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    d = torch.randn(n_rays, 3, device=dev, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.tensor([[0.0, 0.0, -2.5]], device=dev).expand(n_rays, 3)
    pols = torch.ones(n_rays, device=dev)
    bg = torch.full((n_rays, 1), 0.5, device=dev)
    bitfield = pack_bitfield(ball_bitfield(device=dev))
    noise = [(torch.rand(n_rays, device=dev, generator=gen),
              torch.rand(n_rays, device=dev, generator=gen)) for _ in range(steps)]
    runs, raw_log = {True: [], False: []}, []  # raw_log: K2's inputs of step 1, unformed
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
                hook_k2_inputs(loss, raw_log)
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
    pair_log = [sa.pair_inputs(r["x"], r["g_out"], meta, r["oob"]) for r in raw_log]
    os.makedirs(os.path.join(REPO, "build", "chip_smoke_k2path"), exist_ok=True)
    torch.save(raw_log, os.path.join(REPO, "build", "chip_smoke_k2path", "step1.pt"))
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
    # K2 alone on the path's own step-1 pairs (clustered march samples),
    # each render's: the same tolerance, the floor scaled as above
    on_path = []
    for i, pairs in enumerate(pair_log):
        r = k2_measure(pairs, meta, 1e-7 * float(k2_magnitude([pairs], meta.total_rows,
                                                               meta).max()))
        print(f"[k2path] K2 alone on render {i + 1}'s {r['pairs']} pairs of step 1: {r['line']}")
        if not r.pop("ok"):
            raise AssertionError("K2 disagrees with its plain version on the K2 path's pairs")
        del r["line"]
        on_path.append(r)
    return runs[True][0]["launches"], on_path


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


def default_config(workspace, *extra):
    from enerf_torch.config import build_config
    return build_config([
        "--config", os.path.join(REPO, "configs", "synthetic_demo.txt"), "--event_only", "0",
        "--iters", "48", "--log_every", "8", "--seed", "0", "--val_idxs", "0",
        "--val_idxs", "20", "--eval_interval", "1", "--outdir", workspace, *extra])


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
    print("[default] window means at logged steps: " + ", ".join(
        f"{s}: loss {aux['loss']:.5f} evs {aux['loss_evs']:.5f} frames {aux['loss_frames']:.5f}"
        for s, aux in hist))
    print(f"[default] train(train, val, 1): {wall:.2f} s = {steps / wall:.3f} steps/s with the "
          f"epoch tail; the {steps} steps ({steps // cfg.fuse_steps} graphed windows, the first "
          f"captured) {secs['steps']:.2f} s = "
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
          + "; " + lpips_text(trainer)
          + "; affine-corrected (the same renders): "
          + ", ".join(f"{k} {corr[k]}" for k in ("affine_a", "affine_b", "psnr_corrected",
                                                 "ssim_corrected")))
    # one log line a window (each 16-step window crosses a multiple of 8)
    if not (len(hist) == steps // cfg.fuse_steps and np.isfinite(lf).all() and max(lf) > 0
            and np.isfinite([aux["loss"] for _, aux in hist]).all()):
        raise AssertionError(f"default path losses not finite or loss_frames never > 0: {hist}")
    if not all(np.isfinite(x) for x in (res.get("psnr", np.nan), res.get("ssim", np.nan),
                                        corr["psnr_corrected"], corr["ssim_corrected"])):
        raise AssertionError(f"evaluation gave no finite metrics: {res}, {corr}")
    return trainer, train


def lpips_text(trainer):
    """The last evaluation's LPIPS keys and seconds a view; raises unless
    both are finite."""
    import numpy as np
    res = trainer.last_eval
    keys = [k for k in res if k.startswith("lpips_")]
    if len(keys) != 2 or not np.isfinite([res[k] for k in keys]).all():
        raise AssertionError(f"evaluation without finite LPIPS: {res}")
    return (", ".join(f"{k} {res[k]:.6f}" for k in keys)
            + f" (LPIPS {trainer.lpips_seconds:.3f} s a view)")


def diagnostics_text(trainer):
    """What dump_run_diagnostics wrote at the start of train(); raises on a
    failure or a missing numeric image."""
    got = [p if p.startswith("(") else os.path.basename(p) for p in trainer.diagnostics]
    if any(p.startswith("(failed") for p in got) or not {
            "ev_accumulation.png", "ev_histogram.png"} <= set(got):
        raise AssertionError(f"run diagnostics incomplete: {trainer.diagnostics}")
    return f"run diagnostics in {trainer.diagnostics_seconds:.3f} s: {got}"


def phase_mesh(tag, trainer, check=False):
    """Trainer.save_mesh(256, 10.0) on the card: the density query, the
    extraction and the write timed apart, the mesh's size and the OBJ's
    bytes.  With `check`, the card's marching_tets on a 64^3 grid of the
    same field against the CPU's on the same u, at the threshold 10 and at
    the grid's median (many crossing cells): equal vertices and triangles;
    then the median mesh's OBJ write and, at scale, the card's extraction
    on a 256^3 grid of the field at its median, timed."""
    import torch
    from enerf_torch.models.field import field_density
    from enerf_torch.utils.mesh import extract_fields, marching_tets, to_world, write_obj

    path = trainer.save_mesh(resolution=256, threshold=10.0)
    (V, T), secs = trainer.mesh_size, trainer.mesh_seconds
    print(f"[{tag}] save_mesh(256, 10.0): density query of 16,777,216 points "
          f"{secs['query']:.3f} s, extraction {secs['extract']:.3f} s, OBJ write "
          f"{secs['write']:.3f} s; {V} vertices, {T} triangles, "
          f"{os.path.basename(path)} {os.path.getsize(path)} bytes")
    if not path.endswith(f"_ep{trainer.epoch:04d}.obj"):
        raise AssertionError(f"mesh written to {path}")
    if not check:
        return
    b = trainer.static.bound
    with torch.no_grad():
        u = extract_fields([-b] * 3, [b] * 3, 64, lambda p: field_density(
            trainer.state.ema_params, trainer.static, p)[0], device=trainer.device)
    for thr in (10.0, float(u.median())):
        torch.cuda.synchronize()
        t0 = time.time()
        vc, tc = marching_tets(u, thr)
        torch.cuda.synchronize()
        card_s = time.time() - t0
        t0 = time.time()
        vh, th = marching_tets(u.cpu(), thr)
        cpu_s = time.time() - t0
        same = torch.equal(vc.cpu(), vh) and torch.equal(tc.cpu(), th)
        print(f"[{tag}] marching_tets 64^3 at threshold {thr:.6g}: card {card_s:.3f} s, CPU "
              f"{cpu_s:.3f} s, {len(vh)} vertices / {len(th)} triangles; the card's mesh "
              f"{'equals' if same else 'DIFFERS FROM'} the CPU's")
        if not same:
            raise AssertionError("the card's marching_tets differs from the CPU's")
    # the writer at scale: the last (median) mesh as OBJ
    t0 = time.time()
    obj = os.path.join(trainer.workspace, "meshes", "median_64.obj")
    write_obj(obj, to_world(vh, [-b] * 3, [b] * 3, 64), th)
    print(f"[{tag}] write_obj of that mesh: {time.time() - t0:.3f} s, {os.path.getsize(obj)} bytes")
    # the extraction at scale: a 256^3 grid of the same field at its median
    with torch.no_grad():
        u = extract_fields([-b] * 3, [b] * 3, 256, lambda p: field_density(
            trainer.state.ema_params, trainer.static, p)[0], device=trainer.device)
    thr = float(u.median())
    torch.cuda.synchronize()
    t0 = time.time()
    v, t = marching_tets(u, thr)
    torch.cuda.synchronize()
    print(f"[{tag}] marching_tets 256^3 at the grid's median {thr:.6g} on the card: "
          f"{time.time() - t0:.3f} s, {len(v)} vertices / {len(t)} triangles")
    if not (len(t) and torch.isfinite(v).all()):
        raise AssertionError("no finite mesh at the median of the 256^3 grid")


def phase_lpips():
    """One 720 x 1280 RGB pair through LPIPS alex and vgg on the card, as
    the evaluation runs it (cuDNN's TF32 off for the call), and on the CPU:
    the card within relative 1e-3 of the CPU (cuDNN chooses its own
    convolution algorithms and summation orders).  Beside it, the card with
    TF32 on, the deviation that made the call turn it off."""
    import contextlib
    from unittest import mock
    import numpy as np
    import torch
    from enerf_torch.train import lpips as L

    rng = np.random.default_rng(0)
    a = rng.uniform(size=(720, 1280, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    out = {}
    for net in ("alex", "vgg"):
        L.lpips_distance(a, b, net, "cuda")  # weights to the card, cuDNN's setup
        torch.cuda.synchronize()
        t0 = time.time()
        card = L.lpips_distance(a, b, net, "cuda")
        card_ms = (time.time() - t0) * 1e3
        t0 = time.time()
        cpu = L.lpips_distance(a, b, net, "cpu")
        cpu_s = time.time() - t0
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            with mock.patch.object(L, "_no_tf32", contextlib.nullcontext):
                tf32 = L.lpips_distance(a, b, net, "cuda")
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        rel, rel_tf32 = abs(card - cpu) / cpu, abs(tf32 - cpu) / cpu
        out[net] = rel
        print(f"[lpips] {net} 720x1280 pair: card {card:.8f} in {card_ms:.1f} ms (host copies "
              f"included), CPU {cpu:.8f} in {cpu_s:.2f} s: relative difference {rel:.3e} "
              f"(tolerance 1e-3); with TF32 on the card {tf32:.8f}, {rel_tf32:.3e}")
        if not rel <= 1e-3:
            raise AssertionError(f"LPIPS {net} on the card {card} vs the CPU {cpu}")
    return out


def phase_viewer(trainer, train, workspace):
    """The --gui viewer on phase 9's trainer: GUIRenderer.train_steps(16),
    4 progressive frames, the HTTP server on an ephemeral port (GET /frame
    decodes to a PNG of the frame's shape, GET /orbit moves the camera),
    TurntableRecorder's 3 frames; K1 launches counted."""
    import threading
    import urllib.request
    import numpy as np
    from enerf_torch import viewer
    from enerf_torch.ops import fused_mlp
    from enerf_torch.utils.png import decode_png

    cfg = trainer.cfg
    fused_mlp.fused_field_head.launches = 0
    gui = viewer.GUIRenderer(trainer, train, W=cfg.W, H=cfg.H, radius=cfg.radius,
                             fovy=cfg.fovy, max_spp=cfg.max_spp)
    t0 = trainer._clock()
    loss = gui.train_steps(16)
    train_s = trainer._clock() - t0
    frames = []
    for _ in range(4):
        t0 = trainer._clock()
        img = gui.render_frame()
        frames.append((trainer._clock() - t0, gui.spp, gui.downscale))
    print(f"[viewer] train_steps(16) {train_s:.3f} s (mean loss {loss:.5f}); 4 frames of "
          f"{img.shape}: " + ", ".join(f"{t * 1e3:.1f} ms spp {n} downscale {d:.3f}"
                                       for t, n, d in frames))
    if not (np.isfinite(loss) and [n for _, n, _ in frames] == [1, 2, 3, 4]
            and np.isfinite(img).all()):
        raise AssertionError(f"viewer frames: loss {loss}, {frames}")
    server = viewer.make_viewer_server(gui, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        t0 = time.time()
        with urllib.request.urlopen(base + "/frame", timeout=300) as r:
            png = decode_png(r.read())
        frame_s = time.time() - t0
        shape = gui._accum.shape[:2]  # the frame the server rendered
        pose = gui.cam.pose
        with urllib.request.urlopen(base + "/orbit?dx=16&dy=4&dz=1", timeout=60) as r:
            status = r.status
        moved = not np.allclose(gui.cam.pose, pose)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    print(f"[viewer] server on port {server.server_address[1]}: GET /frame (16 steps + a frame) "
          f"{frame_s:.3f} s, a PNG of {png.shape}; GET /orbit {status}, pose "
          f"{'moved' if moved else 'UNCHANGED'}")
    if png.shape[:2] != shape or not moved or thread.is_alive():
        raise AssertionError(f"viewer server: PNG {png.shape} for a {shape} frame, "
                             f"moved {moved}, server thread alive {thread.is_alive()}")
    t0 = time.time()
    out = viewer.TurntableRecorder(trainer, W=cfg.W, H=cfg.H, radius=cfg.radius,
                                   fovy=cfg.fovy).record(os.path.join(workspace, "turntable"), 3)
    names = sorted(os.listdir(out))
    k1 = fused_mlp.fused_field_head.launches
    print(f"[viewer] TurntableRecorder 3 frames in {time.time() - t0:.3f} s: {names}; K1 "
          f"launches on the viewer path {k1} (the default path has no fused head)")
    if names != ["0000.png", "0001.png", "0002.png"]:
        raise AssertionError(f"turntable frames {names}")
    return k1


def phase_cli(workspace):
    """The two command lines on phase 9's checkpoint: python -m enerf_torch
    ... --test (the test render and the 256^3 mesh, in its own workspace),
    and python -m enerf_torch.tools.render --model_dir <phase 9's
    workspace> --traj val --n_poses 2."""
    import glob as _glob
    env = dict(os.environ, PYTHONPATH=REPO)
    ckpt = sorted(_glob.glob(os.path.join(workspace, "checkpoints", "*_ep0001.npz")))
    out_root = workspace + "_cli"
    runs = {
        "test": [sys.executable, "-m", "enerf_torch", "--config",
                 os.path.join(REPO, "configs", "synthetic_demo.txt"), "--event_only", "0",
                 "--seed", "0", "--val_idxs", "0", "--val_idxs", "20", "--outdir", out_root,
                 "--ckpt", ckpt[0] if ckpt else "missing", "--test"],
        "render": [sys.executable, "-m", "enerf_torch.tools.render", "--model_dir", workspace,
                   "--traj", "val", "--n_poses", "2"],
    }
    for name, argv in runs.items():
        t0 = time.time()
        out = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=600)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:])
            raise AssertionError(f"{' '.join(argv[1:4])} ... exited {out.returncode}")
        keep = [ln for ln in out.stdout.splitlines()
                if ln.startswith(("[ckpt]", "[test]", "[mesh]", "wrote"))]
        print(f"[cli] {' '.join(argv[1:3])} ... {argv[-1]}: exit 0 in {time.time() - t0:.1f} s; "
              + " | ".join(keep))
    ws = os.path.join(out_root, "testweek", "synthetic_demo")
    want = [os.path.join(ws, "results", "0000.png"),
            os.path.join(ws, "meshes", "synthetic_demo_ep0001.obj")]
    want += [os.path.join(workspace, "renders", f"000{i}{s}") for i in (0, 1)
             for s in (".png", "_depth.png", "_raw.npy")]
    missing = [p for p in want if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"the command lines did not write {missing}")


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
    (no K1), steps 4-7 on the march (K1 once per render, 3 renders; M1 once
    for the event pair, once for the frame render)."""
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
    march_rays.host_syncs = march_rays.launches = 0
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
          f"K1 launches {launches} (3 renders x 4 march steps = 12), M1 launches "
          f"{march_rays.launches} (2 marches x 4 = 8); march host syncs {march_rays.host_syncs}")
    if not (len(lf) == 8 and np.isfinite(lf).all()):
        raise AssertionError(f"loss_frames not finite at every step: {lf}")
    # the march shows in M1's launches (the plain version's host syncs did,
    # before the march was a kernel)
    if launches != 12 or march_rays.launches != 8 or march_rays.host_syncs:
        raise AssertionError(f"expected 4 warm steps without K1 and M1 and 4 march steps with "
                             f"them: K1 launches {launches}, M1 launches "
                             f"{march_rays.launches}, host syncs {march_rays.host_syncs}")
    if not (0.0 < untrained == one_cam < 1.0):
        raise AssertionError(f"the trainer marked {untrained} of the cells untrained, "
                             f"a direct mark_untrained_grid call {one_cam}")


ESIM_H, ESIM_W = 480, 640  # the published esim configs' frame size
ESIM_FRAMES = 6  # frames are data scale: a train and a val index need 3


def paeth_png(img8):
    """8-bit gray PNG bytes of img8 with the Paeth filter on every row: the
    reader's slowest case (byte-serial), as libpng's adaptive filters may
    choose it on real frames."""
    import numpy as np
    from enerf_torch.utils import png
    a = img8.astype(np.int16)
    left = np.pad(a, ((0, 0), (1, 0)))[:, :-1]
    up = np.pad(a, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(a, ((1, 0), (1, 0)))[:-1, :-1]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = np.concatenate([np.full((a.shape[0], 1), 4), (a - pred) % 256], axis=1)
    header = struct.pack(">IIBBBBB", a.shape[1], a.shape[0], 8, 0, 0, 0, 0)
    return (png._SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes()))
            + png._chunk(b"IEND", b""))


def phase_esim_fixture(root):
    """A 480 x 640 esim directory from the port's writer; the PNGs read back
    bit-equal.  Returns (datadir, the same directory as ShakeCarpet1, the
    simulation), the second name selecting the scene's pose offset."""
    import numpy as np
    from enerf_torch.data import provider, synthetic
    from enerf_torch.utils import png

    shutil.rmtree(root, ignore_errors=True)
    datadir = os.path.join(root, "spiral1")
    t0 = time.time()
    data = synthetic.simulate_events(H=ESIM_H, W=ESIM_W, n_frames=ESIM_FRAMES,
                                     workers=ESIM_FRAMES)
    t_sim = time.time() - t0
    provider.save_esim_dataset(data, datadir, scale=0.3)
    clean = [(np.clip(f[..., 0], 0, 1) * 255).astype(np.uint8) for f in data["frames"]]
    rng = np.random.default_rng(0)
    corrupted = [np.clip(im + rng.normal(0, 12.0, im.shape), 0, 255).astype(np.uint8)
                 for im in clean]
    os.makedirs(os.path.join(datadir, "images_corrupted"))
    for i, im in enumerate(corrupted):
        png.write_png(os.path.join(datadir, "images_corrupted", f"{i:06d}.png"), im)
    written = clean + corrupted
    os.symlink("spiral1", os.path.join(root, "ShakeCarpet1"))
    secs = time.time() - t0
    paths = [os.path.join(datadir, sub, f"{i:06d}.png")
             for sub in ("images", "images_corrupted") for i in range(ESIM_FRAMES)]
    t0 = time.time()
    back = [png.read_png(p) for p in paths]
    t_dec = time.time() - t0
    same = all(b.dtype == np.uint8 and np.array_equal(b, w) for b, w in zip(back, written))
    mb = sum(b.nbytes for b in back) / 1e6
    blob = paeth_png(written[0])
    t0 = time.time()
    paeth = png.decode_png(blob)
    t_paeth = time.time() - t0
    same = same and np.array_equal(paeth, written[0])
    print(f"[esim] fixture {data['H']}x{data['W']}, {ESIM_FRAMES} frames, "
          f"{len(data['events'])} events: {secs:.2f} s ({t_sim:.2f} s simulating in "
          f"{ESIM_FRAMES} processes); read back {len(back)} PNGs "
          f"{'bit-equal' if same else 'DIFFERENT'} to the uint8 written: {mb:.2f} MB of pixels "
          f"in {t_dec:.3f} s = {mb / t_dec:.1f} MB/s (filter 0 rows); one frame with Paeth on "
          f"every row {written[0].nbytes / 1e6 / t_paeth:.2f} MB/s ({t_paeth:.3f} s)")
    if not same:
        raise AssertionError("the port's PNG reader did not give back the frames written")
    return datadir, os.path.join(root, "ShakeCarpet1"), data


def esim_config(config, datadir, workspace, *extra):
    """A published esim config as published, on the fixture, with one val
    index and evaluation after the (one) epoch."""
    from enerf_torch.config import build_config
    return build_config([
        "--config", os.path.join(REPO, "configs", config), "--datadir", datadir,
        "--outdir", workspace, "--val_idxs", "1", "--eval_interval", "1", "--log_every", "1",
        *extra])


def esim_run(cfg, workspace, steps, evaluate, providers=None, epochs=1):
    """`epochs` epochs of `steps` steps through the entry points of
    `python -m enerf_torch` on the card: (trainer, (train, val) providers,
    data load seconds, peak memory GiB).  `providers` reuses a built pair;
    the trainer's `view_seconds` lists (H, W, seconds) of each rendered
    view."""
    import torch
    from enerf_torch.__main__ import get_select_frames
    from enerf_torch.data.provider import make_providers
    from enerf_torch.train.trainer import Trainer

    trainer = Trainer(cfg, workspace=workspace)
    render, trainer.view_seconds = trainer.render_view, []

    def timed_render(pose, intrinsics, H, W):
        torch.cuda.synchronize()
        t0 = time.time()
        out = render(pose, intrinsics, H, W)
        torch.cuda.synchronize()
        trainer.view_seconds.append((H, W, time.time() - t0))
        return out

    trainer.render_view = timed_render
    t0 = time.time()
    train, val = providers or make_providers(cfg, get_select_frames(cfg))
    load = time.time() - t0
    train.steps_per_epoch = steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train(train, val if evaluate else None, max_epoch=epochs)
    torch.cuda.synchronize()
    # reserved: a window's captured graph holds its private pool there
    trainer.peak_reserved_gib = torch.cuda.max_memory_reserved() / 2**30
    return trainer, (train, val), load, torch.cuda.max_memory_allocated() / 2**30


REMAT = ("with --remat_fixed 1", ("--remat_fixed", "1"))


def run_as_published(tag, name, make_cfg, workspace, steps, evaluate, providers=None,
                     fallbacks=(REMAT,), epochs=1):
    """esim_run of a published config as published; if it does not fit
    the card, the OutOfMemoryError is printed as its result and the run
    repeats with each of `fallbacks` (label, extra flags) in turn, until one
    fits.  Returns (label, cfg, esim_run's tuple)."""
    import torch
    for i, (label, extra) in enumerate((("as published", ()),) + tuple(fallbacks)):
        cfg = make_cfg(*extra)
        try:
            return label, cfg, esim_run(cfg, workspace, steps, evaluate, providers, epochs)
        except torch.OutOfMemoryError as e:
            if i == len(fallbacks):
                raise
            print(f"[{tag}] {name} {label}: torch.OutOfMemoryError at "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated: "
                  f"{str(e).splitlines()[0]}")
        gc.collect()  # the failed run's tensors went with the exception
        torch.cuda.empty_cache()


def esim_shape_line(trainer, train, cfg):
    meta, ss = trainer.static.grid_meta, trainer.ss
    rays = train.num_rays  # the frame render; with events the pair's two renders too,
    if cfg.events:  # and the no-event pair's
        rays = (2 * train.batch_size_evs + (train.num_rays if train.frames is not None else 0)
                + (2 * (train.batch_size_evs // 2) if train.noev_coords is not None else 0))
    return (f"{trainer.static.encoding} {meta.num_levels}x{meta.level_dim}, "
            f"2^{meta.log2_hashmap_size}, {trainer.static.compute_dtype}, {train.H}x{train.W}, "
            f"{rays} rays x {ss.num_steps} steps = {rays * ss.num_steps} samples a step, "
            f"remat_fixed {ss.remat_fixed}")


def window_epochs(tag, trainer, steps):
    """The steps/s of a run of two `steps`-step epochs in windows: the
    first captures the window's step, the second replays the graph kept
    across the epochs (one capture in the run)."""
    secs = [trainer.seconds_by_epoch[e]["steps"] for e in (1, 2)]
    captures = sum(c.captures for c in trainer._chunk_cache.values())
    print(f"[{tag}] in windows: epoch 1 (the capture) {secs[0]:.3f} s = "
          f"{steps / secs[0]:.4f} steps/s, epoch 2 (replays of the graph kept across the "
          f"epochs) {secs[1]:.3f} s = {steps / secs[1]:.4f} steps/s; {captures} capture(s)")
    if captures != 1:
        raise AssertionError(f"{tag}: {captures} captures in two epochs, 1 expected")
    return steps / secs[0], steps / secs[1]


def phase_esim_frames(datadir, workspace):
    """configs/spiral1/spiral1_nerf.txt as published (frames mode, hash
    grid, 480 x 640, 30,096 rays x 512 steps) on the fixture: two 16-step
    epochs, one graphed window each (fuse_steps 16, the default; captured
    in the first, replayed in the second), a checkpoint each and the
    evaluation of one view after the second."""
    import numpy as np
    import torch

    steps = 16
    print(f"[esim-frames] held before the phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")

    def make_cfg(ws, *extra):
        return esim_config("spiral1/spiral1_nerf.txt", datadir, ws, "--iters", str(2 * steps),
                           "--eval_interval", "2", *extra)

    cfg = make_cfg(workspace)
    trainer, (train, _), load, peak = esim_run(cfg, workspace, steps, evaluate=True,
                                                 epochs=2)
    secs, res = trainer.epoch_seconds, trainer.last_eval
    losses = [aux["loss"] for _, aux in trainer.history]
    print(f"[esim-frames] spiral1_nerf: {esim_shape_line(trainer, train, cfg)}; "
          f"{train.images.shape[0]} train frames, data loaded in {load:.2f} s")
    first, replay = window_epochs("esim-frames", trainer, steps)
    print(f"[esim-frames] peak memory {peak:.2f} GiB allocated, {trainer.peak_reserved_gib:.2f} "
          f"GiB reserved (the graph's pool); checkpoint {secs.get('checkpoint', float('nan')):.3f} "
          f"s; evaluation of one {train.H}x{train.W} view {secs.get('evaluate', float('nan')):.3f} "
          f"s; psnr {res.get('psnr')} ssim {res.get('ssim')}; {lpips_text(trainer)}; window mean "
          f"losses " + ", ".join(f"{x:.5f}" for x in losses))
    if not (len(losses) == 2 and np.isfinite(losses).all() and trainer.state.step == 2 * steps):
        raise AssertionError(f"spiral1_nerf: step {trainer.state.step}, losses {losses}")
    if not np.isfinite(res.get("psnr", np.nan)):
        raise AssertionError(f"spiral1_nerf evaluation gave no finite psnr: {res}")
    phase_frames_breakdown(trainer, train)
    phase_mesh("esim-frames", trainer)
    return dict(steps_s=first, replay_steps_s=replay, peak_gib=peak,
                peak_reserved_gib=trainer.peak_reserved_gib)


def phase_frames_breakdown(trainer, train):
    """One graphed frames-mode step split into its phases by the span
    registry (utils/profiling.py): the device ms of each `step.*` span and
    of the encode, from the marks the captured step records at each
    replay; no synchronize inside the step."""
    from enerf_torch.utils import profiling

    chunk = trainer._chunk(train, trainer.cfg.fuse_steps, trainer.state.step)
    args = (trainer.state, trainer.occupancy, train, trainer.generator, trainer.rank_generator)
    chunk(*args, steps=1, update=False)  # the eager first step and the capture
    profiling.reset()
    chunk(*args, steps=1, update=False)  # one replay
    spans = profiling.snapshot()["spans"]
    trainer._release_windows()

    def ms(path):
        s = spans.get(path)
        return 1e3 * s["device_s"] if s and s["graphed"] == 1 and s["device_s"] else None

    parts = {p: ms(p) for p in ("step", "step/step.batch", "step/step.forward",
                                "step/step.forward/encode.fwd", "step/step.backward",
                                "step/step.backward/encode.bwd", "step/step.optim")}
    print("[breakdown] frames mode at the published width, one graphed step, device ms "
          "(span marks): " + ", ".join(f"{p.rsplit('/', 1)[-1]} {v:.2f}" for p, v in parts.items()
                                        if v is not None)
          + f"; {train.num_rays * trainer.ss.num_steps} samples")
    if any(v is None for v in parts.values()):
        raise AssertionError(f"a span of the replayed step has no device time: {spans}")


def phase_esim_events(datadir, workspace):
    """configs/shakeCarpet1/shakeCarpet1_enerfBoth.txt (events + frames,
    images_corrupted) as published on the fixture, 8 steps; if it does not
    fit the card, the OutOfMemoryError is its result and the phase reruns
    with --remat_fixed 1."""
    import numpy as np

    steps = 8
    label, cfg, (trainer, (train, _), load, peak) = run_as_published(
        "esim-events", "shakeCarpet1_enerfBoth",
        lambda *extra: esim_config("shakeCarpet1/shakeCarpet1_enerfBoth.txt", datadir, workspace,
                                   "--iters", str(steps), *extra),
        workspace, steps, evaluate=False)
    secs, hist = trainer.epoch_seconds, trainer.history
    print(f"[esim-events] shakeCarpet1_enerfBoth {label}: {esim_shape_line(trainer, train, cfg)}; "
          f"{int(train.chains.xs.shape[0])} chained events, {train.frames.shape[0]} corrupted "
          f"train frames, data loaded in {load:.2f} s")
    print(f"[esim-events] {steps} steps {secs['steps']:.3f} s = "
          f"{steps / secs['steps']:.4f} steps/s (the first included); peak memory "
          f"{peak:.2f} GiB; losses " + ", ".join(
              f"{aux['loss']:.5f} (evs {aux['loss_evs']:.5f}, frames {aux['loss_frames']:.5f})"
              for _, aux in hist))
    terms = [[aux[k] for k in ("loss", "loss_evs", "loss_frames")] for _, aux in hist]
    if not (len(terms) == steps and np.isfinite(terms).all()):
        raise AssertionError(f"shakeCarpet1_enerfBoth losses not all finite: {hist}")


def phase_frames_march(workspace):
    """--ff -O --events 0 --error_map on the synthetic scene, 8 steps with
    the occupancy update before step 0: train_step_frames through the march
    and K1, the error map updated after each step."""
    import numpy as np
    import torch
    from enerf_torch.data.provider import make_providers
    from enerf_torch.ops import fused_mlp
    from enerf_torch.render.march import march_rays
    from enerf_torch.train.trainer import Trainer

    cfg = smoke_config(workspace, "--events", "0", "--event_only", "0", "--error_map",
                       "--log_every", "1", "--profile", "2")
    trainer = Trainer(cfg, workspace=workspace)
    train, _ = make_providers(cfg)
    train.steps_per_epoch = 8
    before = train.error_map.clone()
    fused_mlp.fused_field_head.launches = 0
    march_rays.host_syncs = 0
    t0 = time.time()
    trainer.train(train, max_epoch=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fused_mlp.fused_field_head.launches
    changed = int((train.error_map != before).sum())
    lf = [aux["loss_frames"] for _, aux in trainer.history]
    print(f"[frames-march] 8 steps in {wall:.2f} s (a checkpoint included), "
          f"{train.num_rays} rays a step: loss_frames per step {[f'{x:.4e}' for x in lf]}; "
          f"K1 launches {launches}; march host syncs {march_rays.host_syncs}; occupancy updates "
          f"{trainer.occupancy.iter_density}; error map cells changed {changed} of "
          f"{train.error_map.numel()}")
    if not (len(lf) == 8 and np.isfinite(lf).all()):
        raise AssertionError(f"frames-mode losses not finite at every step: {lf}")
    if launches == 0 or changed == 0 or trainer.occupancy.iter_density != 1:
        raise AssertionError(f"frames step on the march: K1 launches {launches}, error map "
                             f"cells changed {changed}, occupancy updates "
                             f"{trainer.occupancy.iter_density}")
    # --profile 2: the trainer traced steps 3-4 into <workspace>/profile/
    path = trainer.profile_path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + e.get("dur", 0)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
    print(f"[frames-march] --profile 2: {os.path.relpath(path, REPO)}, {os.path.getsize(path)} "
          f"bytes, {len(events)} events, {len(kernels)} distinct CUDA kernels; the longest "
          + "; ".join(f"{n[:60]} {us / 1e3:.2f} ms" for n, us in top))
    if not kernels:
        raise AssertionError(f"the --profile trace {path} names no CUDA kernel")
    return launches


TUMVIE_H, TUMVIE_W = 720, 1280  # the TUM-VIE event camera (the loader's H_ev, W_ev)
STEREO_TRAIN, STEREO_VAL = (0, 2, 4), (3,)  # the published splits' pattern, cut to 6 frames
EDS_T_OFFSET_US = 5_000_000


def phase_tumvie_fixture(root):
    """A 720 x 1280, 6-frame TUM-VIE directory from the port's writer; its
    H5 files read back by the port's reader equal to what was written."""
    import numpy as np
    from enerf_torch.data import h5events, synthetic, tumvie
    from enerf_torch.utils import hdf5

    shutil.rmtree(root, ignore_errors=True)
    datadir = os.path.join(root, "mocap-desk2")
    t0 = time.time()
    # a low threshold, so that pixels have >= 2 events inside one image's
    # window (the tumvie sampler draws within one window)
    data = synthetic.simulate_events(H=TUMVIE_H, W=TUMVIE_W, n_frames=ESIM_FRAMES, C=0.04,
                                     workers=ESIM_FRAMES)
    t_sim = time.time() - t0
    tumvie.save_tumvie_dataset(data, datadir, scale=0.5)  # the mocapDesk2 configs' scale
    secs = time.time() - t0
    ev = data["events"][np.argsort(data["events"][:, 2], kind="stable")]
    t_us = (ev[:, 2] * 1e6).astype(np.int64)
    written = {"events/x": ev[:, 0].astype(np.uint16), "events/y": ev[:, 1].astype(np.uint16),
               "events/t": t_us, "events/p": (ev[:, 3] > 0).astype(np.int8),
               "ms_to_idx": h5events.compute_ms_to_idx(t_us, tick_ns=1000)}
    rmap = np.stack(np.meshgrid(np.arange(TUMVIE_W), np.arange(TUMVIE_H), indexing="xy"), -1)
    same = []
    with hdf5.File(os.path.join(datadir, "events_left.h5")) as f:
        t0 = time.time()
        t_back = np.asarray(f["events/t"])
        t_read = time.time() - t0
        for k, a in written.items():
            b = np.asarray(f[k])
            same.append(b.dtype == a.dtype and np.array_equal(b, a))
        lo_us, hi_us = int(t_us[len(t_us) // 3]), int(t_us[len(t_us) // 2]) + 1
        window = h5events.EventSlicer(f).get_events(lo_us, hi_us)
    with hdf5.File(os.path.join(datadir, "rectify_map_left.h5")) as f:
        back = np.asarray(f["rectify_map"])
        same.append(back.dtype == np.float32 and np.array_equal(back, rmap.astype(np.float32)))
    mask = (t_us >= lo_us) & (t_us < hi_us)
    same_window = all(np.array_equal(window[k], written[f"events/{k}"][mask]) for k in "xytp")
    print(f"[tumvie] fixture {TUMVIE_H}x{TUMVIE_W}, {ESIM_FRAMES} frames, {len(ev)} events: "
          f"{secs:.2f} s ({t_sim:.2f} s simulating in {ESIM_FRAMES} processes); the port's HDF5 "
          f"reader gave back {sum(same)} of {len(same)} datasets equal to the arrays written "
          f"(events/x, y, t, p, ms_to_idx, rectify_map); t ({t_back.nbytes / 1e6:.2f} MB) read "
          f"in {t_read:.4f} s = {t_back.nbytes / 1e6 / t_read:.1f} MB/s; EventSlicer window "
          f"[{lo_us}, {hi_us}) us: {mask.sum()} events, "
          f"{'equal' if same_window else 'NOT equal'} to a numpy mask over the arrays written")
    if not (all(same) and same_window and mask.sum() > 0):
        raise AssertionError("the port's HDF5 reader did not give back the tumvie fixture")
    return datadir


def phase_eds_fixture(data, root):
    """An EDS directory from the port's writer, from phase 11's 480 x 640
    simulation (the eds configs' frame size), with a t_offset: named
    00_peanuts_dark, as eds11's datadir, which selects its pose offset."""
    from enerf_torch.data import eds

    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    datadir = eds.save_eds_dataset(data, os.path.join(root, "00_peanuts_dark"), scale=0.5,
                                   t_offset=EDS_T_OFFSET_US)
    print(f"[eds] fixture {data['H']}x{data['W']}, {len(data['frame_ts'])} frames, "
          f"{len(data['events'])} events, t_offset {EDS_T_OFFSET_US} us: written in "
          f"{time.time() - t0:.2f} s")
    return datadir


# TUM-VIE's event and frame cameras use the equidistant (Kannala-Brandt)
# model; coefficients of that order
FISHEYE_D = (0.0348, -0.0101, 0.0037, -0.0011)


def fisheye_distort(xy, intr, D):
    """The equidistant model forward: undistorted pixels [N, 2] -> distorted."""
    import numpy as np
    fx, fy, cx, cy = intr
    x, y = (xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy
    r = np.sqrt(x * x + y * y)
    th = np.arctan(r)
    thd = th * (1 + D[0] * th ** 2 + D[1] * th ** 4 + D[2] * th ** 6 + D[3] * th ** 8)
    s = np.where(r > 1e-12, thd / np.maximum(r, 1e-12), 1.0)
    return np.stack([x * s * fx + cx, y * s * fy + cy], -1)


def phase_prep(datadir):
    """Phase 15b: the fixture made raw (fisheye-distorted JPEG frames and
    event coordinates), then prepared by the port's undistortion tool and
    laid out as the TUM-VIE loader reads it."""
    import numpy as np
    from enerf_torch.data import h5events
    from enerf_torch.tools.undistort_images import build_maps
    from enerf_torch.utils import camera, hdf5, jpeg
    from enerf_torch.utils.png import read_png

    H, W = TUMVIE_H, TUMVIE_W
    imgdir = os.path.join(datadir, "left_images_undistorted")
    pngs = sorted(glob.glob(os.path.join(imgdir, "*.png")))
    calib_path = os.path.join(datadir, "calib_undist.json")
    with open(calib_path) as f:
        cal = json.load(f)
    c0 = cal["value0"]["intrinsics_undistorted"][0]
    intr = (c0["fx"], c0["fy"], c0["cx"], c0["cy"])
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1.0]])
    D = np.asarray(FISHEYE_D)
    # raw frames: dst(u_d) = clean(undistort(u_d)), JPEG at cv2's defaults
    grid = np.stack(np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32)),
                    -1).reshape(-1, 1, 2)
    und = camera.fisheye_undistort_points(grid, K, D, P=K).reshape(H, W, 2)
    rawdir = os.path.join(datadir, "images")
    os.makedirs(rawdir, exist_ok=True)
    clean = []
    for p in pngs:
        clean.append(read_png(p))
        raw = camera.remap_linear(clean[-1], und[..., 0], und[..., 1])
        jpeg.write_jpeg(os.path.join(rawdir, os.path.basename(p)[:-4] + ".jpg"), raw)
    # raw events: their coordinates distorted the same way, on the sensor
    with hdf5.File(os.path.join(datadir, "events_left.h5")) as f:
        ev = {k: np.asarray(f["events/" + k]) for k in "xytp"}
    dist = fisheye_distort(np.stack([ev["x"], ev["y"]], -1).astype(np.float64), intr, D)
    keep = ((dist[:, 0] >= 0) & (dist[:, 0] <= W - 1) & (dist[:, 1] >= 0)
            & (dist[:, 1] <= H - 1))
    dist = np.floor(dist[keep])
    h5events.write_event_h5(os.path.join(datadir, "events_left.h5"), dist[:, 0], dist[:, 1],
                            ev["t"][keep], ev["p"][keep], grouped=True)
    with open(os.path.join(datadir, "calibration.json"), "w") as f:
        json.dump({"intrinsics": [{"fx": intr[0], "fy": intr[1], "cx": intr[2],
                                   "cy": intr[3], **dict(zip(("k1", "k2", "k3", "k4"),
                                                             FISHEYE_D))}]}, f)
    # the tool, as a user runs it
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "enerf_torch.tools.undistort_images", "--datadir", datadir,
         "--calib", os.path.join(datadir, "calibration.json"), "--cam", "0", "--model",
         "fisheye", "--img_glob", "images/*.jpg", "--out_suffix", "left"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    tool_s = time.time() - t0
    if out.returncode != 0:
        raise AssertionError(f"undistort_images failed:\n{out.stderr[-3000:]}")
    with open(os.path.join(datadir, "calib_undist_left.json")) as f:
        knew = json.load(f)["intrinsics_undistorted"][0]
    rmap = h5events.load_rectify_map(os.path.join(datadir, "rectify_map_left.h5"))
    # the loader's layout: the tool's JPEG frames and Knew for every camera
    for p in pngs:
        os.remove(p)
    prepared = sorted(glob.glob(os.path.join(datadir, "images_undistorted_left", "*.jpg")))
    for p in prepared:
        shutil.copy(p, imgdir)
    for ci in range(4):
        cal["value0"]["intrinsics_undistorted"][ci] = {k: knew[k] for k in ("fx", "fy", "cx",
                                                                         "cy")}
    with open(calib_path, "w") as f:
        json.dump(cal, f)

    # the pieces timed in this process on the same frames
    t0 = time.time()
    m1, m2, Knew, rmap_here = build_maps(
        {"fx": intr[0], "fy": intr[1], "cx": intr[2], "cy": intr[3],
         **dict(zip(("k1", "k2", "k3", "k4"), FISHEYE_D))}, H, W, "fisheye")
    map_s = time.time() - t0
    gray_raw = [jpeg.read_jpeg(p) for p in sorted(glob.glob(os.path.join(rawdir, "*.jpg")))]
    remap_ms, same = [], []
    for raw, p in zip(gray_raw, prepared):
        t0 = time.perf_counter()
        und_img = camera.remap_linear(raw, m1, m2)
        remap_ms.append(1e3 * (time.perf_counter() - t0))
        same.append(np.array_equal(jpeg.decode_jpeg(jpeg.encode_jpeg(und_img)),
                                   jpeg.read_jpeg(p)))
    # the undistorted frame against the clean one seen through Knew: pixel
    # p of the prepared frame is the clean frame's K @ inv(Knew) @ p
    kx, ky = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    back_x = ((kx - knew["cx"]) / knew["fx"] * intr[0] + intr[2]).astype(np.float32)
    back_y = ((ky - knew["cy"]) / knew["fy"] * intr[1] + intr[3]).astype(np.float32)
    inner = (slice(H // 4, 3 * H // 4), slice(W // 4, 3 * W // 4))
    psnrs = []
    for c, p in zip(clean, prepared):
        want = camera.remap_linear(c, back_x, back_y)[inner].astype(np.float64)
        mse = np.mean((jpeg.read_jpeg(p)[inner].astype(np.float64) - want) ** 2)
        psnrs.append(float(10 * np.log10(255.0 ** 2 / max(mse, 1e-10))))
    # codec times on this host: the fixture's rendered frame (smooth) and
    # textured frames, whose entropy is nearer a camera's: 720 x 1280
    # colour, and 1024 x 1024 gray (TUM-VIE's frame cameras)
    g = clean[0]
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:1024, :1280]
    tex = 128 + 60 * np.sin(xx / 17.0) * np.cos(yy / 13.0)
    tex = np.clip(tex[..., None] + rng.normal(0, 8, (1024, 1280, 3)), 0, 255).astype(np.uint8)
    cases = {"rendered colour 4:2:0 q95 720x1280": np.stack([g, np.roll(g, 7, axis=1), 255 - g],
                                                            -1),
             "rendered gray q95 720x1280": g,
             "textured colour 4:2:0 q95 720x1280": tex[:H],
             "textured gray q95 1024x1024": np.ascontiguousarray(tex[:, :1024, 1])}
    times = {}
    for name, img in cases.items():
        t0 = time.perf_counter()
        data = jpeg.encode_jpeg(img)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = jpeg.decode_jpeg(data)
        t_dec = time.perf_counter() - t0
        times[name] = (1e3 * t_dec, 1e3 * t_enc, len(data), back.shape)
    sentinel = float((rmap == camera.FISHEYE_SENTINEL).all(-1).mean())
    print(f"[prep] raw fixture: {len(pngs)} fisheye-distorted {H}x{W} JPEG frames (D "
          f"{list(FISHEYE_D)}), {int(keep.sum())} of {len(keep)} events on the sensor after "
          f"distortion; enerf_torch.tools.undistort_images --model fisheye: {tool_s:.2f} s with "
          f"its start (a new process); Knew fx {knew['fx']:.4f} fy {knew['fy']:.4f} cx "
          f"{knew['cx']:.4f} cy {knew['cy']:.4f} (K fx {intr[0]:.4f}); rectify map "
          f"{list(rmap.shape)} {rmap.dtype}, sentinel share {sentinel:.6f}, max |map - "
          f"this process's| {float(np.abs(rmap - rmap_here).max()):.3e}; the tool's frames equal "
          f"this process's remap + encode: {sum(same)} of {len(same)}; their inner half against "
          f"the clean frames seen through Knew: PSNR {[round(x, 2) for x in psnrs]} dB (min 30)")
    print(f"[prep] on this host: map build (fisheye maps + the rectify map's Newton solve at "
          f"{H}x{W}) {map_s:.3f} s; remap {np.mean(remap_ms):.2f} ms a frame (gray, "
          f"{[round(x, 2) for x in remap_ms]}); "
          + "; ".join(f"{k}: decode {d:.2f} ms, encode {e:.2f} ms a frame ({n} bytes)"
                      for k, (d, e, n, _) in times.items()))
    if not (all(same) and len(prepared) == len(pngs) == ESIM_FRAMES
            and rmap.shape == (H, W, 2) and np.isfinite(rmap).all()
            and float(np.abs(rmap - rmap_here).max()) == 0.0 and min(psnrs) > 30
            and all(t[3] == cases[k].shape for k, t in times.items())):
        raise AssertionError("[prep] the prepared directory is not what the tool should give")
    return dict(tool_s=tool_s, map_s=map_s, remap_ms=float(np.mean(remap_ms)),
                codec_ms={k: v[:2] for k, v in times.items()})


MAIN_E1 = {}      # E1's (sort, group tables) launches on the main path, its max abs err there
LOAD_SPLITS = {}  # phase 16 / 17's load split
E1_W, E1_H, E1_FRAMES = 1280, 720, 19  # TUM-VIE's event camera, mocapDesk2's 19 train frames
CHAIN_FIELDS = ("xs", "ys", "ts", "pols", "cum_pols", "num_successors", "group_offset",
                "group_count", "frame_bounds", "pixel_bounds")


def reset_e1():
    from enerf_torch.data import native_events
    native_events.sort_events_by_pixel.launches = native_events.group_tables.launches = 0


def e1_launches():
    from enerf_torch.data import native_events
    return [native_events.sort_events_by_pixel.launches, native_events.group_tables.launches]


def as_np(x):
    import numpy as np
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def max_abs_diff(a, b):
    """The largest |a - b| over two arrays (inf when their shapes differ)."""
    import numpy as np
    a, b = as_np(a), as_np(b)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.size else 0.0


def record_chain_builds():
    """Record the provider's build_event_chains calls until the returned
    function is called; it restores the provider and returns [(args,
    chains, sorted times)]."""
    from enerf_torch.data import provider
    real, calls = provider.build_event_chains, []

    def recording(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, *out))
        return out

    provider.build_event_chains = recording

    def done():
        provider.build_event_chains = real
        return calls
    return done


def e1_check_build(args, chains, ts_sorted):
    """Chains the card built (through E1) against the plain build of the
    same events, every field bit for bit; returns the max abs difference."""
    import numpy as np
    from enerf_torch.data import events
    ref, ref_ts = events.build_event_chains(*args[:3], device="cpu")
    diffs = {k: max_abs_diff(getattr(chains, k), getattr(ref, k)) for k in CHAIN_FIELDS}
    diffs["sorted times"] = max_abs_diff(ts_sorted, ref_ts)
    bad = [k for k in CHAIN_FIELDS if not np.array_equal(as_np(getattr(chains, k)),
                                                          as_np(getattr(ref, k)))]
    bad += ["sorted times"] if not np.array_equal(ts_sorted, ref_ts) else []
    if bad:
        raise AssertionError(f"E1's chains differ from the plain version's in {bad}: {diffs}")
    return max(diffs.values())


def e1_compare(tag, ev, fids, n_frames):
    """E1 against its plain version on one set of events: the sort, the
    group tables and build_event_chains, every field bit for bit.  Returns
    (seconds of build_event_chains on the card, of the plain version, ms of
    the plain sort, the max abs difference over every field compared)."""
    import numpy as np
    import torch
    from enerf_torch.data import events, native_events as ne

    if fids is None:
        fids, n_frames = np.zeros(len(ev), np.int64), 1
    W, H = int(ev[:, 0].max()) + 2, int(ev[:, 1].max()) + 2
    cols = [np.ascontiguousarray(a) for a in (ev[:, 0], ev[:, 1], ev[:, 2], fids)]
    got = ne.sort_events_by_pixel(*(torch.as_tensor(a, device="cuda") for a in cols), W, H)
    t0 = time.time()
    ref = ne.sort_events_by_pixel(*(torch.as_tensor(a) for a in cols), W, H)
    plain_ms = (time.time() - t0) * 1e3
    pairs = list(zip(("order", "group_id"), got, ref))
    pairs += zip(("counts", "offsets", "num_succ"), ne.group_tables(got[1], got[2]),
                 ne.group_tables(ref[1], ref[2]))
    bad = [k for k, a, b in pairs if not np.array_equal(as_np(a), as_np(b))]
    bad += ["n_groups"] if got[2] != ref[2] else []
    err = max([max_abs_diff(a, b) for _, a, b in pairs] + [abs(got[2] - ref[2])])
    torch.cuda.synchronize()
    t0 = time.time()
    ck, tk = events.build_event_chains(ev, fids, n_frames, device="cuda")
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    cp, tp = events.build_event_chains(ev, fids, n_frames, device="cpu")
    t_plain = time.time() - t0
    bad += [k for k in CHAIN_FIELDS if not np.array_equal(as_np(getattr(ck, k)),
                                                           as_np(getattr(cp, k)))]
    bad += ["sorted times"] if not np.array_equal(tk, tp) else []
    err = max([err, max_abs_diff(tk, tp)]
              + [max_abs_diff(getattr(ck, k), getattr(cp, k)) for k in CHAIN_FIELDS])
    pix = (ev[:, 1].astype(np.float32).astype(np.int64) * W
           + ev[:, 0].astype(np.float32).astype(np.int64))
    print(f"[chains] {tag}: {len(ev)} events in {n_frames} window(s), {got[2]} groups, "
          f"{int(ck.xs.shape[0])} chained; {int((pix < 0).sum())} events below pixel 0, "
          f"{int((ev[:, :2] % 1 != 0).any(1).sum())} with fractional coordinates; E1 "
          + ("bit-equal to the plain version on the sort, the group tables and every field"
             if not bad else f"DIFFERS from the plain version in {bad}")
          + f" (max abs err {err}); build_event_chains {t_card:.3f} s on the card, "
          f"{t_plain:.3f} s plain")
    if bad:
        raise AssertionError(f"E1 differs from its plain version on {tag}: {bad}")
    return t_card, t_plain, plain_ms, err


def synthetic_events(n, seed, shuffled=False):
    """n events at 1280 x 720 in 19 windows: sorted times (ns over 10 s),
    10% of the coordinates fractional (some that float32 rounds up to the
    next pixel), one hot pixel of 10^4 events at times on a 1 ms grid
    (equal times there); shuffled: the rows permuted."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ev = np.empty((n, 4))
    ev[:, 0] = rng.integers(0, E1_W - 1, n)
    ev[:, 1] = rng.integers(0, E1_H - 1, n)
    ev[:, 2] = rng.uniform(0, 1e10, n)
    ev[:, 3] = rng.choice([-1.0, 1.0], n)
    frac = rng.random(n) < 0.1
    ev[frac, 0] += rng.choice([0.25, 0.5, 0.99999999, 1 - 1e-12], int(frac.sum()))
    ev[frac, 1] += rng.choice([0.5, 0.999999999], int(frac.sum()))
    hot = rng.choice(n, 10_000, replace=False)
    ev[hot, 0], ev[hot, 1] = 640.0, 360.0
    ev[hot, 2] = np.round(ev[hot, 2] / 1e6) * 1e6
    ev = ev[np.argsort(ev[:, 2], kind="stable")]
    fids = np.minimum((ev[:, 2] / 1e10 * E1_FRAMES).astype(np.int64), E1_FRAMES - 1)
    if shuffled:
        p = rng.permutation(n)
        ev, fids = ev[p], fids[p]
    return ev, fids


def e1_timing(n):
    """E1 at n card-made events (1280 x 720, 19 windows, sorted times): its
    own checks, its ms and split, torch.argsort(stable=True)'s ms on the
    composite keys, the bound, and build_event_chains end to end."""
    import numpy as np
    import torch
    from enerf_torch.data import events, native_events as ne

    g = torch.Generator(device="cuda").manual_seed(n % 1000 + 1)
    xs = torch.randint(0, E1_W, (n,), device="cuda", generator=g).float()
    ys = torch.randint(0, E1_H, (n,), device="cuda", generator=g).float()
    ts = torch.sort(torch.rand(n, device="cuda", generator=g, dtype=torch.float64))[0]
    fids = (ts * E1_FRAMES).clamp(max=E1_FRAMES - 1).to(torch.int32)
    W, H = E1_W + 1, E1_H + 1  # build_event_chains' int(max) + 2
    splits, totals = [], []
    for rep in range(4):
        marks = []
        order, gid, ng = ne.sort_events_by_pixel(xs, ys, ts, fids, W, H, marks=marks)
        torch.cuda.synchronize()
        if rep:  # the first call builds nothing here, but warms the allocator
            splits.append([marks[i - 1][1].elapsed_time(e) for i, (_, e) in enumerate(marks)
                           if i])
            totals.append(marks[0][1].elapsed_time(marks[-1][1]))
    stages = [k for k, _ in marks[1:]]
    key = (fids.long() * H + ys.long()) * W + xs.long()
    pix = ys.long() * W + xs.long()
    n_keys = int((fids.max() - fids.min() + 1) * (pix.max() - pix.min() + 1))
    plan = ne.digit_plan(n_keys)
    del pix
    ks = key[order]
    seen = torch.zeros(n, dtype=torch.bool, device="cuda")
    seen[order] = True
    same = ks[1:] == ks[:-1]
    checks = dict(
        permutation=bool(seen.all()),
        keys_non_decreasing=bool((ks[1:] >= ks[:-1]).all()),
        ascending_in_group=bool((order[1:] > order[:-1])[same].all()),
        group_ids=bool(gid[0] == 0) and bool(((gid[1:] - gid[:-1]) == (~same).long()).all())
        and ng == int(gid[-1]) + 1)
    del seen, ks, same
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    tables = []  # E1's group tables over the sorted group ids, beside the sort
    for _ in range(4):
        start.record()
        ne.group_tables(gid, ng)
        end.record()
        end.synchronize()
        tables.append(start.elapsed_time(end))
    tables_ms = float(np.mean(tables[1:]))
    tables_bound = (n * (8 + 8) + ng * (8 + 8)) / HBM_BYTES_PER_S * 1e3
    del gid
    lib = []
    for _ in range(3):
        start.record()
        ref = torch.argsort(key, stable=True)
        end.record()
        end.synchronize()
        lib.append(start.elapsed_time(end))
    lib_equal = bool((ref == order).all())
    del ref, key, order
    ms = float(np.mean(totals))
    split = {k: float(np.mean([sp[i] for sp in splits])) for i, k in enumerate(stages)}
    nbytes = n * (4 + 4 + 8 + 4 + 8 + 8)  # x, y f32, t f64, frame i32 in; order, group ids out
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    # build_event_chains end to end: host events [n, 4] float64 in
    ev = torch.stack([xs.double(), ys.double(), ts * 1e10,
                      torch.where(torch.rand(n, device="cuda", generator=g) < 0.5, -1.0, 1.0
                                  ).double()], 1).cpu().numpy()
    fid_np = fids.long().cpu().numpy()
    del xs, ys, ts, fids
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.time()
    chains, _ = events.build_event_chains(ev, fid_np, E1_FRAMES, device="cuda")
    torch.cuda.synchronize()
    t_build = time.time() - t0
    chained = int(chains.xs.shape[0])
    del chains, ev, fid_np
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[chains] E1 at {n} events (card-made, {E1_H}x{E1_W}, {E1_FRAMES} windows, "
          f"{ng} groups, K = {n_keys}: {sum(plan)} bits in {len(plan)} passes of {plan}): "
          f"own checks {checks}; E1 {ms:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"); torch.argsort(stable=True) of the int64 keys {np.mean(lib):.4f} ms "
          f"({'the same order' if lib_equal else 'ANOTHER order'}); bound {bound:.4f} ms "
          f"(bytes, {nbytes / 1e9:.3f} GB), E1 at {100 * bound / ms:.1f}% of it; "
          f"E1's group tables {tables_ms:.4f} ms (bound {tables_bound:.4f} ms, bytes); "
          f"build_event_chains on the card {t_build:.3f} s ({chained} chained events)")
    if not (all(checks.values()) and lib_equal):
        raise AssertionError(f"E1 at {n} events failed its own checks: {checks}, argsort "
                             f"equal {lib_equal}")
    return dict(ms=ms, split=split, library_ms=float(np.mean(lib)), bound_ms=bound,
                bound_by="bytes", build_s=t_build, groups=ng,
                digit_plan=dict(keys=n_keys, bits=sum(plan), passes=len(plan), widths=plan),
                group_tables_ms=tables_ms, group_tables_bound_ms=tables_bound)


def phase_event_chains(esim_data, tumvie_dir, eds_dir):
    """Phase 15c: E1 against its plain version on the fixtures' events and
    on synthetic ones at the published size, its own checks and timings at
    10^7 and 10^8 events (the docstring's list)."""
    import numpy as np
    import torch
    from enerf_torch.__main__ import get_select_frames
    from enerf_torch.data import native_events as ne
    from enerf_torch.data.provider import _load_stereo_dataset

    reset_e1()
    errs = [e1_compare("phase 11's esim fixture (480 x 640, one window)", esim_data["events"],
                       None, 1)[3]]
    for tag, config, d in (("phase 15's tumvie fixture, prepared", "mocapDesk2/mocapDesk2_enerf.txt",
                            tumvie_dir),
                           ("phase 17's eds fixture", "eds11/eds11_enerf.txt", eds_dir)):
        cfg = stereo_config(config, d, os.path.join(REPO, "build", "chip_smoke_chains"))
        data = _load_stereo_dataset(cfg, get_select_frames(cfg))
        fids = data["event_frame_ids"]
        errs.append(e1_compare(tag, data["events"], fids, int(fids.max()) + 1)[3])
    ev, fids = synthetic_events(10 ** 7, 0)
    t_card7, t_plain7, plain_ms, err = e1_compare(
        f"10^7 synthetic events ({E1_H}x{E1_W}, {E1_FRAMES} windows, sorted times, a hot "
        "pixel of 10^4 at equal times)", ev, fids, E1_FRAMES)
    errs.append(err)
    # E1's and torch.argsort's time on the same events, against the plain sort's
    W7, H7 = int(ev[:, 0].max()) + 2, int(ev[:, 1].max()) + 2
    xs, ys, ts, fid = (torch.as_tensor(np.ascontiguousarray(a), device="cuda")
                       for a in (ev[:, 0], ev[:, 1], ev[:, 2], fids))
    totals = []
    for _ in range(4):
        marks = []
        ne.sort_events_by_pixel(xs, ys, ts, fid, W7, H7, marks=marks)
        torch.cuda.synchronize()
        totals.append(marks[0][1].elapsed_time(marks[-1][1]))
    ms7 = float(np.mean(totals[1:]))
    key = (fid * H7 + ys.float().long()) * W7 + xs.float().long()  # times sorted: lexsort's order
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    lib = []
    for _ in range(3):
        start.record()
        torch.argsort(key, stable=True)
        end.record()
        end.synchronize()
        lib.append(start.elapsed_time(end))
    lib7 = float(np.mean(lib))
    bound7 = len(ev) * (4 + 4 + 8 + 4 + 8 + 8) / HBM_BYTES_PER_S * 1e3
    del ev, fids, xs, ys, ts, fid, key
    ev, fids = synthetic_events(10 ** 6, 1, shuffled=True)
    errs.append(e1_compare("10^6 synthetic events, shuffled times", ev, fids, E1_FRAMES)[3])
    # E1's split where the times are unsorted: the fix-up after the group pass
    cols = [torch.as_tensor(np.ascontiguousarray(a), device="cuda")
            for a in (ev[:, 0], ev[:, 1], ev[:, 2], fids)]
    Wu, Hu = int(ev[:, 0].max()) + 2, int(ev[:, 1].max()) + 2
    splits = []
    for _ in range(4):
        marks = []
        ne.sort_events_by_pixel(*cols, Wu, Hu, marks=marks)
        torch.cuda.synchronize()
        splits.append({k: marks[i][1].elapsed_time(e) for i, (k, e) in enumerate(marks[1:])})
    unsorted_split = {k: float(np.mean([sp[k] for sp in splits[1:]])) for k in splits[0]}
    print("[chains] E1 at 10^6 shuffled times: "
          + ", ".join(f"{k} {v:.4f}" for k, v in unsorted_split.items())
          + f" ms; {sum(unsorted_split.values()):.4f} ms in all")
    del ev, fids, cols
    compared = e1_launches()
    t7, t8 = e1_timing(10 ** 7), e1_timing(10 ** 8)
    print(f"[chains] E1 launches in this phase: {compared} (sort, group tables) in the "
          f"comparisons; on the 10^7 synthetic events: the plain sort {plain_ms:.1f} ms, E1 "
          f"{ms7:.4f} ms, torch.argsort(stable=True) {lib7:.4f} ms, bound {bound7:.4f} ms "
          f"(bytes), E1 at {100 * bound7 / ms7:.1f}% of it; build_event_chains at 10^7 "
          f"{t_card7:.3f} s on the card, {t_plain7:.3f} s plain; at 10^8 {t8['build_s']:.3f} s "
          f"on the card")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs), ms=ms7, plain_ms=plain_ms, bound_ms=bound7,
                bound_by="bytes", library_ms=lib7, digit_plan=t7["digit_plan"],
                unsorted_split_1e6=unsorted_split,
                card_made_1e7=t7, card_made_1e8=t8, build_s_1e7=t_card7,
                plain_build_s_1e7=t_plain7, build_s_1e8=t8["build_s"])


def stereo_config(config, datadir, workspace, *extra):
    """A published tumvie / eds config as published, on a fixture: its
    train / val indices cut to the fixture's frames (the only cut),
    evaluation after the (one) epoch."""
    from enerf_torch.config import build_config
    idxs = [a for i in STEREO_TRAIN for a in ("--train_idxs", str(i))]
    idxs += [a for i in STEREO_VAL for a in ("--val_idxs", str(i))]
    return build_config(["--config", os.path.join(REPO, "configs", config), "--datadir", datadir,
                         "--outdir", workspace, "--eval_interval", "1", "--log_every", "1",
                         *idxs, *extra])


def phase_stereo(tag, config, datadir, workspace, steps):
    """A published tumvie / eds config as published on its fixture: one
    batch under the CUDA sync check, `steps` steps and one evaluation with
    the stereo event view; the OOM rule of phase 13."""
    import numpy as np
    import torch
    from enerf_torch.__main__ import get_select_frames
    from enerf_torch.data.provider import make_providers
    from enerf_torch.ops import fused_mlp, group_gather, scatter_accum

    from enerf_torch.data import eds, tumvie

    name = os.path.basename(config)[:-4]
    cfg = stereo_config(config, datadir, workspace, "--iters", str(steps))
    reset_e1()
    h5_read = []
    real = tumvie.read_events

    def timed_read(*a, **kw):  # the loaders' H5 read (events and rectify map)
        t = time.time()
        out = real(*a, **kw)
        h5_read.append(time.time() - t)
        return out

    tumvie.read_events = eds.read_events = timed_read
    try:
        t0 = time.time()
        train, val = make_providers(cfg, get_select_frames(cfg))
        load = time.time() - t0
    finally:
        tumvie.read_events = eds.read_events = real
    split = dict(h5_read=sum(h5_read), **train.load_seconds)
    split["rest"] = load - sum(split.values())
    print(f"[{tag}] {name}: load {load:.3f} s = "
          + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
          + f"; E1 launches {e1_launches()} (sort, group tables)")
    LOAD_SPLITS[tag] = dict(split, load=load, e1=e1_launches())
    gen = torch.Generator(device=train.device).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a host sync in the batch raises
    try:
        batch = train.train_step_batch(gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[{tag}] {name}: cut to train_idxs {list(STEREO_TRAIN)}, val_idxs "
          f"{list(STEREO_VAL)} (the fixture's 6 frames; nothing else cut); data loaded in "
          f"{load:.2f} s: {int(train.chains.xs.shape[0])} chained events in {train.n_frames} "
          f"windows, {train.H}x{train.W} event camera, {len(val.val_views())} val view(s), "
          f"{len(val.stereo_views or [])} stereo view(s); one batch with no host sync "
          f"(torch.cuda.set_sync_debug_mode('error')): "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items()))
    kernels = (fused_mlp.fused_field_head, scatter_accum.block_table_grad,
               group_gather.group_gather)
    for k in kernels:
        k.launches = 0
    # a run of whole windows takes two epochs (the capture, then replays
    # of the graph kept across them), evaluated after the second
    epochs = 2 if steps % 16 == 0 else 1

    def make_cfg(ws, *extra):
        return stereo_config(config, datadir, ws, "--iters", str(epochs * steps),
                             "--eval_interval", str(epochs), *extra)

    label, cfg, (trainer, _, _, peak) = run_as_published(
        tag, name, lambda *extra: make_cfg(workspace, *extra), workspace, steps, evaluate=True,
        providers=(train, val), epochs=epochs)
    launches = [k.launches for k in kernels]
    secs, res, hist = trainer.epoch_seconds, trainer.last_eval, trainer.history
    evdir = os.path.join(trainer.workspace, "validation", "event_view")
    written = sorted(os.listdir(evdir)) if os.path.isdir(evdir) else []
    print(f"[{tag}] {name} {label}: {esim_shape_line(trainer, train, cfg)}")
    windows = steps // cfg.fuse_steps if cfg.fuse_steps > 1 else 0
    print(f"[{tag}] {epochs} x {steps} steps ({windows} graphed window(s) an epoch), the last "
          f"epoch {secs['steps']:.3f} s = {steps / secs['steps']:.4f} steps/s; peak memory {peak:.2f} "
          f"GiB allocated, {trainer.peak_reserved_gib:.2f} GiB reserved; evaluation "
          f"{secs.get('evaluate', float('nan')):.3f} s, its views "
          + ", ".join(f"{h}x{w} {t:.3f} s" for h, w, t in trainer.view_seconds)
          + f" (frame view(s), then stereo view(s)); psnr_corrected "
          f"{res.get('psnr_corrected')}, affine a {res.get('affine_a')} b {res.get('affine_b')}; "
          f"{lpips_text(trainer)}; "
          f"validation/event_view/: {written}; K1 / K2 / K3 launches {launches}; losses "
          + ", ".join(f"{aux['loss']:.5f}" for _, aux in hist))
    losses = [[v for k, v in aux.items() if k.startswith("loss")] for _, aux in hist]
    # log_every 1: one line a window, one a step after the windows
    if not (len(losses) == epochs * (windows + steps - windows * cfg.fuse_steps)
            and np.isfinite(losses).all()):
        raise AssertionError(f"{name} losses not all finite: {hist}")
    ep = f"ep{trainer.epoch:04d}"
    want = {f"{ep}_{j:04d}{s}" for j in range(len(STEREO_VAL))
            for s in (".png", "_raw.npy", "_depth.png")}
    shapes = [(h, w) for h, w, _ in trainer.view_seconds]
    if not (want <= set(written) and shapes[-1] == (train.H, train.W) and len(shapes) == 2):
        raise AssertionError(f"{name}: stereo view outputs {written}, views rendered {shapes}")
    raw = np.load(os.path.join(evdir, f"{ep}_0000_raw.npy"))
    if not (raw.shape == (train.H, train.W, 1) and np.isfinite(raw).all()):
        raise AssertionError(f"{name}: stereo raw render {raw.shape} not finite")
    if tag == "tumvie":
        print(f"[{tag}] {diagnostics_text(trainer)}")
    if epochs == 1:
        return None
    first, replay = window_epochs(tag, trainer, steps)
    return dict(steps_s=first, replay_steps_s=replay, peak_gib=peak,
                peak_reserved_gib=trainer.peak_reserved_gib)


def reset_launches():
    from enerf_torch.ops import fused_mlp, group_gather, scatter_accum
    from enerf_torch.render.march import march_rays
    kernels = (fused_mlp.fused_field_head, scatter_accum.block_table_grad,
               group_gather.group_gather, march_rays)
    for k in kernels:
        k.launches = 0
    return kernels


class KeCount:
    """Counts K1's bf16 launches by enc k-steps (KE), observing the wrapper's
    launch_packed (the wrapper's own count is fused_field_head.launches)."""

    def __init__(self):
        from enerf_torch.ops import fused_mlp
        self.mod, self.real, self.seen = fused_mlp, fused_mlp.launch_packed, {}

    def __enter__(self):
        def counting(enc, denc, pack):
            self.seen[pack.ke] = self.seen.get(pack.ke, 0) + 1
            return self.real(enc, denc, pack)
        self.mod.launch_packed = counting
        return self.seen

    def __exit__(self, *exc):
        self.mod.launch_packed = self.real


def phase_background(workspace):
    """--ff -O --bg_radius 32 at the main path's width: 8 steps; the loss
    finite at each, bg_table's gradient non-zero, K1 launched; rays that
    miss the box render exactly the bg net's colour, through the training
    composite and the inference renderer."""
    import numpy as np
    import torch
    from enerf_torch.data.provider import make_providers
    from enerf_torch.models.field import field_background
    from enerf_torch.ops.aabb import MISS, aabb_tensor, near_far_from_aabb, polar_from_ray
    from enerf_torch.render.march import render_rays_infer, render_rays_march
    from enerf_torch.train.trainer import Trainer

    steps = 8
    cfg = smoke_config(workspace, "--bg_radius", "32", "--iters", str(steps), "--log_every", "1")
    trainer = Trainer(cfg, workspace=workspace)
    st = trainer.static
    train, _ = make_providers(cfg)
    train.steps_per_epoch = steps
    k1 = reset_launches()[0]
    with KeCount() as ke:
        trainer.train(train, max_epoch=1)
    torch.cuda.synchronize()
    launches = k1.launches
    secs = trainer.epoch_seconds["steps"]
    losses = [aux["loss"] for _, aux in trainer.history]
    gbg = trainer.state.params["bg_table"].grad
    gmax = float(gbg.abs().max()) if gbg is not None else 0.0
    # rays from a sphere of radius 4 pointing away from the box: all miss it
    gen = torch.Generator(device="cuda").manual_seed(1)
    ro = torch.randn(4096, 3, device="cuda", generator=gen)
    ro = 4.0 * ro / ro.norm(dim=-1, keepdim=True)
    rd = ro / ro.norm(dim=-1, keepdim=True) + 0.1 * torch.randn(4096, 3, device="cuda",
                                                               generator=gen)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    near, _ = near_far_from_aabb(ro, rd, aabb_tensor(st.bound, "cuda"), cfg.min_near)
    params, occ = trainer.state.params, trainer.occupancy.occ_packed
    with torch.no_grad():
        bgc = field_background(params, st, polar_from_ray(ro, rd, st.bg_radius), rd)
        comp = render_rays_march(params, st, occ, ro, rd, num_samples=cfg.march_samples,
                                 max_steps=cfg.max_steps, min_near=cfg.min_near,
                                 compact_frac=cfg.compact_frac)["image"]
        infer = render_rays_infer(params, st, occ, ro, rd, min_near=cfg.min_near)["image"]
    same = bool(torch.equal(comp, bgc) and torch.equal(infer, bgc))
    print(f"[bg] --ff -O --bg_radius {st.bg_radius:g}: bg net {st.bg_grid_meta.num_levels}x"
          f"{st.bg_grid_meta.level_dim} levels 2-D ({st.bg_grid_meta.total_entries} entries, "
          f"{int(st.bg_grid_meta.is_hashed.sum())} hashed), MLP {st.mlp_dims('bg')}; {steps} "
          f"steps {secs:.2f} s = {steps / secs:.3f} steps/s (occupancy update included); "
          f"losses {[f'{x:.5f}' for x in losses]}; bg_table |grad| max {gmax:.3e}; K1 launches "
          f"{launches} (by KE {ke}); {int((near >= MISS).sum())} of 4096 rays miss the box and "
          f"render {'exactly' if same else 'NOT'} the bg net's colour (training composite and "
          f"inference renderer; colour range {float(bgc.min()):.4f}-{float(bgc.max()):.4f})")
    if not (len(losses) == steps and np.isfinite(losses).all()):
        raise AssertionError(f"bg net: losses not all finite: {losses}")
    if not (gmax > 0 and launches > 0 and same and bool((near >= MISS).all())):
        raise AssertionError(f"bg net: bg_table grad {gmax}, K1 launches {launches}, the "
                             f"missing rays' colour the bg net's: {same}")
    return launches


def phase_grid_free(workspace):
    """--ff -O with --encoding frequency (E = 39, K1 at KE = 4) and --encoding
    none (E = 3, KE = 1): 4 steps each, K1 launched at that KE only, finite
    losses; then one step of each on the fixed-step renderer (the default
    path's config)."""
    import numpy as np
    import torch
    from enerf_torch.data.provider import make_providers
    from enerf_torch.ops import fused_mlp
    from enerf_torch.train.trainer import Trainer

    out = {}
    for enc, want_ke in (("frequency", 4), ("none", 1)):
        ws = os.path.join(workspace, enc)
        cfg = smoke_config(ws, "--encoding", enc, "--iters", "4", "--log_every", "1")
        trainer = Trainer(cfg, workspace=ws)
        train, _ = make_providers(cfg)
        train.steps_per_epoch = 4
        k1 = reset_launches()[0]
        with KeCount() as ke:
            trainer.train(train, max_epoch=1)
        torch.cuda.synchronize()
        launches = k1.launches
        losses = [aux["loss"] for _, aux in trainer.history]
        st = trainer.static
        # the default path (hash grid replaced by this encoder, fixed steps)
        dws = os.path.join(workspace, enc + "_default")
        dcfg = default_config(dws, "--encoding", enc)
        dtr = Trainer(dcfg, workspace=dws)
        dtrain, _ = make_providers(dcfg)
        torch.cuda.synchronize()
        t0 = time.time()
        daux = dtr.train_step(dtrain)
        dloss = float(daux["loss"])
        dsec = time.time() - t0
        print(f"[grid-free] --ff -O --encoding {enc}: enc {st.in_dim} wide, no table "
              f"({sorted(trainer.state.params)}); 4 steps {trainer.epoch_seconds['steps']:.2f} s; "
              f"losses {[f'{x:.5f}' for x in losses]}; K1 launches {launches}, by KE {ke} "
              f"(want KE {want_ke} = k_steps({st.in_dim}) {fused_mlp.k_steps(st.in_dim)}); "
              f"fixed-step default path, one step: loss {dloss:.5f} ({dsec:.2f} s, the first)")
        if not (len(losses) == 4 and np.isfinite(losses).all() and np.isfinite(dloss)):
            raise AssertionError(f"--encoding {enc}: losses not finite: {losses}, {dloss}")
        if not (launches > 0 and set(ke) == {want_ke} and sum(ke.values()) == launches):
            raise AssertionError(f"--encoding {enc}: K1 launches {launches}, by KE {ke}")
        out[enc] = dict(launches=launches, KE=want_ke)
        del trainer, dtr
    return out


def timed_steps(trainer):
    """Wrap trainer.train_step so each step's synchronized seconds land in
    trainer.step_seconds as (rand-pose step?, seconds)."""
    import torch
    step, trainer.step_seconds = trainer.train_step, []

    def timed(provider):
        torch.cuda.synchronize()
        t0 = time.time()
        aux = step(provider)
        torch.cuda.synchronize()
        trainer.step_seconds.append(("loss_clip" in aux, time.time() - t0))
        return aux

    trainer.train_step = timed


def phase_clip(datadir, workspace):
    """The CLIP step at a published width: spiral1_nerf as published with
    --rand_pose 4 --clip_text --bg_radius 32, 10 steps (the 5th and 10th
    render a random pose's 173 x 173 ray grid x 512 steps); then 4 steps of
    --ff -O --events 0 --rand_pose 1 on the synthetic scene, through K1."""
    import numpy as np
    import torch
    from enerf_torch.__main__ import get_select_frames
    from enerf_torch.data.provider import make_providers
    from enerf_torch.train.trainer import Trainer

    steps, text = 10, "a photo of a carpet"
    cfg = esim_config("spiral1/spiral1_nerf.txt", datadir, workspace, "--iters", str(steps),
                      "--rand_pose", "4", "--clip_text", text, "--bg_radius", "32")
    trainer = Trainer(cfg, workspace=workspace)
    timed_steps(trainer)
    train, _ = make_providers(cfg, get_select_frames(cfg))
    train.steps_per_epoch = steps
    side = max(int(np.sqrt(train.num_rays)), 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train(train, max_epoch=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    secs = trainer.epoch_seconds["steps"]
    hist = trainer.history
    clip = [(s, aux["loss_clip"]) for s, aux in hist if "loss_clip" in aux]
    t_clip = [t for c, t in trainer.step_seconds if c]
    t_gt = [t for c, t in trainer.step_seconds[1:] if not c]
    print(f"[clip] spiral1_nerf as published + --rand_pose 4 --clip_text {text!r} --bg_radius "
          f"32: {esim_shape_line(trainer, train, cfg)}; rand-pose steps render {side} x {side} = "
          f"{side * side} rays x {cfg.num_steps} steps = {side * side * cfg.num_steps} samples")
    print(f"[clip] {steps} steps {secs:.3f} s = {steps / secs:.4f} steps/s (the first "
          f"included); peak memory {peak:.2f} GiB; loss_clip at steps "
          + ", ".join(f"{s}: {v:.5f}" for s, v in clip)
          + f"; a CLIP step {np.mean(t_clip):.3f} s ({[f'{t:.3f}' for t in t_clip]}) against a "
          f"GT step {np.mean(t_gt):.3f} s (steps 2-{steps}, {len(t_gt)} of them); losses "
          + ", ".join(f"{aux['loss']:.5f}" for _, aux in hist))
    losses = [aux["loss"] for _, aux in hist]
    if not (len(losses) == steps and np.isfinite(losses).all()):
        raise AssertionError(f"CLIP run: losses not all finite: {hist}")
    if [s for s, _ in clip] != [5, 10]:
        raise AssertionError(f"CLIP run: rand-pose steps at {[s for s, _ in clip]}, not [5, 10]")
    del trainer, train
    gc.collect()
    torch.cuda.empty_cache()

    ws = os.path.join(workspace, "ff")
    cfg = smoke_config(ws, "--events", "0", "--event_only", "0", "--rand_pose", "1",
                       "--clip_text", text, "--iters", "4", "--log_every", "1")
    trainer = Trainer(cfg, workspace=ws)
    train, _ = make_providers(cfg)
    train.steps_per_epoch = 4
    k1 = reset_launches()[0]
    trainer.train(train, max_epoch=1)
    torch.cuda.synchronize()
    launches = k1.launches
    clip = [(s, aux["loss_clip"]) for s, aux in trainer.history if "loss_clip" in aux]
    losses = [f"{aux['loss']:.5f}" for _, aux in trainer.history]
    side = max(int(np.sqrt(train.num_rays)), 8)
    print(f"[clip] --ff -O --events 0 --rand_pose 1: 4 steps {trainer.epoch_seconds['steps']:.2f} "
          f"s; rand-pose steps ({side} x {side} rays on the march) loss_clip "
          + ", ".join(f"{s}: {v:.5f}" for s, v in clip)
          + f"; losses {losses}; K1 launches {launches}")
    if not ([s for s, _ in clip] == [2, 4] and np.isfinite([v for _, v in clip]).all()
            and launches > 0):
        raise AssertionError(f"--ff -O CLIP steps: {clip}, K1 launches {launches}")
    return launches


def phase_position_grads():
    """dL/dx of hash_encode and block_encode (the main path's 16 x 2 levels,
    2^19; block 4) at 1,048,576 points, some outside the box: the card
    against the CPU on the same inputs (relative 1e-5 of the largest
    |dx|); the backward's time with and without dx on the card."""
    import torch
    from enerf_torch.models.field import FieldStatic
    from enerf_torch.ops.blockgrid import block_encode
    from enerf_torch.ops.hashgrid import hash_encode

    N = 1 << 20
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(N, 3, generator=gen) * 1.04 - 0.02
    res = {}
    for enc, fn in (("hashgrid", hash_encode), ("blockgrid", block_encode)):
        meta = FieldStatic(encoding=enc, grid_block=4).grid_meta
        rows = meta.total_entries if enc == "hashgrid" else meta.total_rows
        width = meta.level_dim if enc == "hashgrid" else meta.level_dim * meta.row_cells
        table = torch.rand(rows, width, generator=gen) * 2 - 1
        g = torch.randn(N, meta.output_dim, generator=gen)

        def dx_on(dev):
            xx = x.to(dev, copy=True).requires_grad_()
            (dx,) = torch.autograd.grad(fn(xx, table.to(dev), meta), xx, g.to(dev))
            return dx

        t0 = time.time()
        ref = dx_on("cpu")
        t_cpu = time.time() - t0
        got = dx_on("cuda").cpu()
        err = float((got - ref).abs().max() / ref.abs().max())
        ms = {}
        for with_dx in (False, True):
            xx = x.to("cuda", copy=True).requires_grad_(with_dx)
            tt = table.cuda().requires_grad_()
            out = fn(xx, tt, meta)
            wrt = [tt, xx] if with_dx else [tt]
            gc_ = g.cuda()
            ms[with_dx] = time_ms(lambda: torch.autograd.grad(out, wrt, gc_, retain_graph=True),
                                  iters=5, warmup=1)
            del out
        print(f"[dx] {enc} ({meta.num_levels}x{meta.level_dim}, {rows} rows x {width}) at {N} "
              f"points ({int(((x < 0) | (x > 1)).any(-1).sum())} outside the box): card vs CPU "
              f"max |ddx| / max |dx| {err:.3e} (tol 1e-5; max |dx| {float(ref.abs().max()):.3e}; "
              f"the CPU's {t_cpu:.1f} s); backward on the card {ms[False]:.2f} ms without dx, "
              f"{ms[True]:.2f} ms with dx ({ms[True] - ms[False]:+.2f} ms, CUDA events)")
        if not err <= 1e-5:
            raise AssertionError(f"{enc} position gradients: card vs CPU {err}")
        res[enc] = dict(rel_err=err, backward_ms=ms[False], backward_dx_ms=ms[True])
    return res


# ----------------------------------------------------------------------------
# phases 22-23: data parallelism (enerf_torch/parallel/)

DP_TIMEOUT_S = 600  # a collective that waits longer fails the rank
DP_DEVICES = ["cuda:0", "cuda:0"]  # phase 23's two ranks, on one card on purpose


class TimedAllReduce:
    """Wraps parallel.mesh.all_reduce_grads: each call's synchronized
    milliseconds (the flat gradient all_reduce and its write-back)."""

    def __init__(self):
        from enerf_torch.parallel import mesh as dp
        self.mod, self.real, self.ms = dp, dp.all_reduce_grads, []

    def __enter__(self):
        import torch

        def timed(params, mesh):
            torch.cuda.synchronize()
            t0 = time.time()
            self.real(params, mesh)
            torch.cuda.synchronize()
            self.ms.append((time.time() - t0) * 1e3)
        self.mod.all_reduce_grads = timed
        return self.ms

    def __exit__(self, *exc):
        self.mod.all_reduce_grads = self.real


# Adam's first step moves an entry by u(g) = lr g / (|g| + eps): a relative
# change rho of g changes it by at most lr rho / 4, so 5e-3 keeps the params
# within 1e-5 at lr <= 8e-3
DP_GRAD_CLEAR = 5e-3


def param_diff(state_a, state_b):
    """Two TrainStates after one step from the same params, each param's
    .grad still the step's gradient.  Adam's first step moves an entry by
    about lr times its gradient's sign, so the params alone cannot tell a
    gradient's size: the gradients are compared by norm, leaf by leaf, and
    the params wherever a's gradient is within DP_GRAD_CLEAR of b's,
    relatively.  Returns, over every leaf: max |a - b| of all params and
    of those entries, the worst leaf's ||ga - gb|| / ||gb||, the entries
    with a gradient on either side, those of them left out, and those left
    out that moved apart (by more than 1e-5); and each leaf's numbers."""
    import torch
    leaves = {}
    for k, pa in state_a.params.items():
        pb = state_b.params[k]
        ga, gb = pa.grad, pb.grad
        d = (pa.detach() - pb.detach()).abs()
        clear = (ga - gb).abs() <= DP_GRAD_CLEAR * gb.abs()
        nonzero = (ga != 0) | (gb != 0)
        gn = float(torch.linalg.vector_norm(gb))
        en = float(torch.linalg.vector_norm(ga - gb))
        leaves[k] = dict(
            numel=d.numel(), max_dparam=float(d.max()),
            max_dparam_clear=float(torch.where(clear, d, 0.0).max()),
            grad_rel=en / gn if gn else (0.0 if en == 0 else float("inf")),
            nonzero=int(nonzero.sum()), unclear=int((nonzero & ~clear).sum()),
            moved=int((nonzero & ~clear & (d > 1e-5)).sum()))
    total = {k: sum(v[k] for v in leaves.values()) for k in ("nonzero", "unclear", "moved")}
    worst = {k: max(v[k] for v in leaves.values())
             for k in ("max_dparam", "max_dparam_clear", "grad_rel")}
    return dict(worst, **total, leaves=leaves)


def dp_compare(mesh, cfg, workspace):
    """On each rank of `mesh`: the main path's trainer, its occupancy by
    update_occupancy_sharded against the serial update with the same jitter,
    then one data-parallel step on this rank's shard of one global batch
    against the single-process step on the whole batch, with the same noise
    (both drawn alike on every rank).  Returns the numbers and this rank's
    trainer."""
    import warnings
    import torch
    from enerf_torch.data.provider import make_providers
    from enerf_torch.ops import fused_mlp
    from enerf_torch.parallel import mesh as dp
    from enerf_torch.render.occupancy import (
        GRID_SIZE, clone_occupancy, update_occupancy, update_occupancy_sharded,
    )
    from enerf_torch.train.state import TrainState
    from enerf_torch.train.step import draw_noise, train_step_events
    from enerf_torch.train.trainer import Trainer

    dev = mesh.device
    trainer = Trainer(cfg, workspace=workspace, mesh=mesh)
    train, val = make_providers(cfg, device=dev)  # the global batch: every rank draws it alike
    occ0, static = trainer.occupancy, trainer.static
    g = torch.Generator(device=dev).manual_seed(7)
    jitter = torch.rand(occ0.density_grid.shape[0], GRID_SIZE ** 3, 3, device=dev, generator=g)
    kw = dict(density_scale=cfg.density_scale, density_thresh=cfg.density_thresh)
    torch.cuda.synchronize()
    t0 = time.time()
    # the update writes in place: each side on a copy of the initial state
    occ = update_occupancy_sharded(trainer.state.params, static, clone_occupancy(occ0),
                                   mesh=mesh, noise=jitter, **kw)
    torch.cuda.synchronize()
    t_sharded = time.time() - t0
    t0 = time.time()
    serial = update_occupancy(trainer.state.params, static, clone_occupancy(occ0),
                              noise=jitter, **kw)
    torch.cuda.synchronize()
    t_serial = time.time() - t0
    occ_equal = (torch.equal(occ.density_grid, serial.density_grid)
                 and torch.equal(occ.occ_bitfield, serial.occ_bitfield))
    trainer.occupancy = occ

    g = torch.Generator(device=dev).manual_seed(11)
    batch = train.train_step_batch(g)
    N = batch["rays_evs_o1"].shape[0]
    noise = draw_noise(trainer.ss, N, g, dev)
    single = TrainState({k: p.detach() for k, p in trainer.state.params.items()},
                        cfg.lr, cfg.iters)
    step = dp.make_sharded_train_step(trainer.ss, mesh)
    # one backward summed in one order on each side (index_add_ without
    # atomics), so that the two sides differ by the reduction alone
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # ops without a deterministic form
            fused_mlp.fused_field_head.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            with TimedAllReduce() as ar_ms:
                sc = step(trainer.state, dp.shard_batch(batch, mesh), occ.occ_packed,
                          noise=noise)
            torch.cuda.synchronize()
            t_step = time.time() - t0
            k1 = fused_mlp.fused_field_head.launches
            ref = train_step_events(single, batch, trainer.ss, occ.occ_packed, noise=noise)
    finally:
        torch.use_deterministic_algorithms(False)
    dp.assert_replicated(trainer.state, trainer.occupancy, mesh)
    return trainer, val, dict(
        rank=mesh.rank, world=mesh.world_size, backend=mesh.backend, pairs_global=N,
        pairs_rank=N // mesh.world_size, C_thres=cfg.C_thres, loss=float(sc["loss"]),
        loss_single=float(ref["loss"]), **param_diff(trainer.state, single),
        k1_launches=k1, step_s=t_step, allreduce_ms=ar_ms[0],
        occ_equal=occ_equal, occ_sharded_s=t_sharded, occ_serial_s=t_serial,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


DP_GRAD_RTOL = 2e-2  # ||g_dp - g_1|| / ||g_1|| per leaf
DP_UNCLEAR_SHARE = 5e-3  # of the entries with a gradient, those the params' check leaves out


def dp_check(tag, r, param_tol):
    """The comparison's verdict; raises if a number misses its tolerance."""
    ok = (abs(r["loss"] - r["loss_single"]) <= 1e-4 * abs(r["loss_single"])
          and r["max_dparam_clear"] <= param_tol and r["grad_rel"] <= DP_GRAD_RTOL
          and r["nonzero"] > 0 and r["unclear"] <= DP_UNCLEAR_SHARE * r["nonzero"]
          and r["occ_equal"] and r["k1_launches"] > 0)
    if tag == "dp-nccl":
        ok = ok and r["max_dparam"] <= param_tol
    if not ok:
        raise AssertionError(f"[{tag}] the data-parallel step disagrees: {r}")


def phase_dp_nccl(workspace):
    """Phase 22: one rank over NCCL on cuda:0, in this process: the main
    path's data-parallel step against the plain step (NCCL over one rank
    reduces nothing: max |dparam| <= 1e-6)."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from enerf_torch.parallel import mesh as dp, multihost

    with tempfile.TemporaryDirectory(prefix="enerf_rendezvous_") as tmp:
        multihost.initialize("file://" + os.path.join(tmp, "store"), world_size=1, rank=0,
                             backend="nccl", timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
        try:
            mesh = dp.make_mesh(devices=["cuda:0"])
            _, _, r = dp_compare(mesh, smoke_config(workspace), workspace)
        finally:
            dist.destroy_process_group()
    print(f"[dp-nccl] 1 rank over {r['backend']} on cuda:0, {r['pairs_global']} pairs: loss "
          f"{r['loss']:.6f} vs the plain step's {r['loss_single']:.6f}; max |dparam| "
          f"{r['max_dparam']:.3e} (tol 1e-6); gradients within {r['grad_rel']:.2e} of their "
          f"norm (tol {DP_GRAD_RTOL:g}); K1 launches {r['k1_launches']} in the step; "
          f"step {r['step_s']:.3f} s, gradient all_reduce {r['allreduce_ms']:.3f} ms; "
          f"sharded occupancy update {'bit-equal' if r['occ_equal'] else 'DIFFERENT'} to the "
          f"serial one ({r['occ_sharded_s']:.3f} / {r['occ_serial_s']:.3f} s)")
    dp_check("dp-nccl", r, 1e-6)
    return r


def dp_window_case(mesh, workspace, C_thres):
    """The data-parallel window (train/chunk.py under a mesh) on this rank:
    the provider's batch is the config's whole batch; one window step on
    this rank's batch and noise (its own generator) against one process's
    loss on that batch alone and on every rank's batches concatenated (the
    ranks' draws gathered); then one epoch of 20 steps through
    Trainer.train, rounded down to one 16-step window."""
    import torch
    from enerf_torch.data.provider import make_providers
    from enerf_torch.parallel import mesh as dp
    from enerf_torch.parallel.multihost import gather_rows
    from enerf_torch.render.occupancy import update_occupancy_sharded
    from enerf_torch.train.step import event_loss_fn, step_noise
    from enerf_torch.train.trainer import Trainer

    cfg = smoke_config(workspace, "--C_thres", str(C_thres))
    trainer = Trainer(cfg, workspace=workspace, mesh=mesh)
    train, _ = make_providers(cfg, device=mesh.device, shards=mesh.world_size)
    ss, gen = trainer.ss, trainer.rank_generator
    trainer.occupancy = update_occupancy_sharded(
        trainer.state.params, trainer.static, trainer.occupancy, trainer.generator, gen,
        mesh=mesh, density_scale=cfg.density_scale, density_thresh=cfg.density_thresh)
    bits = trainer.occupancy.occ_packed
    batch = train.train_step_batch(gen)
    noise = step_noise(ss, batch, gen)
    N = batch["pols"].shape[0]
    with torch.no_grad():
        own = float(event_loss_fn(trainer.state.params, ss, batch, noise, bits)[0])
        everyone = {k: gather_rows(v.contiguous(), mesh.group) for k, v in batch.items()}
        noise_all = {k: gather_rows((v.expand(N, -1) if k == "bg" else v).contiguous(),
                                    mesh.group) for k, v in noise.items()}
        concat = float(event_loss_fn(trainer.state.params, ss, everyone, noise_all, bits)[0])
    out = dp.make_window_step(ss, mesh)(trainer.state, batch, bits, gen, noise=noise)
    rank_loss = float(out["loss"])
    mean_loss = float(dp.global_means({"loss": out["loss"]}, mesh)["loss"])
    dp.assert_replicated(trainer.state, trainer.occupancy, mesh)
    train.steps_per_epoch = 20
    step0, t0 = trainer.state.step, time.time()
    trainer.train(train, None, max_epoch=1)  # checks the ranks bit-equal at its end
    window_s = trainer._clock() - t0
    rounded = None  # rank 0 writes the log
    if mesh.rank == 0:
        with open(trainer.log_path) as f:
            rounded = "rounded down to 16" in f.read()
    return dict(C_thres=C_thres, pairs_rank=N, config_pairs=cfg.batch_size_evs,
                rank_loss=rank_loss, own_loss=own, mean_loss=mean_loss, concat_loss=concat,
                steps=trainer.state.step - step0, window_s=window_s, rounded_logged=rounded,
                losses=[aux["loss"] for _, aux in trainer.history])


def dp_clip_case(mesh, workspace):
    """Phase 23 (e) on one rank: the default path's config in frames mode
    with --rand_pose 1 --clip_text (--fuse_steps 1): one data-parallel
    frame step, then the rand-pose CLIP step on every rank, the ranks
    checked bit-equal; rank 0 then takes one process's CLIP step from the
    same state and shared draws.  index_add_ without atomics on both sides,
    so that the two differ by the gradient's mean over the ranks alone."""
    import warnings
    import torch
    from enerf_torch.data.provider import make_providers
    from enerf_torch.parallel import mesh as dp
    from enerf_torch.train.trainer import Trainer

    cfg = default_config(workspace, "--events", "0", "--rand_pose", "1", "--clip_text",
                         "a photo of a ball", "--fuse_steps", "1")
    trainer = Trainer(cfg, workspace=workspace, mesh=mesh)
    train, _ = make_providers(cfg, device=mesh.device, shards=mesh.world_size)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # ops without a deterministic form
            trainer.train_step(train)  # batch 1: this rank's half of the frame rays
            before = {k: v.detach().clone()
                      for k, v in dp.replicated_tensors(trainer.state).items()}
            gen, batch_i, step = trainer.generator.get_state(), train._batch_i, trainer.state.step
            torch.cuda.synchronize()
            t0 = time.time()
            aux = trainer.train_step(train)  # batch 2: the rand pose, alike on every rank
            torch.cuda.synchronize()
            r = dict(rank=mesh.rank, rank_rays=train.num_rays, clip_rays=train.rand_pose_rays,
                     clip_s=time.time() - t0, loss_clip=float(aux["loss_clip"]))
            dp.assert_replicated(trainer.state, None, mesh)
            if mesh.rank == 0:
                one = Trainer(cfg, workspace=workspace + "_one", device=mesh.device)
                one_train, _ = make_providers(cfg, device=mesh.device)
                with torch.no_grad():
                    for k, t in dp.replicated_tensors(one.state).items():
                        t.copy_(before[k])
                one.state.step = step
                one.generator.set_state(gen)
                one_train._batch_i = batch_i
                ref = one.train_step(one_train)
                after = dp.replicated_tensors(trainer.state)
                rel = {k: float(torch.linalg.vector_norm((t - after[k]).double())
                                / max(float(torch.linalg.vector_norm(t.double())), 1e-30))
                       for k, t in dp.replicated_tensors(one.state).items()}
                worst = max(rel, key=rel.get)
                r.update(loss_clip_one=float(ref["loss_clip"]), worst_rel=rel[worst],
                         worst=worst, tensors=len(rel))
    finally:
        torch.use_deterministic_algorithms(False)
    return r


def dp_rank_main_path(mesh, workspace, out_dir):
    """Phase 23 (a) and (c) on one rank: dp_compare, then one validation view
    through make_sharded_render against render_rays_march of the whole view
    on rank 0."""
    import numpy as np
    import torch
    from enerf_torch.data.rays import get_rays_full
    from enerf_torch.ops import fused_mlp
    from enerf_torch.render.march import render_rays_march

    torch.backends.cuda.matmul.allow_tf32 = False  # as in this script's main()
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_config(workspace, "--fuse_steps", "1")  # the per-step path's split batch
    trainer, val, r = dp_compare(mesh, cfg, workspace)
    # the normalized event loss, whose norm crosses the ranks
    ws = os.path.join(workspace, "norm")
    r["norm"] = dp_compare(mesh, smoke_config(ws, "--C_thres", "-1", "--fuse_steps", "1"),
                           ws)[2]
    r["window"] = [dp_window_case(mesh, os.path.join(workspace, f"window{c}"), c)
                   for c in (0.2, -1)]
    r["clip"] = dp_clip_case(mesh, os.path.join(workspace, "clip"))
    v = val.val_views()[0]
    fused_mlp.fused_field_head.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    img, depth = trainer.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
    torch.cuda.synchronize()
    r.update(view_s=time.time() - t0, view_k1=fused_mlp.fused_field_head.launches,
             view_shape=list(img.shape), view_finite=bool(np.isfinite(img).all()))
    if mesh.rank == 0:
        pose = torch.as_tensor(np.asarray(v["pose"]), dtype=torch.float32, device=mesh.device)
        ro, rd = get_rays_full(pose, v["intrinsics"], v["H"], v["W"])
        with torch.no_grad():
            ref = render_rays_march(
                trainer.state.ema_params, trainer.static, trainer.occupancy.occ_packed, ro, rd,
                num_samples=max(2 * cfg.march_samples, 128), max_steps=trainer.ss.max_steps,
                bg_color=1.0, min_near=cfg.min_near, density_scale=cfg.density_scale,
                dt_gamma=cfg.dt_gamma)
        r["view_err"] = max(
            float(np.abs(img.reshape(-1) - ref["image"].reshape(-1).cpu().numpy()).max()),
            float(np.abs(depth.reshape(-1) - ref["depth"].cpu().numpy()).max()))
    with open(os.path.join(out_dir, f"main_rank{mesh.rank}.json"), "w") as f:
        json.dump(r, f)


def dp_rank_sparse(mesh, datadir, workspace, extra, steps, out_dir):
    """Phase 23 (b) on one rank: spiral1_sparse_enerf as published (the
    config's batch the global one), `steps` steps through Trainer.train."""
    import numpy as np
    import torch
    from enerf_torch.cli import get_select_frames
    from enerf_torch.data.provider import make_providers
    from enerf_torch.parallel import mesh as dp
    from enerf_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False  # as in this script's main()
    torch.backends.cudnn.allow_tf32 = False
    # the per-step path (--fuse_steps 1): the config's batch split over the
    # ranks, the normalized loss's global norm
    cfg = esim_config("spiral1_sparse/spiral1_sparse_enerf.txt", datadir, workspace,
                      "--iters", str(steps), "--fuse_steps", "1", *extra)
    trainer = Trainer(cfg, workspace=workspace, mesh=mesh)
    train, _ = make_providers(cfg, get_select_frames(cfg), device=mesh.device,
                              shards=mesh.world_size)
    train.steps_per_epoch = steps
    kernels = reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with TimedAllReduce() as ar_ms:
        trainer.train(train, None, max_epoch=1)
    torch.cuda.synchronize()
    dp.assert_replicated(trainer.state, trainer.occupancy, mesh)
    secs = trainer.epoch_seconds
    r = dict(rank=mesh.rank, pairs_rank=train.batch_size_evs, C_thres=cfg.C_thres,
             remat_fixed=cfg.remat_fixed, steps_s=steps / secs["steps"],
             replication_check_s=secs.get("replication check"),
             peak_gib=torch.cuda.max_memory_allocated(mesh.device) / 2**30,
             allreduce_ms=ar_ms, losses=[aux["loss"] for _, aux in trainer.history],
             launches=[k.launches for k in kernels], step=trainer.state.step)
    if not (len(r["losses"]) == steps and np.isfinite(r["losses"]).all()):
        raise AssertionError(f"spiral1_sparse_enerf losses: {r['losses']}")
    with open(os.path.join(out_dir, f"sparse_rank{mesh.rank}.json"), "w") as f:
        json.dump(r, f)


def phase_dp_gloo(workspace, datadir):
    """Phase 23: two ranks over gloo, both on cuda:0, started as the CLI's
    --mesh_shape starts ranks (parallel.mesh.spawn); `datadir` is phase 11's
    esim fixture."""
    import datetime
    import numpy as np
    import torch
    from enerf_torch.parallel import mesh as dp

    timeout = datetime.timedelta(seconds=DP_TIMEOUT_S)
    out_dir = os.path.join(workspace, "results")
    shutil.rmtree(workspace, ignore_errors=True)
    os.makedirs(out_dir)
    devices = DP_DEVICES
    t0 = time.time()
    dp.spawn(dp_rank_main_path, devices, args=(workspace, out_dir), timeout=timeout)
    ranks = [json.load(open(os.path.join(out_dir, f"main_rank{i}.json"))) for i in (0, 1)]
    r = ranks[0]
    for x in (r, r["norm"]):
        print(f"[dp-gloo] (a) 2 ranks over {x['backend']} on cuda:0, C_thres {x['C_thres']}: "
              f"{x['pairs_global']} global pairs, {x['pairs_rank']} a rank; loss "
              f"{x['loss']:.6f} vs one process's {x['loss_single']:.6f} (rtol 1e-4); reduced "
              f"gradients within {x['grad_rel']:.2e} of one process's by norm, the worst leaf "
              f"(tol {DP_GRAD_RTOL:g}); max |dparam| {x['max_dparam_clear']:.3e} where the "
              f"gradient is within {DP_GRAD_CLEAR:g} of one process's (tol 1e-5), "
              f"{x['max_dparam']:.3e} over "
              f"all; {x['unclear']} of {x['nonzero']} entries with a gradient left out (tol "
              f"{DP_UNCLEAR_SHARE:g} of them), {x['moved']} of those moved apart; the ranks "
              f"bit-equal; sharded occupancy "
              f"{'bit-equal' if x['occ_equal'] else 'DIFFERENT'} to the serial update")
    print(f"[dp-gloo] (a) {time.time() - t0:.1f} s with the start; K1 launches per rank "
          f"{[x['k1_launches'] for x in ranks]}; step {[round(x['step_s'], 3) for x in ranks]} s, "
          f"gradient all_reduce {[round(x['allreduce_ms'], 3) for x in ranks]} ms; peak "
          f"{[round(x['peak_gib'], 2) for x in ranks]} GiB")
    print(f"[dp-gloo] (c) one {r['view_shape']} view through make_sharded_render: "
          f"{r['view_s']:.2f} s, K1 launches per rank {[x['view_k1'] for x in ranks]}; max "
          f"|image, depth - render_rays_march of the whole view| {r['view_err']:.3e} (tol 1e-5)")
    for x in ranks:
        dp_check("dp-gloo", x, 1e-5)
        dp_check("dp-gloo", x["norm"], 1e-5)
    if not (r["view_err"] <= 1e-5 and r["view_finite"]):
        raise AssertionError(f"[dp-gloo] the sharded view disagrees: {r['view_err']}")
    for w0, w1 in zip(ranks[0]["window"], ranks[1]["window"]):
        rel_mean = abs(w0["mean_loss"] - w0["concat_loss"]) / abs(w0["concat_loss"])
        rel_own = [abs(w["rank_loss"] - w["own_loss"]) / abs(w["own_loss"]) for w in (w0, w1)]
        print(f"[dp-gloo] (d) the data-parallel window, C_thres {w0['C_thres']}: each rank "
              f"draws the config's {w0['config_pairs']} pairs "
              f"({[w0['pairs_rank'], w1['pairs_rank']]}); rank losses "
              f"{[w0['rank_loss'], w1['rank_loss']]}, their mean {w0['mean_loss']:.7f} vs one "
              f"process's on both batches concatenated {w0['concat_loss']:.7f} (rel "
              f"{rel_mean:.2e}), each rank's vs one process's on its batch alone (rel "
              f"{[f'{x:.2e}' for x in rel_own]}); then a 20-step epoch -> "
              f"{[w0['steps'], w1['steps']]} steps, the rounding logged "
              f"{w0['rounded_logged']}, window {w0['window_s']:.2f} s (eager under a mesh), the "
              f"ranks bit-equal, window losses {w0['losses']}")
        ok = (w0["pairs_rank"] == w1["pairs_rank"] == w0["config_pairs"]
              and w0["steps"] == w1["steps"] == 16 and w0["rounded_logged"]
              and w0["losses"] == w1["losses"])
        if w0["C_thres"] == -1:  # normalized per rank, as JAX's chunk does
            ok = ok and max(rel_own) <= 1e-6 and rel_mean > 1e-6
        else:
            ok = ok and rel_mean <= 1e-6
        if not ok:
            raise AssertionError(f"[dp-gloo] the data-parallel window disagrees: {w0}, {w1}")
    c0, c1 = ranks[0]["clip"], ranks[1]["clip"]
    print(f"[dp-gloo] (e) --events 0 --rand_pose 1 --clip_text on 2 ranks: frame rays "
          f"{[c0['rank_rays'], c1['rank_rays']]} a rank, then the CLIP step on both (the "
          f"config's {c0['clip_rays']} rays, one pose from the shared generator, gradients "
          f"meaned): "
          f"{[round(c0['clip_s'], 3), round(c1['clip_s'], 3)]} s, loss_clip "
          f"{[c0['loss_clip'], c1['loss_clip']]}, the ranks bit-equal (assert_replicated); one "
          f"process's CLIP step from the same state and draws: loss_clip "
          f"{c0['loss_clip_one']}, the worst of {c0['tensors']} tensors {c0['worst']} within "
          f"{c0['worst_rel']:.3e} by norm (tol 1e-6)")
    if not (c0["loss_clip"] == c1["loss_clip"] and c0["worst_rel"] <= 1e-6
            and abs(c0["loss_clip_one"] - c0["loss_clip"]) <= 1e-6 * abs(c0["loss_clip"])):
        raise AssertionError(f"[dp-gloo] the data-parallel CLIP step disagrees: {c0}, {c1}")

    steps, sparse = 4, None
    for label, extra in (("as published", ()), ("with --remat_fixed 1", ("--remat_fixed", "1"))):
        ws = os.path.join(workspace, "sparse")
        t0 = time.time()
        try:
            dp.spawn(dp_rank_sparse, devices, args=(datadir, ws, extra, steps, out_dir),
                     timeout=timeout)
        except torch.multiprocessing.ProcessRaisedException as e:
            oom = [ln for ln in str(e).splitlines() if "OutOfMemoryError" in ln]
            if extra or not oom:
                raise
            print(f"[dp-gloo] (b) spiral1_sparse_enerf {label}, 2 ranks on one card: "
                  f"{oom[-1].strip()[:300]} ({time.time() - t0:.1f} s)")
            continue
        sparse = [json.load(open(os.path.join(out_dir, f"sparse_rank{i}.json"))) for i in (0, 1)]
        break
    s = sparse[0]
    ar = [float(np.mean(x["allreduce_ms"])) for x in sparse]
    print(f"[dp-gloo] (b) spiral1_sparse_enerf {label} (C_thres {s['C_thres']}, the global norm), "
          f"2 ranks x {s['pairs_rank']} pairs x 512 steps on one card: {steps} steps "
          f"{s['steps_s']:.4f} steps/s (the first included); peak per rank "
          f"{[round(x['peak_gib'], 2) for x in sparse]} GiB; gradient all_reduce "
          f"{[round(a, 2) for a in ar]} ms a step (per rank; the first step included: "
          f"{[[round(v, 2) for v in x['allreduce_ms']] for x in sparse]}); replication check "
          f"{s['replication_check_s']:.2f} s, the ranks agree; losses "
          f"{[round(v, 6) for v in s['losses']]}; K1 / K2 / K3 / M1 launches {s['launches']} "
          f"({time.time() - t0:.1f} s with the start)")
    if sparse[0]["losses"] != sparse[1]["losses"]:
        raise AssertionError("the ranks logged different global losses")
    return ranks, sparse


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
        trainer, train, val, launches, m1_launches = phase_main_path(workspace)
        phase_resume(trainer, workspace)
        m1_infer = phase_inference(trainer, val)
        phase_breakdown(trainer, train)
        phase_mesh("main", trainer, check=True)
        m1 = phase_march_kernel(trainer, train)
        window = phase_window(trainer, train)
        del trainer, train, val
        gc.collect()  # a trainer's captured graph holds its memory pool
        torch.cuda.empty_cache()
        print(f"[memory] after the main path: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        k2_launches, k2_on_path = phase_k2_path()
        phase_no_event(os.path.join(REPO, "build", "chip_smoke_noev"))
        workspace = os.path.join(REPO, "build", "chip_smoke_default")
        trainer, train = phase_default_path(workspace)
        phase_resume(trainer, workspace)
        phase_default_breakdown(trainer, train)
        k1_viewer = phase_viewer(trainer, train, workspace)
        del trainer, train
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[memory] after the default path: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        phase_cli(workspace)
        phase_lpips()
        phase_march_warmup(os.path.join(REPO, "build", "chip_smoke_warmup"))
        datadir, carpet, esim_data = phase_esim_fixture(
            os.path.join(REPO, "build", "chip_smoke_esim"))
        gc.collect()
        torch.cuda.empty_cache()
        spiral1 = phase_esim_frames(datadir, os.path.join(REPO, "build", "chip_smoke_spiral1"))
        gc.collect()
        torch.cuda.empty_cache()
        phase_esim_events(carpet, os.path.join(REPO, "build", "chip_smoke_carpet"))
        gc.collect()
        torch.cuda.empty_cache()
        k1_frames = phase_frames_march(os.path.join(REPO, "build", "chip_smoke_frames_march"))
        tumvie_dir = phase_tumvie_fixture(os.path.join(REPO, "build", "chip_smoke_tumvie"))
        phase_prep(tumvie_dir)
        eds_dir = phase_eds_fixture(esim_data, os.path.join(REPO, "build", "chip_smoke_eds"))
        e1 = phase_event_chains(esim_data, tumvie_dir, eds_dir)
        gc.collect()
        torch.cuda.empty_cache()
        mocap = phase_stereo("tumvie", "mocapDesk2/mocapDesk2_enerf.txt", tumvie_dir,
                             os.path.join(REPO, "build", "chip_smoke_mocapdesk2"), steps=16)
        gc.collect()
        torch.cuda.empty_cache()
        phase_stereo("eds", "eds11/eds11_enerf.txt", eds_dir,
                     os.path.join(REPO, "build", "chip_smoke_eds11"), steps=4)
        gc.collect()
        torch.cuda.empty_cache()
        k1_bg = phase_background(os.path.join(REPO, "build", "chip_smoke_bg"))
        k1_grid_free = phase_grid_free(os.path.join(REPO, "build", "chip_smoke_grid_free"))
        gc.collect()
        torch.cuda.empty_cache()
        k1_clip = phase_clip(datadir, os.path.join(REPO, "build", "chip_smoke_clip"))
        gc.collect()
        torch.cuda.empty_cache()
        dx = phase_position_grads()
        gc.collect()
        torch.cuda.empty_cache()
        dp_nccl = phase_dp_nccl(os.path.join(REPO, "build", "chip_smoke_dp_nccl"))
        gc.collect()
        torch.cuda.empty_cache()
        dp_gloo, dp_sparse = phase_dp_gloo(os.path.join(REPO, "build", "chip_smoke_dp_gloo"),
                                           datadir)
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
        "float32": res["float32"], "bfloat16_E3": res["bfloat16_E3"],
        "bfloat16_E39": res["bfloat16_E39"], "launches_frames_march": k1_frames,
        "launches_viewer": k1_viewer, "launches_background": k1_bg,
        "launches_frequency_KE4": k1_grid_free["frequency"]["launches"],
        "launches_none_KE1": k1_grid_free["none"]["launches"], "launches_clip_march": k1_clip,
        "position_grads": dx, "launches_dp_nccl_step": dp_nccl["k1_launches"],
        "launches_dp_gloo_step_per_rank": [r["k1_launches"] for r in dp_gloo],
        "launches_dp_gloo_view_per_rank": [r["view_k1"] for r in dp_gloo],
        "launches_dp_spiral1_sparse_per_rank": [r["launches"][0] for r in dp_sparse],
    }, dict({
        "name": "block_table_grad", "route": "cuda",
        "source": "enerf_torch/csrc/block_table_grad.cu",
        "replaces": "enerf_tpu/ops/scatter_accum.py:46",
        "launches": k2_launches}, **k2[4], block3=k2[3], k2_path_pairs=k2_on_path),
        dict({
            "name": "group_gather", "route": "cuda",
            "source": "enerf_torch/csrc/group_gather.cu",
            "replaces": "scripts/bench_gather.py:62",
            "launches": k3_launches}, **k3[128], block_grid_table=k3[250]),
        dict({
            "name": "march_rays", "route": "cuda",
            "source": "enerf_torch/csrc/march_rays.cu",
            # a device loop of the JAX package (lax.while_loop in lax.scan),
            # not a Pallas kernel
            "replaces": "enerf_tpu/render/march.py:51",
            "launches": m1_launches}, **m1["pair"], one_render=m1["main"], bench=m1["bench"],
            bench_dt_gamma=m1["bench_dt_gamma"], infer_first_window=m1_infer["first"],
            infer_last_window=m1_infer["last"], window=window, spiral1_window=spiral1,
            mocapdesk2_window=mocap),
        dict({
            "name": "event_chains", "route": "cuda",
            "source": "enerf_torch/csrc/event_chains.cu",
            # a host C++ library of the JAX package (native/event_preproc.cpp
            # through ctypes), not a Pallas kernel
            "replaces": "enerf_tpu/data/native_events.py:63",
            "launches": sum(MAIN_E1["launches"]), "launches_sort_tables": MAIN_E1["launches"],
            "max_abs_err_main_path": MAIN_E1["max_abs_err"]},
            **dict(e1, max_abs_err=max(e1["max_abs_err"], MAIN_E1["max_abs_err"])),
            load_splits=LOAD_SPLITS),
    ]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
