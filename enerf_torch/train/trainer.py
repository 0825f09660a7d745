"""Training orchestration — the port's Trainer.

Counterpart of enerf_tpu/train/trainer.py (reference nerf/utils.py:289-1416):
  - the constructor (the backbone selection: the hash grid and unfused
    MLPs by default, the block grid with --ff / --tcnn, the fused head with
    --ff -O; the march with cuda_ray) and resume from a checkpoint
    ('latest' | 'best' | a path);
  - on the march path, `mark_untrained_grid` from the provider's frame
    poses at the start of `train`, and the occupancy update every 16 steps
    *before* the step;
  - at the start of `train`, the run diagnostics (utils/plotting.py) in
    <workspace>/diagnostics;
  - the per-step loop of `train_step` (JAX's `_step_fn` with the loop's
    cadence, also the viewer's step): the occupancy update, the event
    step, or with events=0 the frames step followed by the error map's
    update, or for a rand-pose batch the CLIP step (rand_pose with
    clip_text, train/clip_guidance.py); the fixed-step renderer for the
    first march_warmup steps; then
    the `[train]` log line, the no-event epoch gate and the `--profile N`
    trace of steps N+1..2N (utils/profiling.py, <workspace>/profile/);
  - the per-epoch tail: epoch loss stats, a rotating checkpoint every
    ckpt_interval epochs, evaluation every eval_interval epochs, the
    best-by-metric checkpoint with the EMA weights, the eval_log JSON line
    and the divergence guard;
  - data parallelism (`mesh`, parallel/mesh.py; the JAX trainer's mesh
    paths): each rank a process with a full replicated state and its shard
    of the batch; the step through `make_sharded_train_step`, the
    occupancy update through `update_occupancy_sharded`, the eval renders
    through `shard_rays`, the error map fed every rank's cells and losses
    in rank order; a shared generator (alike on every rank: the occupancy
    update's full phase, the step's noise, the rand pose) and a per-rank
    one (the batch, the occupancy resampling); a rand-pose batch's CLIP
    step taken on every rank with the gradients meaned over the ranks
    (JAX's runs on the replicated state); the ranks' state checked bit-equal after
    every epoch; rank 0 alone writes (log, args, checkpoints, diagnostics,
    profile, images, mesh);
  - `evaluate` (PSNR, SSIM, LPIPS alex / vgg on the trainer's device and,
    for event-only training, the affine (a, b) log-intensity correction
    solved over all val images; the stereo rigs' event camera views,
    rendered and written with that map), `test`, `render_view` through the
    alive-ray inference renderer (march) or the staged fixed-step
    renderer, and `save_mesh` (the density isosurface, utils/mesh.py).
With fuse_steps > 1 (the default 16) `train` runs each epoch in windows
(train/chunk.py, JAX's trainer.py:391-470): the occupancy update and K
steps, replayed as a CUDA graph on a card; march_warmup and
occ_freeze_after chosen at a window's start; the window's mean logged
when the step count crosses a multiple of log_every; the rest of the
epoch step by step with the per-step cadence, through the window's
step (an epoch shorter than a window runs `train_step`; under a mesh
the epoch is rounded down to whole windows instead, and logged once); a
captured graph is kept across epochs and released before an evaluation
and at the end.  Images are written as PNG by the
port's own writer (no OpenCV).  Not ported: tensorboard.
"""

import dataclasses
import gc
import json
import os
import time

import numpy as np
import torch

from enerf_torch.backend import resolve_device
from enerf_torch.config import TPU_ONLY, check_supported
from enerf_torch.data.rays import get_rays_full
from enerf_torch.models.field import FieldStatic, field_density, init_field_params
from enerf_torch.parallel import mesh as dp
from enerf_torch.parallel import multihost
from enerf_torch.parallel.multihost import gather_rows
from enerf_torch.render.march import render_rays_infer
from enerf_torch.render.occupancy import (
    init_occupancy, mark_untrained_grid, update_occupancy, update_occupancy_sharded,
)
from enerf_torch.render.renderer import render_rays_staged
from enerf_torch.train import metrics as M
from enerf_torch.train.checkpoints import CheckpointManager, load_checkpoint
from enerf_torch.train.chunk import make_train_chunk
from enerf_torch.train.clip_guidance import CLIPGuidance, StubEmbedder
from enerf_torch.train.losses import rgb_to_luma
from enerf_torch.train.state import TrainState
from enerf_torch.train.step import (
    StepStatics, train_step_clip, train_step_events, train_step_frames, warm_statics,
)
from enerf_torch.utils import profiling
from enerf_torch.utils.mesh import extract_fields, marching_tets, to_world, write_obj, write_ply
from enerf_torch.utils.plotting import dump_run_diagnostics
from enerf_torch.utils.png import write_png


def _to8(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


class Trainer:
    def __init__(self, cfg, device=None, workspace=None, use_checkpoint=None, snapshot=True,
                 mesh=None):
        # snapshot=False: a read-only use of a trained workspace (the render
        # tool) keeps its args.json as training wrote it.  mesh: this rank's
        # parallel.mesh.Mesh (its device is the trainer's), None for one process
        self.mesh = mesh
        self.primary = multihost.is_primary()  # rank 0 writes the files
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.cfg = check_supported(cfg)
        if mesh is not None and cfg.rand_pose >= 0 and cfg.multihost:
            raise NotImplementedError(
                "--rand_pose with --multihost: the JAX trainer folds each host's batch key "
                "(enerf_tpu/train/trainer.py:472-475), so its hosts would draw different "
                "rand poses; run it with --mesh_shape or on one process")
        # reference main_nerf.py:46-52: --ff/--tcnn force half precision;
        # here they select the block-packed encoder + bf16 compute, and
        # --ff with the march (-O) selects the fused head (kernel K1);
        # otherwise the reference's hash grid and unfused MLPs
        use_fast = bool(cfg.ff or cfg.tcnn)
        self.static = FieldStatic(
            bound=cfg.bound,
            out_dim_color=cfg.out_dim_color,
            disable_view_direction=bool(cfg.disable_view_direction),
            bg_radius=cfg.bg_radius,
            encoding=(("blockgrid" if use_fast else "hashgrid")
                      if cfg.encoding == "auto" else cfg.encoding),
            use_fused_head=bool(cfg.ff) and bool(cfg.cuda_ray),
            compute_dtype=torch.bfloat16 if (cfg.fp16 or use_fast) else torch.float32,
            grid_block=cfg.grid_block,
            num_levels=cfg.num_levels,
            level_dim=cfg.level_dim,
            density_bias=cfg.density_bias,
            hidden_dim=cfg.hidden_dim,
            hidden_dim_color=cfg.hidden_dim_color,
            geo_feat_dim=cfg.geo_feat_dim,
        )
        self.ss = StepStatics(
            field_static=self.static,
            min_near=cfg.min_near,
            density_scale=cfg.density_scale,
            C_thres=cfg.C_thres,
            event_only=bool(cfg.event_only),
            use_luma=bool(cfg.use_luma),
            linlog=bool(cfg.linlog),
            out_dim_color=cfg.out_dim_color,
            num_steps=cfg.num_steps,
            upsample_steps=cfg.upsample_steps,
            weight_loss_rgb=cfg.weight_loss_rgb,
            use_march=bool(cfg.cuda_ray),
            march_samples=cfg.march_samples,
            max_steps=cfg.max_steps,
            dt_gamma=cfg.dt_gamma,
            compact_frac=cfg.compact_frac,
            share_march=bool(cfg.share_march),
            w_opacity=cfg.w_opacity,
            w_distortion=cfg.w_distortion,
            negative_event_sampling=bool(cfg.negative_event_sampling),
            w_no_ev=cfg.w_no_ev,
            remat_fixed=cfg.remat_fixed,
            warmup_num_steps=cfg.warmup_num_steps,
        )
        # rand-pose CLIP guidance (reference main_nerf.py:183 + clip_utils)
        self.clip_guidance = None
        if cfg.rand_pose >= 0 and cfg.clip_text:
            self.clip_guidance = CLIPGuidance(cfg.clip_text, StubEmbedder(device=self.device))
            self.ss = self.ss._replace(clip_embedder=self.clip_guidance.embedder)
        params = init_field_params(self.static, cfg.seed, self.device)
        self.state = TrainState(params, cfg.lr, cfg.iters)
        # the occupancy grid exists on the march path only (cuda_ray)
        self.occupancy = init_occupancy(cfg.bound, self.device) if cfg.cuda_ray else None
        # alike on every rank; the batch draws from rank_generator, which is
        # the same generator on one process
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.rank_generator = self.generator
        if mesh is not None:
            seed = int(np.random.SeedSequence([cfg.seed + 1, mesh.rank]).generate_state(1)[0])
            self.rank_generator = torch.Generator(device=self.device).manual_seed(seed)
        self._sharded_steps = {}  # warm phase -> make_sharded_train_step
        self._chunk_cache = {}  # window key -> TrainChunk (train/chunk.py)
        self._chunk_round_logged = False

        self.workspace = workspace or os.path.join(cfg.outdir, cfg.expweek, cfg.expname)
        os.makedirs(self.workspace, exist_ok=True)
        self.log_path = os.path.join(self.workspace, "log.txt")
        if snapshot and self.primary:
            with open(os.path.join(self.workspace, "args.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
        self.ckpt = CheckpointManager(os.path.join(self.workspace, "checkpoints"),
                                      name=cfg.expname, max_keep=cfg.max_keep_ckpt,
                                      async_save=bool(cfg.async_ckpt))
        self.epoch = 0
        self.best_metric = -np.inf
        self.stats = {"loss": [], "psnr": []}
        self.history = []     # (step, {loss term: float}) of every logged step
        self.last_eval = {}   # the results of the last evaluate() in train()
        self.epoch_seconds = {}  # the last epoch's steps and tail, synchronized
        self.seconds_by_epoch = {}  # epoch -> its epoch_seconds
        self.lpips_seconds = None  # the last evaluation's LPIPS seconds per view
        self.mesh_seconds = {}  # the last save_mesh's query, extraction and write
        self.diagnostics = []  # what dump_run_diagnostics wrote at the start of train,
        self.diagnostics_seconds = None  # and its seconds
        self.mesh_size = None  # (vertices, triangles) of the last save_mesh
        self.profile_path = None  # the --profile trace, once written
        self._guard_strikes = 0
        self.log(f"[port] device {self.device}; ignoring TPU-only options: "
                 + ", ".join(f"{k}={getattr(cfg, k)}" for k in TPU_ONLY))
        if mesh is not None:
            self.log(f"[mesh] {mesh.world_size} ranks over {mesh.backend}; rank 0 on "
                     f"{mesh.device}")

        if use_checkpoint and use_checkpoint != "scratch":
            path = self.ckpt.resolve(use_checkpoint)
            if path:
                self.state, self.occupancy, meta = load_checkpoint(
                    path, self.state, self.occupancy)
                self.epoch = meta.get("epoch", 0)
                # running stats + best metric, so the first eval after a
                # resume cannot overwrite a better best checkpoint
                st = meta.get("stats") or {}
                for k in ("loss", "psnr"):
                    if isinstance(st.get(k), list):
                        self.stats[k] = list(st[k])
                self.best_metric = float(st.get("best_metric", -np.inf))
                self.log(f"[ckpt] resumed from {path} at epoch {self.epoch}")
        if mesh is not None:
            dp.replicate(self.state, self.occupancy, mesh)
            self.log(f"[mesh] state replicated from rank 0 at step {self.state.step}; "
                     "the ranks agree")

    def log(self, *msg):
        if not self.primary:
            return
        line = " ".join(str(m) for m in msg)
        print(line, flush=True)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")

    def train(self, provider, valid_provider=None, max_epoch=1):
        cfg = self.cfg
        global_step = self.state.step
        steps_per_epoch = getattr(provider, "steps_per_epoch", 100)
        t_start, start_step = time.time(), global_step
        t0 = self._clock()
        if self.primary:
            self.diagnostics = dump_run_diagnostics(self.workspace, provider)
        self.diagnostics_seconds = self._clock() - t0
        for p in self.diagnostics:
            self.log(f"[diag] {p}")
        if self.occupancy is not None and hasattr(provider, "train_poses"):
            self.occupancy = mark_untrained_grid(self.occupancy, provider.train_poses,
                                                 provider.intrinsics, cfg.bound)
            frac = float((self.occupancy.density_grid == -1.0).float().mean())
            self.log(f"[occupancy] marked untrained cells: {frac:.4f} of the grid")

        def log_aux(aux, step):
            aux = {k: float(v) for k, v in aux.items() if v.ndim == 0}
            loss = aux["loss"]
            if not np.isfinite(loss):
                self.log(f"[nan] non-finite loss {loss} at step {step}")
            extras = " ".join(f"{k}={v:.5f}" for k, v in aux.items()
                              if k != "loss" and not k.startswith("implC_"))
            self.log(f"[train] epoch {self.epoch} step {step} loss={loss:.5f} "
                     f"{extras} ({(step - start_step) / (time.time() - t_start):.2f} it/s)")
            self.history.append((step, aux))
            return loss

        prof = {"session": None, "until": None, "done": cfg.profile <= 0 or not self.primary}
        prof_dir = os.path.join(self.workspace, "profile")

        def maybe_profile(step, end=False):
            """--profile K: trace steps K+1..2K (or to the end of train)."""
            if prof["done"]:
                return
            k = cfg.profile
            if prof["session"] is None and step >= k and not end:
                self._clock()
                prof["session"] = profiling.start_trace(self.device.type == "cuda")
                prof["until"] = step + k
            elif prof["session"] is not None and (step >= prof["until"] or end):
                self._clock()
                self.profile_path = profiling.stop_trace(prof["session"], prof_dir)
                prof["done"] = True
                self.log(f"[profile] trace of steps {prof['until'] - k + 1}-{step} -> "
                         f"{self.profile_path}")

        def timed(name, fn, *args):
            t0 = self._clock()
            out = fn(*args)
            self.epoch_seconds[name] = self._clock() - t0
            return out

        # the training window (train/chunk.py, JAX's fuse_steps path): K
        # steps with the occupancy update first, replayed as a CUDA graph on
        # a card; the per-step loop for the rand-pose CLIP batches
        chunk_len = int(cfg.fuse_steps)
        use_chunk = (chunk_len > 1 and self.clip_guidance is None
                     and getattr(provider, "rand_pose", -1) < 0)
        for epoch in range(self.epoch + 1, max_epoch + 1):
            self.epoch = epoch
            if getattr(provider, "noev_coords", None) is not None:
                # no-event loss epoch gate (reference utils.py:548)
                provider.use_no_ev = epoch > cfg.epoch_start_noEvLoss
            epoch_losses, self.epoch_seconds = [], {}
            t_steps = self._clock()
            it = 0
            if use_chunk:
                while it + chunk_len <= steps_per_epoch:
                    chunk = self._chunk(provider, chunk_len, global_step)
                    self.occupancy, aux = chunk(
                        self.state, self.occupancy, provider, self.generator,
                        self.rank_generator)
                    prev = global_step
                    it += chunk_len
                    global_step += chunk_len
                    maybe_profile(global_step)
                    if global_step // cfg.log_every != prev // cfg.log_every:
                        epoch_losses.append(log_aux(aux, global_step))
                if self.mesh is not None and it < steps_per_epoch:
                    # the window's global batch is world size x the per-step
                    # path's: no mixing within an epoch (JAX's trainer)
                    if not self._chunk_round_logged:
                        self._chunk_round_logged = True
                        self.log(f"[train] mesh chunking: {steps_per_epoch} steps/epoch "
                                 f"rounded down to {it} (whole {chunk_len}-step windows)")
                    it = steps_per_epoch
            windowed = it > 0
            for _ in range(it, steps_per_epoch):
                if windowed:
                    # the per-step path's cadence through the window's
                    # step: on a card, one replay of its captured graph
                    self.occupancy, aux = self._chunk(provider, chunk_len, global_step)(
                        self.state, self.occupancy, provider, self.generator,
                        self.rank_generator, steps=1, update=global_step % 16 == 0)
                else:
                    aux = self.train_step(provider)
                global_step += 1
                maybe_profile(global_step)
                if global_step % cfg.log_every == 0:
                    epoch_losses.append(log_aux(aux, global_step))
            self.epoch_seconds["steps"] = self._clock() - t_steps
            if self.mesh is not None:
                timed("replication check", dp.assert_replicated, self.state, self.occupancy,
                      self.mesh)

            if epoch_losses:
                self.stats["loss"].append(float(np.mean(epoch_losses)))
            if epoch % max(cfg.ckpt_interval, 1) == 0 or epoch == max_epoch:
                timed("checkpoint", self.ckpt.save, self.state, self.occupancy, epoch,
                      self.stats)
            if valid_provider is not None and epoch % cfg.eval_interval == 0:
                self._release_windows()
                results = self.last_eval = timed("evaluate", self.evaluate, valid_provider)
                metric = results.get("psnr_corrected", results.get("psnr", 0.0))
                self.stats["psnr"].append(metric)
                if metric > self.best_metric:
                    self.best_metric = metric
                    self.stats["best_metric"] = float(metric)
                    timed("best checkpoint", self.ckpt.save_best, self.state,
                          self.occupancy, epoch, self.stats)
                if self._eval_log(results, global_step):
                    self.log(f"[guard] collapse: halting at epoch {epoch} — "
                             f"{cfg.guard_patience} consecutive bad evals (best corrected "
                             f"{self.best_metric:.2f} dB is checkpointed); rerun from "
                             "the best ckpt with a lower lr to continue")
                    break
            self.seconds_by_epoch[epoch] = self.epoch_seconds
            self.log(f"[epoch] {epoch}: " + ", ".join(
                f"{k} {v:.2f} s" for k, v in self.epoch_seconds.items()))
        self._release_windows()
        maybe_profile(global_step, end=True)
        self.ckpt.wait()
        self.log(f"[train] done at epoch {self.epoch}, step {global_step}")

    def _chunk(self, provider, chunk_len, step):
        """The window to run at `step` (JAX's get_chunk): march_warmup and
        occ_freeze_after chosen at the window's start, one window per
        (mode, provider and its no-event gate, K, mesh, warm, frozen); on a
        card only the window in use keeps its captured graph."""
        cfg = self.cfg
        warm = step < cfg.march_warmup
        frozen = cfg.occ_freeze_after > 0 and step >= cfg.occ_freeze_after
        mode = "events" if cfg.events else "frames"
        key = (mode, id(provider), getattr(provider, "use_no_ev", None), chunk_len,
               self.mesh is not None, warm, frozen)
        if key not in self._chunk_cache:
            self._chunk_cache[key] = make_train_chunk(
                warm_statics(self.ss) if warm else self.ss, mode, chunk_len=chunk_len,
                use_occ=self.occupancy is not None, freeze_occ=frozen,
                density_scale=cfg.density_scale, density_thresh=cfg.density_thresh,
                error_map=bool(cfg.error_map) and getattr(provider, "error_map", None)
                is not None, mesh=self.mesh)
            if self.mesh is not None:
                self.log(f"[train] {chunk_len}-step windows over {self.mesh.world_size} ranks: "
                         "each rank samples the config's batch; the window runs eagerly (a "
                         "mesh window is not captured in a CUDA graph)")
        chunk = self._chunk_cache[key]
        for other in self._chunk_cache.values():
            if other is not chunk:
                other.release()
        return chunk

    def _release_windows(self):
        """Free the windows' captured graphs and their memory pools, and the
        gradients the capture left there, before an evaluation and at the
        end of `train`: a graph's pool holds a whole step's memory.  The
        next window captures again."""
        if not any(chunk.graph is not None for chunk in self._chunk_cache.values()):
            return
        for chunk in self._chunk_cache.values():
            chunk.release()
        self.state.zero_grad()
        gc.collect()
        torch.cuda.empty_cache()

    def train_step(self, provider):
        """One training step at self.state.step (the counterpart of JAX's
        `_step_fn` with the loop's cadence): the occupancy update every 16
        steps before the step (march path, until occ_freeze_after), one
        batch, the event or frames step (the fixed-step renderer for the
        first march_warmup steps), the error map's update; a rand-pose batch
        takes the CLIP step instead.  Returns aux."""
        cfg, step = self.cfg, self.state.step
        freeze = cfg.occ_freeze_after > 0 and step >= cfg.occ_freeze_after
        if self.occupancy is not None and step % 16 == 0 and not freeze:
            kw = dict(density_scale=cfg.density_scale, density_thresh=cfg.density_thresh)
            if self.mesh is None:
                self.occupancy = update_occupancy(
                    self.state.params, self.static, self.occupancy, self.generator, **kw)
            else:
                self.occupancy = update_occupancy_sharded(
                    self.state.params, self.static, self.occupancy, self.generator,
                    self.rank_generator, mesh=self.mesh, **kw)
        # a rand pose is drawn from the shared generator: under a mesh every
        # rank takes the same CLIP step (JAX's runs on the replicated state)
        pose_kw = ({"pose_generator": self.generator}
                   if getattr(provider, "rand_pose", -1) >= 0 else {})
        batch = provider.train_step_batch(self.rank_generator, **pose_kw)
        warm = step < cfg.march_warmup
        ss = warm_statics(self.ss) if warm else self.ss
        occ = self.occupancy.occ_packed if self.occupancy is not None else None
        if "rand_pose_side" in batch:  # no error-map update on this batch
            if self.clip_guidance is None:  # JAX asserts (trainer.py:250)
                raise ValueError("--rand_pose >= 0 gives rand-pose batches, which need "
                                 "--clip_text (the CLIP guidance's text)")
            side = batch.pop("rand_pose_side")
            reduce = (None if self.mesh is None
                      else lambda params: dp.all_reduce_grads(params, self.mesh))
            return train_step_clip(self.state, batch, ss, occ, self.clip_guidance.text_feat,
                                   side, generator=self.generator, reduce_grads=reduce)
        errmap = cfg.error_map and hasattr(provider, "update_error_map")
        if self.mesh is None:
            step_fn = train_step_events if cfg.events else train_step_frames
            aux = step_fn(self.state, batch, ss, occ, generator=self.generator)
            if errmap:
                provider.update_error_map(aux["per_ray_loss"])
            return aux
        if warm not in self._sharded_steps:
            self._sharded_steps[warm] = dp.make_sharded_train_step(
                ss, self.mesh, "events" if cfg.events else "frames")
        aux = self._sharded_steps[warm](self.state, batch, occ, generator=self.generator)
        if errmap:  # every rank's cells and per-ray losses, in rank order
            cells = [gather_rows(x, self.mesh.group) for x in provider.error_map_cells()]
            provider.update_error_map(aux["per_ray_loss"], cells)
        return aux

    def _clock(self):
        """Host seconds, once the device's queued work has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()

    def _eval_log(self, results, global_step):
        """Append the eval record to cfg.eval_log (if set) and run the
        divergence guard: True after guard_patience consecutive evals at
        least guard_psnr_drop dB below the best corrected PSNR or, for
        event-only training, with an affine gain a < guard_affine_a."""
        cfg = self.cfg
        if cfg.eval_log and self.primary:
            rec = {"ts": time.time(), "workspace": self.workspace,
                   "epoch": self.epoch, "step": int(global_step)}
            rec.update({k: (float(v) if v is not None and np.ndim(v) == 0 else v)
                        for k, v in results.items()})
            os.makedirs(os.path.dirname(os.path.abspath(cfg.eval_log)), exist_ok=True)
            with open(cfg.eval_log, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if not cfg.guard_collapse:
            return False
        metric = results.get("psnr_corrected", results.get("psnr"))
        bad = (metric is not None and self.best_metric > -np.inf
               and metric <= self.best_metric - cfg.guard_psnr_drop)
        a = results.get("affine_a")
        if a is not None and float(a) < cfg.guard_affine_a:
            bad = True
        self._guard_strikes = self._guard_strikes + 1 if bad else 0
        if bad:
            self.log(f"[guard] strike {self._guard_strikes}: metric={metric} "
                     f"best={self.best_metric:.3f} affine_a={a}")
        return self._guard_strikes >= cfg.guard_patience

    @torch.no_grad()
    def render_view(self, pose, intrinsics, H, W):
        """Full-image render with the EMA weights -> (image [H, W, C],
        depth [H, W]) numpy, in chunks of max_ray_batch rays: through the
        alive-ray inference renderer on the march path, else the fixed-step
        renderer without jitter.  Under a mesh every rank renders its share
        of the rays (the march path through make_sharded_render, as the JAX
        trainer does) and every rank gets the whole image."""
        params = self.state.ema_params
        pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=self.device)
        ro, rd = get_rays_full(pose, intrinsics, H, W)
        C = self.static.out_dim_color
        cfg, out = self.cfg, None
        if self.occupancy is None:
            def render(o, d):
                return render_rays_staged(
                    params, self.static, o, d, max_ray_batch=cfg.max_ray_batch,
                    num_steps=cfg.num_steps, upsample_steps=cfg.upsample_steps, bg_color=1.0,
                    perturb=False, train=False, min_near=cfg.min_near,
                    density_scale=cfg.density_scale)

            out = render(ro, rd) if self.mesh is None else dp.shard_rays(render, self.mesh, ro, rd)
        elif self.mesh is not None:
            # the JAX trainer's eval depth: a live-sample buffer of twice the
            # training one, at least 128
            out = dp.make_sharded_render(
                self.static, self.mesh, num_samples=max(2 * cfg.march_samples, 128),
                max_steps=self.ss.max_steps, min_near=cfg.min_near,
                density_scale=cfg.density_scale, dt_gamma=cfg.dt_gamma,
            )(params, self.occupancy.occ_packed, ro, rd)
        if out is not None:
            return (out["image"].reshape(H, W, C).cpu().numpy(),
                    out["depth"].reshape(H, W).cpu().numpy())
        chunk = min(int(self.cfg.max_ray_batch), ro.shape[0])
        images, depths = [], []
        for s in range(0, ro.shape[0], chunk):
            co, cd = ro[s:s + chunk], rd[s:s + chunk]
            pad = chunk - co.shape[0]
            if pad:  # keep one chunk shape, like the JAX package
                co = torch.cat([co, co[-1:].expand(pad, 3)])
                cd = torch.cat([cd, cd[-1:].expand(pad, 3)])
            o = render_rays_infer(
                params, self.static, self.occupancy.occ_packed, co, cd,
                block=16, max_steps=self.ss.max_steps, bg_color=1.0,
                min_near=self.cfg.min_near, density_scale=self.cfg.density_scale,
                dt_gamma=self.cfg.dt_gamma)
            n = chunk - pad
            images.append(o["image"][:n])
            depths.append(o["depth"][:n])
        img = torch.cat(images).reshape(H, W, C).cpu().numpy()
        return img, torch.cat(depths).reshape(H, W).cpu().numpy()

    def _log_intensity(self, img):
        """An image in [0, 1] -> log(255 * luma + 1e-3), as the reference's
        corrected evaluation takes it (utils.py:1170-1265)."""
        if self.static.out_dim_color == 3:
            img = rgb_to_luma(torch.as_tensor(img)).numpy()
        return np.log(255.0 * img + 1e-3)

    def affine_corrected(self, preds, gts):
        """The event-only evaluation's correction (utils.py:1170-1265): one
        affine map (a, b) of log intensity fitted over all the images, then
        PSNR and SSIM of the corrected predictions on a 0-255 scale.
        Returns dict(affine_a, affine_b, psnr_corrected, ssim_corrected)."""
        p_logs = np.stack([self._log_intensity(p) for p in preds])
        g_logs = np.stack([self._log_intensity(g) for g in gts])
        a, b = M.solve_normal_equations(p_logs, g_logs)
        psnrs_c, ssims_c = [], []
        for j in range(len(preds)):
            pred_c = np.exp(p_logs[j] * a + b)
            gt255 = np.exp(g_logs[j])
            psnrs_c.append(M.psnr(pred_c, gt255, max_val=255.0))
            ssims_c.append(M.ssim(pred_c[..., 0], gt255[..., 0], data_range=255.0))
        return {"affine_a": a, "affine_b": b, "psnr_corrected": float(np.mean(psnrs_c)),
                "ssim_corrected": float(np.mean(ssims_c))}

    def evaluate(self, provider, save=True):
        """Reference evaluate_one_epoch, with the event-only (a, b) correction."""
        if self.occupancy is not None:
            occ_frac = float(self.occupancy.occ_bitfield.float().mean())
            self.log(f"[occ] occupied fraction {occ_frac:.4f} "
                     f"mean_density {float(self.occupancy.mean_density):.5f}")
        views = provider.val_views()
        preds, gts, depths = [], [], []
        for v in views:
            img, depth = self.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
            preds.append(img)
            depths.append(depth)
            gts.append(np.asarray(v["gt"]) if v.get("gt") is not None else None)

        results = {}
        have_gt = [i for i, g in enumerate(gts) if g is not None]
        if have_gt:
            results["psnr"] = float(np.mean([M.psnr(preds[i], gts[i]) for i in have_gt]))
            results["ssim"] = float(np.mean([M.ssim(preds[i], gts[i]) for i in have_gt]))
            # per-image LPIPS on the trainer's device, averaged over the val
            # set (reference utils.py:1096-1112 computes alex + vgg per image)
            t0 = self._clock()
            lp = [M.compute_lpips(preds[i], gts[i], self.static.out_dim_color, self.device)
                  for i in have_gt]
            self.lpips_seconds = (self._clock() - t0) / len(have_gt)
            suf = M.lpips_label()
            results[f"lpips_alex{suf}"] = float(np.mean([a for a, _ in lp]))
            results[f"lpips_vgg{suf}"] = float(np.mean([v for _, v in lp]))
        if self.cfg.event_only and have_gt:
            # affine log correction over ALL val images; with the frame
            # term the frames fix the scale, and JAX corrects nothing
            results.update(self.affine_corrected([preds[i] for i in have_gt],
                                                 [gts[i] for i in have_gt]))

        if save and self.primary:
            vdir = os.path.join(self.workspace, "validation")
            for sub in ("prediction", "depth", "gt"):
                os.makedirs(os.path.join(vdir, sub), exist_ok=True)
            for j, (p, d) in enumerate(zip(preds, depths)):
                name = f"ep{self.epoch:04d}_{j:04d}.png"
                write_png(os.path.join(vdir, "prediction", name), _to8(p))
                write_png(os.path.join(vdir, "depth", name), _to8(d))
                if gts[j] is not None:
                    write_png(os.path.join(vdir, "gt", f"{j:04d}.png"), _to8(gts[j]))
        stereo = getattr(provider, "stereo_views", None)
        if self.cfg.eval_stereo_views and stereo and save:
            self.write_stereo_views(stereo, results.get("affine_a"), results.get("affine_b"))
        self.log(f"[eval] epoch {self.epoch}: "
                 + " ".join(f"{k}={v}" for k, v in results.items()))
        return results

    def write_stereo_views(self, views, a=None, b=None):
        """The event camera's views of a stereo rig (tumvie / eds; reference
        utils.py:1186-1255), no metrics: under validation/event_view/,
        ep<epoch>_<j>_raw.npy (the render), ep<epoch>_<j>.png (mapped
        through the affine log correction (a, b) when there is one) and
        ep<epoch>_<j>_depth.png."""
        evdir = os.path.join(self.workspace, "validation", "event_view")
        os.makedirs(evdir, exist_ok=True)
        for j, v in enumerate(views):
            img, depth = self.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
            if not self.primary:
                continue
            name = os.path.join(evdir, f"ep{self.epoch:04d}_{j:04d}")
            np.save(name + "_raw.npy", img)
            if a is not None:
                lum = np.exp(self._log_intensity(img) * a + b)
                img8 = np.rint(np.clip(lum, 0, 255)).astype(np.uint8)[..., 0]
            else:
                img8 = _to8(img[..., 0])
            write_png(name + ".png", img8)
            write_png(name + "_depth.png", _to8(depth))

    def test(self, provider, out_dir=None):
        """Render the test views to <out_dir> (reference Trainer.test):
        <j>.png, <j>_depth.png and <j>_raw.npy."""
        out_dir = out_dir or os.path.join(self.workspace, "results")
        os.makedirs(out_dir, exist_ok=True)
        for j, v in enumerate(provider.test_views()):
            img, depth = self.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
            if not self.primary:
                continue
            write_png(os.path.join(out_dir, f"{j:04d}.png"), _to8(img))
            write_png(os.path.join(out_dir, f"{j:04d}_depth.png"), _to8(depth))
            np.save(os.path.join(out_dir, f"{j:04d}_raw.npy"), img)
        self.log(f"[test] wrote renders to {out_dir}")

    @torch.no_grad()
    def save_mesh(self, path=None, resolution=256, threshold=10.0):
        """The density isosurface of the EMA weights (reference save_mesh,
        utils.py:712-732): field_density on a resolution^3 grid over the
        bound's box, marching tetrahedra on the trainer's device, written
        to meshes/{expname}_ep{epoch:04d}.obj (.ply by suffix).  The
        query, extraction and write seconds go to self.mesh_seconds.  Under
        a mesh rank 0 alone exports it; the others return None."""
        if not self.primary:
            return None
        path = path or os.path.join(self.workspace, "meshes",
                                    f"{self.cfg.expname}_ep{self.epoch:04d}.obj")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        bmin, bmax = [-self.static.bound] * 3, [self.static.bound] * 3
        params = self.state.ema_params

        def query(pts):
            return field_density(params, self.static, pts)[0]

        t0 = self._clock()
        u = extract_fields(bmin, bmax, resolution, query, device=self.device)
        t1 = self._clock()
        verts, tris = marching_tets(u, threshold)
        verts = to_world(verts, bmin, bmax, resolution)
        t2 = self._clock()
        (write_ply if path.endswith(".ply") else write_obj)(path, verts, tris)
        self.mesh_seconds = {"query": t1 - t0, "extract": t2 - t1, "write": time.time() - t2}
        self.mesh_size = (len(verts), len(tris))
        self.log(f"[mesh] {len(verts)} verts / {len(tris)} tris -> {path} ("
                 + ", ".join(f"{k} {v:.2f} s" for k, v in self.mesh_seconds.items()) + ")")
        return path
