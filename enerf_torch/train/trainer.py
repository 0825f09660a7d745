"""Training orchestration — the port's Trainer.

Counterpart of enerf_tpu/train/trainer.py (reference nerf/utils.py:289-1416):
  - the constructor (the backbone selection: the hash grid and unfused
    MLPs by default, the block grid with --ff / --tcnn, the fused head with
    --ff -O; the march with cuda_ray) and resume from a checkpoint
    ('latest' | 'best' | a path);
  - on the march path, `mark_untrained_grid` from the provider's frame
    poses at the start of `train`, and the occupancy update every 16 steps
    *before* the step;
  - the per-step loop, with the fixed-step renderer for the first
    march_warmup steps, the `[train]` log line and the no-event epoch gate;
  - the per-epoch tail: epoch loss stats, a rotating checkpoint every
    ckpt_interval epochs, evaluation every eval_interval epochs, the
    best-by-metric checkpoint with the EMA weights, the eval_log JSON line
    and the divergence guard;
  - `evaluate` (PSNR, SSIM and, for event-only training, the affine (a, b)
    log-intensity correction solved over all val images), `test`, and
    `render_view` through the alive-ray inference renderer (march) or the
    staged fixed-step renderer.
One step runs per dispatch (the JAX package's fused multi-step window,
train/chunk.py, has no counterpart).  Images are written as PNG by the
port's own writer (no OpenCV).  Not ported: LPIPS (reported as None),
stereo event views, tensorboard, run diagnostics and meshes.
"""

import dataclasses
import json
import os
import time

import numpy as np
import torch

from enerf_torch.backend import resolve_device
from enerf_torch.config import TPU_ONLY, check_supported
from enerf_torch.data.rays import get_rays_full
from enerf_torch.models.field import FieldStatic, init_field_params
from enerf_torch.render.march import pack_bitfield, render_rays_infer
from enerf_torch.render.occupancy import init_occupancy, mark_untrained_grid, update_occupancy
from enerf_torch.render.renderer import render_rays_staged
from enerf_torch.train import metrics as M
from enerf_torch.train.checkpoints import CheckpointManager, load_checkpoint
from enerf_torch.train.losses import rgb_to_luma
from enerf_torch.train.state import TrainState
from enerf_torch.train.step import StepStatics, train_step_events, warm_statics
from enerf_torch.utils.png import write_png


def _to8(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


class Trainer:
    def __init__(self, cfg, device=None, workspace=None, use_checkpoint=None):
        self.device = resolve_device(device)
        self.cfg = check_supported(cfg)
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
        params = init_field_params(self.static, cfg.seed, self.device)
        self.state = TrainState(params, cfg.lr, cfg.iters)
        # the occupancy grid exists on the march path only (cuda_ray)
        self.occupancy = init_occupancy(cfg.bound, self.device) if cfg.cuda_ray else None
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

        self.workspace = workspace or os.path.join(cfg.outdir, cfg.expweek, cfg.expname)
        os.makedirs(self.workspace, exist_ok=True)
        self.log_path = os.path.join(self.workspace, "log.txt")
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
        self._guard_strikes = 0
        self.log(f"[port] device {self.device}; ignoring TPU-only options: "
                 + ", ".join(f"{k}={getattr(cfg, k)}" for k in TPU_ONLY))
        self.log("[port] LPIPS is not ported: evaluation reports lpips_alex and "
                 "lpips_vgg as None")

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

    def log(self, *msg):
        line = " ".join(str(m) for m in msg)
        print(line, flush=True)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")

    def train(self, provider, valid_provider=None, max_epoch=1):
        cfg = self.cfg
        global_step = self.state.step
        steps_per_epoch = getattr(provider, "steps_per_epoch", 100)
        t_start, start_step = time.time(), global_step
        if self.occupancy is not None and hasattr(provider, "train_poses"):
            self.occupancy = mark_untrained_grid(self.occupancy, provider.train_poses,
                                                 provider.intrinsics, cfg.bound)
            frac = float((self.occupancy.density_grid == -1.0).float().mean())
            self.log(f"[occupancy] marked untrained cells: {frac:.4f} of the grid")

        def log_aux(aux, step):
            aux = {k: float(v) for k, v in aux.items()}
            loss = aux["loss"]
            if not np.isfinite(loss):
                self.log(f"[nan] non-finite loss {loss} at step {step}")
            extras = " ".join(f"{k}={v:.5f}" for k, v in aux.items()
                              if k != "loss" and not k.startswith("implC_"))
            self.log(f"[train] epoch {self.epoch} step {step} loss={loss:.5f} "
                     f"{extras} ({(step - start_step) / (time.time() - t_start):.2f} it/s)")
            self.history.append((step, aux))
            return loss

        def timed(name, fn, *args):
            t0 = self._clock()
            out = fn(*args)
            self.epoch_seconds[name] = self._clock() - t0
            return out

        for epoch in range(self.epoch + 1, max_epoch + 1):
            self.epoch = epoch
            if getattr(provider, "noev_coords", None) is not None:
                # no-event loss epoch gate (reference utils.py:548)
                provider.use_no_ev = epoch > cfg.epoch_start_noEvLoss
            epoch_losses, self.epoch_seconds = [], {}
            t_steps = self._clock()
            for _ in range(steps_per_epoch):
                freeze = cfg.occ_freeze_after > 0 and global_step >= cfg.occ_freeze_after
                if self.occupancy is not None and global_step % 16 == 0 and not freeze:
                    self.occupancy = update_occupancy(
                        self.state.params, self.static, self.occupancy,
                        self.generator, density_scale=cfg.density_scale,
                        density_thresh=cfg.density_thresh)
                batch = provider.train_step_batch(self.generator)
                # the march_warmup phase: uniform fixed-step renders first
                ss = warm_statics(self.ss) if global_step < cfg.march_warmup else self.ss
                occ = self.occupancy.occ_bitfield if self.occupancy is not None else None
                aux = train_step_events(self.state, batch, ss, occ, generator=self.generator)
                global_step += 1
                if global_step % cfg.log_every == 0:
                    epoch_losses.append(log_aux(aux, global_step))
            self.epoch_seconds["steps"] = self._clock() - t_steps

            if epoch_losses:
                self.stats["loss"].append(float(np.mean(epoch_losses)))
            if epoch % max(cfg.ckpt_interval, 1) == 0 or epoch == max_epoch:
                timed("checkpoint", self.ckpt.save, self.state, self.occupancy, epoch,
                      self.stats)
            if valid_provider is not None and epoch % cfg.eval_interval == 0:
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
            self.log(f"[epoch] {epoch}: " + ", ".join(
                f"{k} {v:.2f} s" for k, v in self.epoch_seconds.items()))
        self.ckpt.wait()
        self.log(f"[train] done at epoch {self.epoch}, step {global_step}")

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
        if cfg.eval_log:
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
        renderer without jitter."""
        params = self.state.ema_params
        pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=self.device)
        ro, rd = get_rays_full(pose, intrinsics, H, W)
        C = self.static.out_dim_color
        if self.occupancy is None:
            cfg = self.cfg
            out = render_rays_staged(
                params, self.static, ro, rd, max_ray_batch=cfg.max_ray_batch,
                num_steps=cfg.num_steps, upsample_steps=cfg.upsample_steps, bg_color=1.0,
                perturb=False, train=False, min_near=cfg.min_near,
                density_scale=cfg.density_scale)
            return (out["image"].reshape(H, W, C).cpu().numpy(),
                    out["depth"].reshape(H, W).cpu().numpy())
        packed = pack_bitfield(self.occupancy.occ_bitfield)
        chunk = min(int(self.cfg.max_ray_batch), ro.shape[0])
        images, depths = [], []
        for s in range(0, ro.shape[0], chunk):
            co, cd = ro[s:s + chunk], rd[s:s + chunk]
            pad = chunk - co.shape[0]
            if pad:  # keep one chunk shape, like the JAX package
                co = torch.cat([co, co[-1:].expand(pad, 3)])
                cd = torch.cat([cd, cd[-1:].expand(pad, 3)])
            o = render_rays_infer(
                params, self.static, self.occupancy.occ_bitfield, co, cd,
                block=16, max_steps=self.ss.max_steps, bg_color=1.0,
                min_near=self.cfg.min_near, density_scale=self.cfg.density_scale,
                dt_gamma=self.cfg.dt_gamma, occ_packed=packed)
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
            results["lpips_alex"] = results["lpips_vgg"] = None  # not ported
        if self.cfg.event_only and have_gt:
            # affine log correction over ALL val images; with the frame
            # term the frames fix the scale, and JAX corrects nothing
            results.update(self.affine_corrected([preds[i] for i in have_gt],
                                                 [gts[i] for i in have_gt]))

        if save:
            vdir = os.path.join(self.workspace, "validation")
            for sub in ("prediction", "depth", "gt"):
                os.makedirs(os.path.join(vdir, sub), exist_ok=True)
            for j, (p, d) in enumerate(zip(preds, depths)):
                name = f"ep{self.epoch:04d}_{j:04d}.png"
                write_png(os.path.join(vdir, "prediction", name), _to8(p))
                write_png(os.path.join(vdir, "depth", name), _to8(d))
                if gts[j] is not None:
                    write_png(os.path.join(vdir, "gt", f"{j:04d}.png"), _to8(gts[j]))
        self.log(f"[eval] epoch {self.epoch}: "
                 + " ".join(f"{k}={v}" for k, v in results.items()))
        return results

    def test(self, provider, out_dir=None):
        """Render the test views to <out_dir> (reference Trainer.test):
        <j>.png, <j>_depth.png and <j>_raw.npy."""
        out_dir = out_dir or os.path.join(self.workspace, "results")
        os.makedirs(out_dir, exist_ok=True)
        for j, v in enumerate(provider.test_views()):
            img, depth = self.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
            write_png(os.path.join(out_dir, f"{j:04d}.png"), _to8(img))
            write_png(os.path.join(out_dir, f"{j:04d}_depth.png"), _to8(depth))
            np.save(os.path.join(out_dir, f"{j:04d}_raw.npy"), img)
        self.log(f"[test] wrote renders to {out_dir}")
