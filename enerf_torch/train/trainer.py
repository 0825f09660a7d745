"""Training orchestration — the port's Trainer.

Counterpart of enerf_tpu/train/trainer.py (reference nerf/utils.py:289-1416)
for this slice: the constructor (the --ff / -O backbone selection), the
per-step loop with the occupancy update every 16 steps *before* the step,
the `[train]` log line, and `render_view` through the alive-ray inference
renderer.  One step runs per dispatch (the JAX package's fused multi-step
window, train/chunk.py, has no counterpart).  Evaluation with the affine
correction, checkpoints, tensorboard, diagnostics and meshes are not
ported yet.
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
from enerf_torch.render.occupancy import init_occupancy, update_occupancy
from enerf_torch.train.state import TrainState
from enerf_torch.train.step import StepStatics, train_step_events


class Trainer:
    def __init__(self, cfg, device=None, workspace=None):
        self.device = resolve_device(device)
        self.cfg = check_supported(cfg)
        # reference main_nerf.py:46-52: --ff/--tcnn force half precision;
        # here they select the block-packed encoder + bf16 compute, and
        # --ff with the march (-O) selects the fused head (kernel K1)
        use_fast = bool(cfg.ff or cfg.tcnn)
        self.static = FieldStatic(
            bound=cfg.bound,
            out_dim_color=cfg.out_dim_color,
            disable_view_direction=bool(cfg.disable_view_direction),
            bg_radius=cfg.bg_radius,
            encoding="blockgrid" if cfg.encoding == "auto" else cfg.encoding,
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
            march_samples=cfg.march_samples,
            max_steps=cfg.max_steps,
            dt_gamma=cfg.dt_gamma,
            compact_frac=cfg.compact_frac,
            share_march=bool(cfg.share_march),
            w_opacity=cfg.w_opacity,
            w_distortion=cfg.w_distortion,
        )
        params = init_field_params(self.static, cfg.seed, self.device)
        self.state = TrainState(params, cfg.lr, cfg.iters)
        self.occupancy = init_occupancy(cfg.bound, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

        self.workspace = workspace or os.path.join(cfg.outdir, cfg.expweek, cfg.expname)
        os.makedirs(self.workspace, exist_ok=True)
        self.log_path = os.path.join(self.workspace, "log.txt")
        with open(os.path.join(self.workspace, "args.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
        self.epoch = 0
        self.history = []  # (step, loss) of every logged step
        self.log(f"[port] device {self.device}; ignoring TPU-only options: "
                 + ", ".join(f"{k}={getattr(cfg, k)}" for k in TPU_ONLY))

    def log(self, *msg):
        line = " ".join(str(m) for m in msg)
        print(line, flush=True)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")

    def train(self, provider, max_epoch=1):
        cfg = self.cfg
        global_step = self.state.step
        steps_per_epoch = getattr(provider, "steps_per_epoch", 100)
        t_start, start_step = time.time(), global_step

        def log_aux(aux, step):
            loss = float(aux["loss"])
            if not np.isfinite(loss):
                self.log(f"[nan] non-finite loss {loss} at step {step}")
            extras = " ".join(f"{k}={float(v):.5f}" for k, v in aux.items()
                              if k != "loss" and not k.startswith("implC_"))
            self.log(f"[train] epoch {self.epoch} step {step} loss={loss:.5f} "
                     f"{extras} ({(step - start_step) / (time.time() - t_start):.2f} it/s)")
            self.history.append((step, loss))

        for epoch in range(self.epoch + 1, max_epoch + 1):
            self.epoch = epoch
            for _ in range(steps_per_epoch):
                freeze = cfg.occ_freeze_after > 0 and global_step >= cfg.occ_freeze_after
                if global_step % 16 == 0 and not freeze:
                    self.occupancy = update_occupancy(
                        self.state.params, self.static, self.occupancy,
                        self.generator, density_scale=cfg.density_scale,
                        density_thresh=cfg.density_thresh)
                batch = provider.train_step_batch(self.generator)
                aux = train_step_events(self.state, batch, self.ss,
                                        self.occupancy.occ_bitfield,
                                        generator=self.generator)
                global_step += 1
                if global_step % cfg.log_every == 0:
                    log_aux(aux, global_step)
        self.log(f"[train] done at epoch {self.epoch}, step {global_step}")

    @torch.no_grad()
    def render_view(self, pose, intrinsics, H, W):
        """Full-image render with the EMA weights -> (image [H, W, C],
        depth [H, W]) numpy, through the alive-ray inference renderer in
        chunks of max_ray_batch rays."""
        params = self.state.ema_params
        pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=self.device)
        ro, rd = get_rays_full(pose, intrinsics, H, W)
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
        C = self.static.out_dim_color
        img = torch.cat(images).reshape(H, W, C).cpu().numpy()
        return img, torch.cat(depths).reshape(H, W).cpu().numpy()
