"""Plain reference of the first training steps of E-NeRF's two losses,
followed on the trainer's own random draws (reference/batch.py):

  - the event loss (event_only, C_thres > 0; E-NeRF utils.py:482-528): two
    renders of each event's pixel ray, at the poses of the event and of
    its successor, against one background colour; the lin-log intensity
    (linear below 20, log above) of 255 x the render; the loss
    mean((L2 - L1 - polarity x C_thres)^2);
  - the frame loss (events = 0; utils.py:586-604): one render of each
    pixel ray against a per-pixel background colour, mean((image - gt)^2);
  - Adam (betas 0.9, 0.99, eps 1e-15; the learning rate lr x
    0.1^min(n / iters, 1) at n updates before this one), then the EMA
    shadow with decay min(0.95, (1 + n) / (10 + n)) (the JAX package's
    count: torch_ema's counts this update too, see PERF.md).

The loss is a mean over the batch, so it is worked out in blocks of rays
whose gradients add up: the reference fits beside nothing on the card.
Each render casts the MLP weights to the compute precision once, so each
render's weight gradient, summed over all its blocks, is rounded once
(reference/field.py); the table's gradient is summed in float32.
`fault="half_batch"` leaves out the second half of each batch and takes
the mean over the rest, a fault the comparison has to catch.
"""

import numpy as np
import torch

from benchmark.reference import batch as B
from benchmark.reference.field import Field, round_grad
from benchmark.reference.render import render

BETA1, BETA2, EPS = 0.9, 0.99, 1e-15


def lin_log(x, thres=20.0):
    slope = float(np.log(np.float32(thres)) / np.float32(thres))
    return torch.where(x < thres, slope * x, torch.log(x.clamp(min=1e-20)))


class Follower:
    """The first steps of a training run, from the run's weights and
    inputs: `inputs` holds what the benchmark generated (see data.py)."""

    def __init__(self, cfg, weights, inputs, seed, device, precision=torch.bfloat16,
                 fault=None, block=1024):
        self.cfg, self.device, self.fault, self.block = cfg, device, fault, block
        self.field = Field(cfg, device, precision)
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in weights.items()}
        self.ema = {k: v.detach().clone().float() for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.ema.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.ema.items()}
        self.n = 0
        self.gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
        self.events = bool(cfg["events"])
        if self.events:
            self.chains = B.Chains(inputs["events"], inputs["event_frame_ids"],
                                   inputs["n_frames"])
            self.poses_at = B.pose_interpolator(inputs["hf_ts"], inputs["hf_poses"])
        else:
            imgs = np.asarray(inputs["images"], np.float32)
            self.images = torch.as_tensor(imgs.reshape(imgs.shape[0], -1, imgs.shape[-1]),
                                          device=device)
            self.poses = torch.as_tensor(np.asarray(inputs["poses"]), dtype=torch.float32,
                                         device=device)
        self.inputs = inputs

    def _rand(self, *shape):
        return torch.rand(*shape, device=self.device, generator=self.gen)

    def draw(self):
        """The step's batch and noise, drawn as the trainer draws them."""
        cfg, inp, C, T = self.cfg, self.inputs, self.cfg["out_dim_color"], self.cfg["num_steps"]
        if self.events:
            b = B.event_batch(self.chains, self.poses_at, inp["intrinsics_evs"],
                              inp["n_frames"], cfg["batch_size_evs"], self.gen, self.device)
            N = b["pols"].shape[0]
            b["bg"] = self._rand(1, C).expand(N, C)
            b["jitter1"] = self._rand(N, T)
            b["jitter2"] = self._rand(N, T)
        else:
            H, W = inp["images"].shape[1:3]
            b = B.frame_batch(self.images, self.poses, inp["intrinsics"], H, W,
                              cfg["num_rays"], self.gen, self.device)
            N = b["o"].shape[0]
            b["bg"] = self._rand(N, C)
            b["jitter"] = self._rand(N, T)
        return b, N

    def _render(self, params, o, d, bg, jitter):
        cfg = self.cfg
        return render(self.field, params, o, d, cfg["num_steps"], cfg["min_near"],
                      cfg["density_scale"], bg, jitter)

    def step(self):
        """One step: loss and gradients in blocks, then Adam + EMA.
        Returns (loss, {leaf: gradient})."""
        b, N = self.draw()
        if self.fault == "half_batch":
            N = N // 2
        for p in self.params.values():
            p.grad = None
        # each render's own handle on the MLP weights, for its gradient sum
        uses = [{k: (p if k == "hash_table" else p.detach().clone().requires_grad_(True))
                 for k, p in self.params.items()} for _ in range(2 if self.events else 1)]
        total = 0.0
        for s in range(0, N, self.block):
            e = min(s + self.block, N)
            if self.events:
                i1 = self._render(uses[0], b["o1"][s:e], b["d1"][s:e], b["bg"][s:e],
                                  b["jitter1"][s:e])
                i2 = self._render(uses[1], b["o2"][s:e], b["d2"][s:e], b["bg"][s:e],
                                  b["jitter2"][s:e])
                delta = lin_log(i2["image"] * 255.0) - lin_log(i1["image"] * 255.0)
                res = delta - b["pols"][s:e, None] * float(self.cfg["C_thres"])
                part = (res ** 2).sum() / (N * res.shape[-1])
            else:
                out = self._render(uses[0], b["o"][s:e], b["d"][s:e], b["bg"][s:e],
                                   b["jitter"][s:e])
                part = ((out["image"] - b["gt"][s:e]) ** 2).mean(-1).sum() / N
            part.backward()
            total += float(part.detach())
        for k, p in self.params.items():
            if k != "hash_table":
                p.grad = sum(round_grad(u[k].grad, self.field.precision) for u in uses)
        grads = {k: p.grad.detach().clone() for k, p in self.params.items()}
        self._update()
        return total, grads

    @torch.no_grad()
    def _update(self):
        n, t = self.n, self.n + 1
        lr = float(self.cfg["lr"]) * 0.1 ** min(n / float(self.cfg["iters"]), 1.0)
        step_size = lr / (1.0 - BETA1 ** t)
        bc2 = (1.0 - BETA2 ** t) ** 0.5
        for k, p in self.params.items():
            g = p.grad
            self.m[k].lerp_(g, 1.0 - BETA1)
            self.v[k].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
            p.add_(-step_size * self.m[k] / (self.v[k].sqrt() / bc2 + EPS))
        d = min(0.95, (1.0 + n) / (10.0 + n))
        for k, p in self.params.items():
            self.ema[k].mul_(d).add_(p.detach(), alpha=1.0 - d)
        self.n += 1


def readings(follower, weights, steps):
    """Follow `steps` steps -> dict(loss [steps], grad {leaf: norm of the
    first step's gradient}, change {leaf and ema.leaf: norm of the change
    after the steps})."""
    losses, first = [], None
    for i in range(steps):
        loss, grads = follower.step()
        losses.append(loss)
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
    change = {}
    for k, w in weights.items():
        w = w.float()
        change[k] = float(torch.linalg.vector_norm(follower.params[k].detach() - w))
        change["ema." + k] = float(torch.linalg.vector_norm(follower.ema[k] - w))
    return {"loss": losses, "grad": first, "change": change}
