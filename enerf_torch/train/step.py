"""The training steps (events, frames), on the fixed-step or the march
renderer.

Counterpart of enerf_tpu/train/step.py (reference utils.py:482-636).  The
event step: two renders of one pixel ray at the poses of an event and its
successor, the lin-log difference held to polarity x C, plus the optional
opacity and distortion regularizers; with event_only=0 the frame term, an
MSE on random pixels of a frame against a per-pixel random background,
weighted by weight_loss_rgb; with negative_event_sampling the no-event
pair, whose log-intensity change is held below the threshold by a hinge;
then Adam + EMA.  The frames step (events=0): the frame term alone, then
the same update.  The CLIP step (rand_pose batches): one render of a
random pose's full side x side ray grid against a white background,
scored by 1 - <embed(image), text feature> (train/clip_guidance.py), then
the same update.

`use_march` selects the occupancy-march renderer (cuda_ray); otherwise the
fixed-step renderer draws num_steps uniform samples per ray, optionally
rematerialized in the backward (`remat_fixed`: 1 recomputes the whole
render, 2 keeps the encodings and recomputes the rest).  `warm_statics`
gives the march_warmup phase's statics.

The event and frames steps record the spans `step.forward` (the renders
and the loss), `step.backward` and `step.optim` (Adam + EMA) in the span
registry (utils/profiling.py).

Random draws (the backgrounds, the jitter and PDF draws of each render)
come from a torch.Generator, or from `noise` when a test hands in the JAX
package's draws.
"""

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from enerf_torch.models.field import EncodeReplay
from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
from enerf_torch.render.march import (
    composite_from_march, march_rays, march_rays_pair, num_cascades_of, render_rays_march,
)
from enerf_torch.render.renderer import render_rays
from enerf_torch.train import losses
from enerf_torch.utils import profiling


class StepStatics(NamedTuple):
    """Step hyperparameters (the JAX StepStatics' fields the port uses)."""
    field_static: Any
    min_near: float
    density_scale: float
    C_thres: float
    event_only: bool
    use_luma: bool
    linlog: bool
    out_dim_color: int
    num_steps: int = 128
    upsample_steps: int = 0
    weight_loss_rgb: float = 1.0
    use_march: bool = False
    march_samples: int = 32
    max_steps: int = 1024
    dt_gamma: float = 0.0
    compact_frac: Any = 0.5
    share_march: bool = False
    w_opacity: float = 0.0
    w_distortion: float = 0.0
    negative_event_sampling: bool = False
    w_no_ev: float = 1.0
    remat_fixed: int = 0
    warmup_num_steps: int = 0
    # the rand-pose step's image embedder (train/clip_guidance.StubEmbedder)
    clip_embedder: Any = None


def distortion_loss(weights, ts, dts):
    """mip-NeRF 360 eq. 15 on sorted samples, O(S); per-batch mean."""
    cw = torch.cumsum(weights, -1)
    cwt = torch.cumsum(weights * ts, -1)
    w_before = cw - weights
    s_before = cwt - weights * ts
    cross = 2.0 * (weights * (ts * w_before - s_before)).sum(-1)
    self_term = (weights * weights * dts).sum(-1) / 3.0
    return (cross + self_term).mean()


def warm_statics(ss):
    """StepStatics of a march_warmup phase: uniform fixed-step sampling
    (march and share off), the renderer rematerialized, and
    warmup_num_steps (when set) in place of num_steps."""
    return ss._replace(use_march=False, share_march=False,
                       num_steps=int(ss.warmup_num_steps) or ss.num_steps,
                       remat_fixed=max(int(ss.remat_fixed), 1))


def _render_pair_shared(params, ss, o1, d1, o2, d2, bg, jitter, occ):
    """One march on the first ray of a correlated pair; both renders
    composite from its sample t-values (StepStatics.share_march)."""
    fs = ss.field_static
    nears, fars = near_far_from_aabb(o1, d1, aabb_tensor(fs.bound, o1.device), ss.min_near)
    ts, dts, valid = march_rays(
        o1, d1, occ, nears, fars, jitter=jitter,
        num_samples=ss.march_samples, max_steps=ss.max_steps,
        cascades=num_cascades_of(occ), bound=fs.bound, dt_gamma=ss.dt_gamma,
        perturb=True)
    return tuple(
        composite_from_march(
            params, fs, o, d, ts, dts, valid, nears, fars,
            bg_color=bg, density_scale=ss.density_scale,
            compact_frac=ss.compact_frac,
            return_weights=ss.w_distortion > 0.0)
        for o, d in ((o1, d1), (o2, d2)))


def _render_pair_march(params, ss, o1, d1, o2, d2, bg, jitters, occ):
    """Both renders of a ray pair on the march, each with its own jitter:
    one march of both renders' rays (one M1 launch on the card; each ray
    gets what its render's march alone gives it), then each render's
    composite (render_rays_march's, split in two)."""
    fs = ss.field_static
    aabb = aabb_tensor(fs.bound, o1.device)
    rays = ((o1, d1), (o2, d2))
    near_far = [near_far_from_aabb(o, d, aabb, ss.min_near) for o, d in rays]
    marched = march_rays_pair(
        (o1, o2), (d1, d2), occ, *zip(*near_far), jitter=jitters,
        num_samples=ss.march_samples, max_steps=ss.max_steps, cascades=num_cascades_of(occ),
        bound=fs.bound, dt_gamma=ss.dt_gamma, perturb=True)
    return tuple(
        composite_from_march(
            params, fs, o, d, ts, dts, valid, nears, fars, bg_color=bg,
            density_scale=ss.density_scale, compact_frac=ss.compact_frac,
            return_weights=ss.w_distortion > 0.0)
        for (o, d), (nears, fars), (ts, dts, valid) in zip(rays, near_far, marched))


def _render(params, ss, rays_o, rays_d, bg, jitter, occ, u=None):
    """One training render: the march when ss.use_march and a packed
    bitfield is given, else the fixed-step renderer (jitter [N, num_steps],
    u [N, upsample_steps])."""
    if ss.use_march and occ is not None:
        return render_rays_march(
            params, ss.field_static, occ, rays_o, rays_d,
            num_samples=ss.march_samples, max_steps=ss.max_steps, bg_color=bg,
            perturb=True, jitter=jitter, min_near=ss.min_near,
            density_scale=ss.density_scale, dt_gamma=ss.dt_gamma,
            compact_frac=ss.compact_frac, return_weights=ss.w_distortion > 0.0)

    def fixed():
        return render_rays(
            params, ss.field_static, rays_o, rays_d, num_steps=ss.num_steps,
            upsample_steps=ss.upsample_steps, bg_color=bg, perturb=True, jitter=jitter,
            u=u, train=True, min_near=ss.min_near, density_scale=ss.density_scale)

    if ss.remat_fixed == 2:
        return checkpoint(fixed, use_reentrant=False, context_fn=EncodeReplay().contexts)
    if ss.remat_fixed:
        return checkpoint(fixed, use_reentrant=False)
    return fixed()


def draw_noise(ss, n_rays, generator, device, n_no_ev=0, n_frames=0, n_clip=0):
    """The step's random draws: with n_rays > 0 the event pair's bg [1, C]
    and each render's jitter (`jitter1`, `jitter2`: [N] for the march,
    [N, num_steps] for the fixed-step renderer, plus `u1`, `u2`
    [N, upsample_steps] with upsampling); with n_no_ev > 0 the no-event
    pair's (`bg_no_ev`, `jitter_no_ev1/2`, `u_no_ev1/2`); with n_frames > 0
    the frame term's per-pixel bg [n_frames, C] and its render's
    (`bg_frames`, `jitter_frames`, `u_frames`); with n_clip > 0 the CLIP
    step's render's (`jitter_clip`, `u_clip`).  The JAX step's keys k_bg,
    k1, k2; k3, k4, k5; kf; the CLIP step's rng."""
    def rand(*shape):
        return torch.rand(*shape, device=device, generator=generator)

    def render_noise(n, name):
        if ss.use_march:
            return {f"jitter{name}": rand(n)}
        out = {f"jitter{name}": rand(n, ss.num_steps)}
        if ss.upsample_steps:
            out[f"u{name}"] = rand(n, ss.upsample_steps)
        return out

    noise = {}
    if n_rays:
        noise["bg"] = rand(1, ss.out_dim_color)
        noise.update(render_noise(n_rays, "1"), **render_noise(n_rays, "2"))
    if n_no_ev:
        noise["bg_no_ev"] = rand(1, ss.out_dim_color)
        noise.update(render_noise(n_no_ev, "_no_ev1"), **render_noise(n_no_ev, "_no_ev2"))
    if n_frames:
        noise["bg_frames"] = rand(n_frames, ss.out_dim_color)
        noise.update(render_noise(n_frames, "_frames"))
    if n_clip:
        noise.update(render_noise(n_clip, "_clip"))
    return noise


def uses_no_ev(ss, batch):
    return ss.negative_event_sampling and "rays_no_evs_o1" in batch


def _render_pair(params, ss, batch, prefix, bg, noise, suffix, occ):
    """Both renders of a ray pair: one shared march (share_march), one
    march of both renders' rays, or (fixed-step) one render each, with its
    own noise."""
    o1, d1, o2, d2 = (batch[f"rays_{prefix}_{k}"] for k in ("o1", "d1", "o2", "d2"))
    if ss.use_march and occ is not None:
        if ss.share_march:
            return _render_pair_shared(params, ss, o1, d1, o2, d2, bg,
                                       noise[f"jitter{suffix}1"], occ)
        return _render_pair_march(params, ss, o1, d1, o2, d2, bg,
                                  (noise[f"jitter{suffix}1"], noise[f"jitter{suffix}2"]), occ)
    return tuple(_render(params, ss, o, d, bg, noise[f"jitter{suffix}{i}"], occ,
                         noise.get(f"u{suffix}{i}"))
                 for i, (o, d) in ((1, (o1, d1)), (2, (o2, d2))))


def frames_loss_fn(params, ss, batch, noise, occ=None):
    """MSE frame loss against a per-pixel random background (utils.py:586-604);
    batch: rays_o, rays_d [N, 3], images [N, C] or [N, C+1] (with alpha)."""
    images = batch["images"]
    C = ss.out_dim_color
    bg = noise["bg_frames"]
    if images.shape[-1] == C + 1:  # alpha compositing against the random bg
        gt = images[..., :C] * images[..., C:] + bg * (1.0 - images[..., C:])
    else:
        gt = images
    out = _render(params, ss, batch["rays_o"], batch["rays_d"], bg, noise["jitter_frames"],
                  occ, noise.get("u_frames"))
    per_ray = ((out["image"] - gt) ** 2).mean(-1)
    loss = per_ray.mean()
    return loss, {"loss_frames": loss, "per_ray_loss": per_ray}


def event_loss_fn(params, ss, batch, noise, occ, group=None):
    """Event photometric loss on paired renders (utils.py:482-573);
    occ: the packed occupancy bitfield the march renders go through
    (None on the fixed-step path).  With a process `group` the batch is this
    rank's shard: the normalized event loss takes its norms over the global
    batch (losses.event_loss), and the implC_* medians, which would need
    the global batch sorted, are left out.  The other terms are means, so
    the ranks' mean of them is the global batch's."""
    N = batch["rays_evs_o1"].shape[0]
    # one random bg shared by both renders of the pair (utils.py:487)
    bg = noise["bg"].expand(N, ss.out_dim_color)
    out1, out2 = _render_pair(params, ss, batch, "evs", bg, noise, "", occ)
    ll1 = losses.log_intensity(out1["image"], ss.use_luma, ss.linlog)
    ll2 = losses.log_intensity(out2["image"], ss.use_luma, ss.linlog)
    delta = ll2 - ll1
    pol = batch["pols"][:, None]
    loss_evs = losses.event_loss(delta[None], pol[None], ss.C_thres,
                                 event_only=ss.event_only, group=group)
    loss = loss_evs
    aux = {"loss_evs": loss_evs}
    if group is None:
        aux.update((f"implC_{k}", v) for k, v in
                   losses.estimate_implicit_C(pol, delta.detach()).items())
    aux["ws_mean"] = out1["weights_sum"].detach().float().mean()

    if ss.w_distortion > 0.0 and "weights" in out1:  # march renders only
        l_dist = ss.w_distortion * 0.5 * (
            distortion_loss(out1["weights"], out1["ts"], out1["dts"])
            + distortion_loss(out2["weights"], out2["ts"], out2["dts"]))
        loss = loss + l_dist
        aux["loss_distortion"] = l_dist
    if ss.w_opacity > 0.0:
        ws = torch.cat([out1["weights_sum"], out2["weights_sum"]]).clamp(0.0, 1.0)
        l_op = ss.w_opacity * (-torch.log(ws * ws + (1.0 - ws) * (1.0 - ws))).mean()
        loss = loss + l_op
        aux["loss_opacity"] = l_op
    if not ss.event_only:
        lf, _ = frames_loss_fn(params, ss, batch, noise, occ)
        loss = loss + ss.weight_loss_rgb * lf
        aux["loss_frames"] = lf
    if uses_no_ev(ss, batch):
        M = batch["rays_no_evs_o1"].shape[0]
        bg2 = noise["bg_no_ev"].expand(M, ss.out_dim_color)
        no1, no2 = _render_pair(params, ss, batch, "no_evs", bg2, noise, "_no_ev", occ)
        nll1 = losses.log_intensity(no1["image"], ss.use_luma, True)
        nll2 = losses.log_intensity(no2["image"], ss.use_luma, True)
        lne = losses.no_event_loss(nll2 - nll1, ss.C_thres, ss.w_no_ev)
        loss = loss + lne
        aux["loss_no_evs"] = lne
    return loss, aux


def step_noise(ss, batch, generator, mode="events", scale=1):
    """draw_noise sized for a step on `batch`: in events mode its pairs, its
    no-event rays (when the step uses them) and its frame rays (unless
    event-only); in frames mode its frame rays.  Every count is multiplied
    by `scale`: the data-parallel step draws the global batch's noise from
    one rank's shard."""
    if mode == "frames":
        return draw_noise(ss, 0, generator, batch["rays_o"].device,
                          n_frames=scale * batch["rays_o"].shape[0])
    n_no_ev = batch["rays_no_evs_o1"].shape[0] if uses_no_ev(ss, batch) else 0
    n_frames = 0 if ss.event_only else batch["rays_o"].shape[0]
    return draw_noise(ss, scale * batch["rays_evs_o1"].shape[0], generator,
                      batch["rays_evs_o1"].device, scale * n_no_ev, scale * n_frames)


def train_step_events(state, batch, ss, occ, noise=None, generator=None):
    """One event step: loss, backward, Adam + EMA on `state` (in place).
    Returns the detached loss terms; the gradients stay in state.params[k].grad
    until the next step."""
    if noise is None:
        noise = step_noise(ss, batch, generator)
    state.zero_grad()
    with profiling.span("step.forward", state.count.device):
        loss, aux = event_loss_fn(state.params, ss, batch, noise, occ)
    with profiling.span("step.backward", state.count.device):
        loss.backward()
    with profiling.span("step.optim", state.count.device):
        state.apply_updates()
    out = {"loss": loss.detach()}
    out.update((k, v.detach()) for k, v in aux.items())
    return out


def train_step_frames(state, batch, ss, occ, noise=None, generator=None):
    """One frames-mode step (events=0): the frame loss, backward, Adam + EMA
    on `state` (in place).  Returns the detached loss, loss_frames and
    per_ray_loss [N] (the error map's update)."""
    if noise is None:
        noise = step_noise(ss, batch, generator, mode="frames")
    state.zero_grad()
    with profiling.span("step.forward", state.count.device):
        loss, aux = frames_loss_fn(state.params, ss, batch, noise, occ)
    with profiling.span("step.backward", state.count.device):
        loss.backward()
    with profiling.span("step.optim", state.count.device):
        state.apply_updates()
    return {"loss": loss.detach(), "loss_frames": aux["loss_frames"].detach(),
            "per_ray_loss": aux["per_ray_loss"].detach()}


def clip_loss_fn(params, ss, batch, noise, text_feat, side, occ=None):
    """Semantic guidance on a random-pose render: the side x side grid
    rendered against a white background (the bg net's colour with
    bg_radius > 0), embedded by ss.clip_embedder, 1 - cos against
    text_feat [dim]."""
    C = ss.out_dim_color
    bg = torch.ones(1, C, device=batch["rays_o"].device)
    out = _render(params, ss, batch["rays_o"], batch["rays_d"], bg, noise["jitter_clip"], occ,
                  noise.get("u_clip"))
    img = out["image"].reshape(side, side, C)
    loss = 1.0 - (ss.clip_embedder(img) * text_feat).sum()
    return loss, {"loss_clip": loss}


def train_step_clip(state, batch, ss, occ, text_feat, side, noise=None, generator=None,
                    reduce_grads=None):
    """One rand-pose step: the CLIP loss of a side x side render, backward,
    Adam + EMA on `state` (in place).  Under a data-parallel mesh every rank
    runs the same step on the same pose, and `reduce_grads(params)` means
    the gradients over the ranks before the update, so that the ranks stay
    bit-equal where the backward's atomic adds sum in another order.
    Returns the detached loss and loss_clip."""
    if noise is None:
        noise = draw_noise(ss, 0, generator, batch["rays_o"].device,
                           n_clip=batch["rays_o"].shape[0])
    state.zero_grad()
    loss, aux = clip_loss_fn(state.params, ss, batch, noise, text_feat, side, occ)
    loss.backward()
    if reduce_grads is not None:
        reduce_grads(state.params.values())
    state.apply_updates()
    return {"loss": loss.detach(), "loss_clip": aux["loss_clip"].detach()}
