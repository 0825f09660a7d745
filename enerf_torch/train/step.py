"""The event-mode training step on the occupancy-march renderer.

Counterpart of enerf_tpu/train/step.py (reference utils.py:482-573): two
renders of one pixel ray at the poses of an event and its successor, the
lin-log difference held to polarity x C, plus the optional opacity and
distortion regularizers; then Adam + EMA.

Random draws (the background shared by the pair, the march jitter of each
render) come from a torch.Generator, or from `noise` when a test hands in
the JAX package's draws.  With negative_event_sampling the step adds the
no-event pair: two renders of a pixel without events at two nearby times,
whose log-intensity change is held below the threshold by a hinge.  This
port has the march path only: the fixed-step renderer, the frame term
(event_only=0) and the CLIP step raise NotImplementedError.
"""

from typing import Any, NamedTuple

import torch

from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
from enerf_torch.render.march import (
    composite_from_march, march_rays, render_rays_march,
)
from enerf_torch.train import losses


class StepStatics(NamedTuple):
    """Step hyperparameters (the JAX StepStatics' fields this slice uses)."""
    field_static: Any
    min_near: float
    density_scale: float
    C_thres: float
    event_only: bool
    use_luma: bool
    linlog: bool
    out_dim_color: int
    march_samples: int = 32
    max_steps: int = 1024
    dt_gamma: float = 0.0
    compact_frac: Any = 0.5
    share_march: bool = False
    w_opacity: float = 0.0
    w_distortion: float = 0.0
    negative_event_sampling: bool = False
    w_no_ev: float = 1.0


def distortion_loss(weights, ts, dts):
    """mip-NeRF 360 eq. 15 on sorted samples, O(S); per-batch mean."""
    cw = torch.cumsum(weights, -1)
    cwt = torch.cumsum(weights * ts, -1)
    w_before = cw - weights
    s_before = cwt - weights * ts
    cross = 2.0 * (weights * (ts * w_before - s_before)).sum(-1)
    self_term = (weights * weights * dts).sum(-1) / 3.0
    return (cross + self_term).mean()


def _render_pair_shared(params, ss, o1, d1, o2, d2, bg, jitter, occ):
    """One march on the first ray of a correlated pair; both renders
    composite from its sample t-values (StepStatics.share_march)."""
    fs = ss.field_static
    nears, fars = near_far_from_aabb(o1, d1, aabb_tensor(fs.bound, o1.device), ss.min_near)
    ts, dts, valid = march_rays(
        o1, d1, occ, nears, fars, jitter=jitter,
        num_samples=ss.march_samples, max_steps=ss.max_steps,
        cascades=occ.shape[0], bound=fs.bound, dt_gamma=ss.dt_gamma,
        perturb=True)
    return tuple(
        composite_from_march(
            params, fs, o, d, ts, dts, valid, nears, fars,
            bg_color=bg, density_scale=ss.density_scale,
            compact_frac=ss.compact_frac,
            return_weights=ss.w_distortion > 0.0)
        for o, d in ((o1, d1), (o2, d2)))


def _render(params, ss, rays_o, rays_d, bg, jitter, occ_bitfield):
    return render_rays_march(
        params, ss.field_static, occ_bitfield, rays_o, rays_d,
        num_samples=ss.march_samples, max_steps=ss.max_steps, bg_color=bg,
        perturb=True, jitter=jitter, min_near=ss.min_near,
        density_scale=ss.density_scale, dt_gamma=ss.dt_gamma,
        compact_frac=ss.compact_frac, return_weights=ss.w_distortion > 0.0)


def draw_noise(ss, n_rays, generator, device, n_no_ev=0):
    """The step's random draws: the event pair's bg [1, C] and per-render
    jitter [N]; with n_no_ev > 0 the no-event pair's bg [1, C] and jitter
    [n_no_ev] too (the JAX step's k_bg, k1, k2 and k3, k4, k5)."""
    def rand(*shape):
        return torch.rand(*shape, device=device, generator=generator)

    noise = {"bg": rand(1, ss.out_dim_color), "jitter1": rand(n_rays), "jitter2": rand(n_rays)}
    if n_no_ev:
        noise.update(bg_no_ev=rand(1, ss.out_dim_color), jitter_no_ev1=rand(n_no_ev),
                     jitter_no_ev2=rand(n_no_ev))
    return noise


def _uses_no_ev(ss, batch):
    return ss.negative_event_sampling and "rays_no_evs_o1" in batch


def _render_pair(params, ss, batch, prefix, bg, jitter1, jitter2, occ):
    """Both renders of a ray pair: one shared march (share_march) or one
    march each, with its own jitter."""
    o1, d1, o2, d2 = (batch[f"rays_{prefix}_{k}"] for k in ("o1", "d1", "o2", "d2"))
    if ss.share_march:
        return _render_pair_shared(params, ss, o1, d1, o2, d2, bg, jitter1, occ)
    return (_render(params, ss, o1, d1, bg, jitter1, occ),
            _render(params, ss, o2, d2, bg, jitter2, occ))


def event_loss_fn(params, ss, batch, noise, occ):
    """Event photometric loss on paired renders (utils.py:482-573);
    occ: the [CAS, H^3] occupancy bitfield the renders march through."""
    if not ss.event_only:
        raise NotImplementedError("enerf_torch: event_only=0 (frame term)")
    N = batch["rays_evs_o1"].shape[0]
    # one random bg shared by both renders of the pair (utils.py:487)
    bg = noise["bg"].expand(N, ss.out_dim_color)
    out1, out2 = _render_pair(params, ss, batch, "evs", bg, noise["jitter1"],
                              noise["jitter2"], occ)
    ll1 = losses.log_intensity(out1["image"], ss.use_luma, ss.linlog)
    ll2 = losses.log_intensity(out2["image"], ss.use_luma, ss.linlog)
    delta = ll2 - ll1
    pol = batch["pols"][:, None]
    loss_evs = losses.event_loss(delta[None], pol[None], ss.C_thres,
                                 event_only=ss.event_only)
    loss = loss_evs
    aux = {"loss_evs": loss_evs}
    aux.update((f"implC_{k}", v) for k, v in
               losses.estimate_implicit_C(pol, delta.detach()).items())
    aux["ws_mean"] = out1["weights_sum"].detach().float().mean()

    if ss.w_distortion > 0.0:
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
    if _uses_no_ev(ss, batch):
        M = batch["rays_no_evs_o1"].shape[0]
        bg2 = noise["bg_no_ev"].expand(M, ss.out_dim_color)
        no1, no2 = _render_pair(params, ss, batch, "no_evs", bg2, noise["jitter_no_ev1"],
                                noise["jitter_no_ev2"], occ)
        nll1 = losses.log_intensity(no1["image"], ss.use_luma, True)
        nll2 = losses.log_intensity(no2["image"], ss.use_luma, True)
        lne = losses.no_event_loss(nll2 - nll1, ss.C_thres, ss.w_no_ev)
        loss = loss + lne
        aux["loss_no_evs"] = lne
    return loss, aux


def train_step_events(state, batch, ss, occ, noise=None, generator=None):
    """One event step: loss, backward, Adam + EMA on `state` (in place).
    Returns the detached loss terms; the gradients stay in state.params[k].grad
    until the next step."""
    if noise is None:
        n_no_ev = batch["rays_no_evs_o1"].shape[0] if _uses_no_ev(ss, batch) else 0
        noise = draw_noise(ss, batch["rays_evs_o1"].shape[0], generator,
                           batch["rays_evs_o1"].device, n_no_ev)
    state.zero_grad()
    loss, aux = event_loss_fn(state.params, ss, batch, noise, occ)
    loss.backward()
    state.apply_updates()
    out = {"loss": loss.detach()}
    out.update((k, v.detach()) for k, v in aux.items())
    return out
