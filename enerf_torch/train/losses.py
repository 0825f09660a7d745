"""Event photometric losses.

Counterpart of enerf_tpu/train/losses.py (reference event_utils.py:23-107
and utils.py:509-567): luma, lin-log, the C_thres and normalized event
losses, the no-event hinge and the implicit-C telemetry.  The frame MSE
comes with the frame term.
"""

import functools

import numpy as np
import torch
import torch.distributed as dist

LUMA_ESIM = (0.299, 0.587, 0.114)  # BT.601, rpg_esim convention
LUMA_709 = (0.2126, 0.7152, 0.0722)


@functools.lru_cache(maxsize=None)
def _luma_weights(esim, dtype, device):
    return torch.tensor(LUMA_ESIM if esim else LUMA_709, dtype=dtype, device=device)


def rgb_to_luma(rgb, esim=True):
    """[..., 3] -> [..., 1] luma (the weights made once per dtype and
    device: no copy from the host inside a step)."""
    return (rgb * _luma_weights(esim, rgb.dtype, rgb.device)).sum(dim=-1, keepdim=True)


def lin_log(color, linlog_thres=20.0):
    """Linear below `linlog_thres`, natural log above (continuous)."""
    thres = np.float32(linlog_thres)
    lin_slope = float(np.log(thres) / thres)  # computed in f32, as in JAX
    return torch.where(color < linlog_thres, lin_slope * color,
                       torch.log(color.clamp(min=1e-20)))


def log_intensity(image01, use_luma, linlog=True, log_thres=1e-5):
    """Render [.., C] in [0, 1] -> log-intensity [.., 1 or C] (utils.py:491-507)."""
    x = rgb_to_luma(image01, esim=True) if use_luma else image01
    x = x * 255.0
    if linlog:
        return lin_log(x, 20.0)
    return torch.log(x.clamp(min=log_thres))


class _SumOverRanks(torch.autograd.Function):
    """all_reduce SUM whose backward is the all_reduce SUM of the gradient:
    every rank's loss depends on every rank's share of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def event_loss(delta_linlog, pol, C_thres, event_only=True, group=None):
    """Core event supervision (utils.py:517-528).

    delta_linlog: [B, N, 1 or 3]; pol: [B, N, 1]; C_thres == -1 selects the
    normalized loss, whose norms run over the N pairs of the batch.  With a
    process `group` the N pairs are this rank's shard of the global batch:
    the norms are taken over the global batch (the sums of squares summed
    over the ranks, in the forward and the backward), and the returned mean
    is this rank's, so the ranks' mean of it is the global loss.
    """
    if C_thres != -1:
        return ((delta_linlog - pol * C_thres) ** 2).mean()
    EPS = 1e-9
    w = 20.0 if event_only else 400.0
    if group is None:
        dn = delta_linlog / (torch.linalg.vector_norm(delta_linlog, dim=1, keepdim=True) + EPS)
        pn = pol / (torch.linalg.vector_norm(pol, dim=1, keepdim=True) + EPS)
    else:
        d2 = _SumOverRanks.apply((delta_linlog ** 2).sum(dim=1, keepdim=True), group)
        p2 = _SumOverRanks.apply((pol ** 2).sum(dim=1, keepdim=True), group)
        dn = delta_linlog / (torch.sqrt(d2) + EPS)
        pn = pol / (torch.sqrt(p2) + EPS)
    return w * ((dn - pn) ** 2).mean()


def no_event_loss(delta_linlog, C_thres, w_no_ev=1.0):
    """Hinge on the log-intensity change of pixels without events
    (utils.py:564-566): changes below the threshold cost nothing."""
    Cno = C_thres if C_thres > 0 else 0.25
    return w_no_ev * (delta_linlog.abs() - Cno).clamp(min=0.0).mean()


def nanmedian(x):
    """jnp.nanmedian semantics: the mean of the two middle values for an
    even count (torch.nanmedian returns the lower one); NaN if all NaN."""
    return torch.nanquantile(x, 0.5)


def estimate_implicit_C(pol, delta_linlog):
    """Median implicit contrast thresholds (diagnostics, event_utils.py:69-107)."""
    d = delta_linlog.reshape(-1)
    p = pol.reshape(-1)
    ratio = d / torch.where(p == 0, torch.ones_like(p), p)
    pos, neg = p > 0, p < 0

    def masked_median(m):
        return nanmedian(torch.where(m, ratio, torch.full_like(ratio, float("nan"))))

    return {
        "median_on": masked_median(pos),
        "median_off": masked_median(neg),
        "median_on_sign": masked_median(pos & (d >= 0)),
        "median_off_sign": masked_median(neg & (d <= 0)),
    }

