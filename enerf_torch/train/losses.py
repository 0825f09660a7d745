"""Event photometric losses.

Counterpart of enerf_tpu/train/losses.py (reference event_utils.py:23-107
and utils.py:509-567): luma, lin-log, the C_thres and normalized event
losses and the implicit-C telemetry.  The no-event hinge and the frame MSE
come with the no-event pair and the frame term.
"""

import numpy as np
import torch

LUMA_ESIM = (0.299, 0.587, 0.114)  # BT.601, rpg_esim convention
LUMA_709 = (0.2126, 0.7152, 0.0722)


def rgb_to_luma(rgb, esim=True):
    """[..., 3] -> [..., 1] luma."""
    f = torch.tensor(LUMA_ESIM if esim else LUMA_709, dtype=rgb.dtype, device=rgb.device)
    return (rgb * f).sum(dim=-1, keepdim=True)


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


def event_loss(delta_linlog, pol, C_thres, event_only=True):
    """Core event supervision (utils.py:517-528).

    delta_linlog: [B, N, 1 or 3]; pol: [B, N, 1]; C_thres == -1 selects the
    normalized loss.
    """
    if C_thres != -1:
        return ((delta_linlog - pol * C_thres) ** 2).mean()
    EPS = 1e-9
    w = 20.0 if event_only else 400.0
    dn = delta_linlog / (torch.linalg.vector_norm(delta_linlog, dim=1, keepdim=True) + EPS)
    pn = pol / (torch.linalg.vector_norm(pol, dim=1, keepdim=True) + EPS)
    return w * ((dn - pn) ** 2).mean()


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

