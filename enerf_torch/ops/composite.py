"""Volume-rendering compositing along rays (fixed [N, T] samples).

Counterpart of enerf_tpu/ops/composite.py (reference renderer.py:230-265):
  alpha_i  = 1 - exp(-delta_i * density_scale * sigma_i)
  T_i      = prod_{j<i} (1 - alpha_j + 1e-15)
  weight_i = alpha_i * T_i
  image    = sum_i w_i rgb_i + (1 - sum_i w_i) * bg
  depth    = sum_i w_i * clip((z_i - near) / (far - near), 0, 1)
The backward is autograd's, through the exclusive cumulative product.
"""

import torch


def composite_weights(sigmas, deltas, density_scale=1.0):
    """sigmas, deltas [N, T] -> (weights [N, T], alphas [N, T])."""
    alphas = 1.0 - torch.exp(-deltas * density_scale * sigmas)
    one_m = 1.0 - alphas + 1e-15
    trans = torch.cumprod(
        torch.cat([torch.ones_like(one_m[..., :1]), one_m[..., :-1]], -1), -1)
    return alphas * trans, alphas


def composite_rays(sigmas, rgbs, deltas, z_vals, nears, fars, bg_color, density_scale=1.0):
    """sigmas [N, T], rgbs [N, T, C], deltas, z_vals [N, T], nears, fars [N],
    bg_color broadcastable to [N, C] -> dict(image [N, C], depth [N],
    weights_sum [N], weights [N, T])."""
    weights, _ = composite_weights(sigmas, deltas, density_scale)
    weights_sum = weights.sum(-1)
    # rays that miss the box carry fars == nears (the renderer sets both to
    # min_near): guard the 0/0 so the depth stays finite
    span = (fars - nears)[:, None].clamp(min=1e-6)
    ori_z = ((z_vals - nears[:, None]) / span).clamp(0.0, 1.0)
    depth = (weights * ori_z).sum(-1)
    image = (weights[..., None] * rgbs).sum(-2) + (1.0 - weights_sum)[..., None] * bg_color
    return {"image": image, "depth": depth, "weights_sum": weights_sum, "weights": weights}
