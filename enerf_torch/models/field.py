"""The instant-ngp field: block-grid encoder + sigma MLP + SH + colour MLP.

Counterpart of enerf_tpu/models/field.py (reference nerf/network.py).
Parameters are a flat dict of tensors with the JAX package's names and its
[in, out] weight layout, so a JAX parameter dict converts 1:1
(convert.params_from_jax).  `FieldStatic` holds only hyperparameters.

This slice ports the block-grid encoder (the --ff / --tcnn backbone); the
per-cell hashgrid, the frequency / identity encoders and the background
net raise NotImplementedError.
"""

import math

import torch

from enerf_torch.ops.blockgrid import BlockGridMeta, block_encode, init_block_table
from enerf_torch.ops.scatter_accum import block_encode_fast
from enerf_torch.ops.sh import sh_encode, sh_output_dim
from enerf_torch.ops.trunc_exp import trunc_exp


class FieldStatic:
    """Static field hyperparameters (the JAX FieldStatic's, blockgrid only)."""

    def __init__(
        self,
        bound=1.0,
        num_layers=2,
        hidden_dim=64,
        geo_feat_dim=15,
        num_layers_color=3,
        hidden_dim_color=64,
        sh_degree=4,
        out_dim_color=3,
        disable_view_direction=False,
        bg_radius=-1.0,
        num_levels=16,
        level_dim=2,
        base_resolution=16,
        log2_hashmap_size=19,
        grid_block=4,
        encoding="blockgrid",
        use_fused_head=False,
        fast_table_grad=False,  # table backward by kernel K2 (ops/scatter_accum)
        density_bias=0.0,
        compute_dtype=torch.float32,
    ):
        if encoding != "blockgrid":
            raise NotImplementedError(f"enerf_torch field: encoding={encoding!r}")
        if bg_radius > 0:
            raise NotImplementedError("enerf_torch field: background net (bg_radius > 0)")
        self.bound = float(bound)
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.geo_feat_dim = geo_feat_dim
        self.num_layers_color = num_layers_color
        self.hidden_dim_color = hidden_dim_color
        self.sh_degree = sh_degree
        self.out_dim_color = out_dim_color
        self.disable_view_direction = disable_view_direction
        self.bg_radius = float(bg_radius)
        self.encoding = encoding
        self.grid_block = int(grid_block)
        self.use_fused_head = use_fused_head
        self.fast_table_grad = bool(fast_table_grad)
        self.density_bias = float(density_bias)
        self.compute_dtype = compute_dtype
        # reference network.py:36: desired_resolution = 2048 * bound
        self.grid_meta = BlockGridMeta(
            num_levels=num_levels,
            level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=2048 * max(self.bound, 1.0),
            block=self.grid_block,
        )
        self.in_dim = self.grid_meta.output_dim
        self.in_dim_dir = sh_output_dim(sh_degree)

    def mlp_dims(self, which):
        """(in, out) per layer for the 'sigma' | 'color' nets."""
        if which == "sigma":
            L, hid = self.num_layers, self.hidden_dim
            first, last = self.in_dim, 1 + self.geo_feat_dim
        elif which == "color":
            L, hid = self.num_layers_color, self.hidden_dim_color
            first, last = self.in_dim_dir + self.geo_feat_dim, self.out_dim_color
        else:
            raise ValueError(which)
        return [(first if l == 0 else hid, last if l == L - 1 else hid)
                for l in range(L)]


def _init_linear(in_dim, out_dim, generator, device):
    # torch.nn.Linear default (kaiming_uniform a=sqrt(5)) == U(+-1/sqrt(fan_in))
    bnd = 1.0 / math.sqrt(in_dim)
    w = torch.empty(in_dim, out_dim, dtype=torch.float32, device=device)
    return w.uniform_(-bnd, bnd, generator=generator)


def init_field_params(static, seed=0, device="cpu"):
    """Parameter dict {hash_table, sigma_w*, color_w*} drawn from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = {"hash_table": init_block_table(static.grid_meta, gen, device)}
    for i, (di, do) in enumerate(static.mlp_dims("sigma")):
        params[f"sigma_w{i}"] = _init_linear(di, do, gen, device)
    for i, (di, do) in enumerate(static.mlp_dims("color")):
        params[f"color_w{i}"] = _init_linear(di, do, gen, device)
    return params


def _mlp(params, prefix, n_layers, h, compute_dtype):
    """Bias-free MLP; products accumulate in f32 (the JAX
    preferred_element_type=f32), hidden activations round to compute_dtype."""
    h = h.to(compute_dtype)
    for l in range(n_layers):
        w = params[f"{prefix}_w{l}"].to(compute_dtype)
        h = h.float() @ w.float()
        if l != n_layers - 1:
            h = torch.relu(h).to(compute_dtype)
    return h  # f32


def _dir_encode(static, d):
    enc = sh_encode(d, static.sh_degree)
    if static.disable_view_direction:  # reference network.py:122: `* 0`
        enc = enc * 0.0
    return enc


def _encode(params, static, x01):
    if static.fast_table_grad:
        return block_encode_fast(x01, params["hash_table"], static.grid_meta)
    return block_encode(x01, params["hash_table"], static.grid_meta)


def field_density(params, static, x):
    """x: [N, 3] in [-bound, bound] -> (sigma [N], geo_feat [N, G])."""
    x01 = (x + static.bound) / (2.0 * static.bound)
    enc = _encode(params, static, x01)
    h = _mlp(params, "sigma", static.num_layers, enc, static.compute_dtype)
    sigma = trunc_exp(h[..., 0] + static.density_bias)
    return sigma, h[..., 1:]


def field_color(params, static, d, geo_feat):
    """d: [N, 3] unit dirs, geo_feat: [N, G] -> rgb [N, out_dim_color]."""
    cd = static.compute_dtype
    h = torch.cat([_dir_encode(static, d).to(cd), geo_feat.to(cd)], dim=-1)
    h = _mlp(params, "color", static.num_layers_color, h, cd)
    return torch.sigmoid(h)


def field_forward(params, static, x, d):
    """(sigma [N], color [N, C]) — reference network.py:104-132."""
    sigma, geo_feat = field_density(params, static, x)
    return sigma, field_color(params, static, d, geo_feat)


def field_forward_fused(params, static, x, d):
    """The --ff backbone: block-grid encoding feeds the fused head (kernel K1
    on CUDA tensors).  Requires the 2-layer sigma / 3-layer colour topology."""
    from enerf_torch.ops.fused_mlp import fused_field_head

    if static.num_layers != 2 or static.num_layers_color != 3:
        raise ValueError("fused head supports the reference topology "
                         "(2 sigma / 3 colour layers)")
    x01 = (x + static.bound) / (2.0 * static.bound)
    cd = static.compute_dtype
    enc = _encode(params, static, x01)
    denc = _dir_encode(static, d)
    sigma, rgb = fused_field_head(
        enc.to(cd), denc.to(cd),
        params["sigma_w0"].to(cd), params["sigma_w1"].to(cd),
        params["color_w0"].to(cd), params["color_w1"].to(cd),
        params["color_w2"].to(cd),
    )
    if static.density_bias:
        # exp(raw + b) == exp(raw) * e^b — bias applied outside the kernel
        sigma = sigma * math.exp(static.density_bias)
    return sigma, rgb
