"""Plain PyTorch reference of the E-NeRF field: the instant-ngp hash grid,
the degree-4 spherical-harmonics direction encoding, the bias-free sigma
and colour MLPs, and the truncated-exponential density.

Frozen copies of plain functions, written from the published description
(instant-ngp section 3; torch-ngp's gridencoder.cu, shencoder.cu,
network.py and activation.py, which E-NeRF trains with), so that the
yardstick does not move with the program.  Nothing here imports the
program.  Departures from the published code, each on purpose:

  - the grid's gather is plain advanced indexing, so its backward is
    autograd's accumulate (torch-ngp's is an atomic add in CUDA);
  - `precision` is the dtype the MLPs' inputs, weights and hidden
    activations are rounded to, with products accumulated in float32: the
    configuration's `fp16 = True` runs bfloat16 there (the half precision
    the program states for this GPU), and the control runs float8 (e4m3).
    The gradient through an activation's rounding is rounded the same way,
    as a cast's is.  A weight is cast once for each render that uses it,
    so its gradient is rounded once a render, after the sum over that
    render's samples: `mlp` passes the weights' gradient through in
    float32, and the caller rounds each render's sum (reference/train.py).
"""

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF


class GridMeta:
    """Per-level constants of a 3-D hash grid (torch-ngp grid.py:113-126,
    gridencoder.cu:58-66, 124-125)."""

    def __init__(self, num_levels, level_dim, base_resolution, log2_hashmap_size,
                 desired_resolution):
        D = 3
        S = np.log2(desired_resolution / base_resolution) / (num_levels - 1)
        self.num_levels, self.level_dim = int(num_levels), int(level_dim)
        scales, res, sizes, offsets = [], [], [], [0]
        for lvl in range(num_levels):
            scale = np.exp2(lvl * S) * base_resolution - 1.0
            r = int(np.ceil(scale)) + 1
            n = min(2 ** log2_hashmap_size, (r + 1) ** D)
            n = int(np.ceil(n / 8) * 8)
            scales.append(scale)
            res.append(r)
            sizes.append(n)
            offsets.append(offsets[-1] + n)
        self.scales = np.asarray(scales, np.float32)
        self.sizes = np.asarray(sizes, np.int64)
        self.offsets = np.asarray(offsets, np.int64)
        self.entries = int(self.offsets[-1])
        strides = np.zeros((num_levels, D), np.int64)
        hashed = np.zeros(num_levels, bool)
        for lvl in range(num_levels):
            stride, dense_dims = 1, 0
            for d in range(D):
                if stride <= sizes[lvl]:
                    strides[lvl, d] = stride % 2 ** 32
                    dense_dims += 1
                    stride *= res[lvl] + 1
            final = (res[lvl] + 1) ** D if dense_dims == D else 2 ** 62
            hashed[lvl] = final > sizes[lvl]
        self.strides, self.hashed = strides, hashed

    def tensors(self, device):
        return {"scales": torch.as_tensor(self.scales, device=device),
                "strides": torch.as_tensor(self.strides, device=device),
                "sizes": torch.as_tensor(self.sizes, device=device),
                "offsets": torch.as_tensor(self.offsets[:-1], device=device),
                "hashed": torch.as_tensor(self.hashed, device=device)}


def grid_address(x01, meta, consts):
    """Positions [N, 3] in [0, 1] -> (rows [N, L, 8] int64 with the level
    offsets added, weights [N, L, 8] f32, outside [N] bool).  Corner c takes
    bit d of c as its offset along axis d."""
    x = x01.float()
    outside = ((x < 0.0) | (x > 1.0)).any(-1)
    pos = x.clamp(0.0, 1.0)[:, None, :] * consts["scales"][None, :, None] + 0.5
    cell = torch.floor(pos)
    frac = pos - cell
    cell = cell.long()
    rows, weights = [], []
    for c in range(8):
        bits = [(c >> d) & 1 for d in range(3)]
        corner = [cell[..., d] + bits[d] for d in range(3)]
        w = None
        for d in range(3):
            f = frac[..., d] if bits[d] else 1.0 - frac[..., d]
            w = f if w is None else w * f
        dense = (corner[0] * consts["strides"][None, :, 0]) & U32
        h = (corner[0] * PRIMES[0]) & U32
        for d in (1, 2):
            dense = (dense + ((corner[d] * consts["strides"][None, :, d]) & U32)) & U32
            h = h ^ ((corner[d] * PRIMES[d]) & U32)
        flat = torch.remainder(torch.where(consts["hashed"][None], h, dense),
                               consts["sizes"][None])
        rows.append(flat + consts["offsets"][None])
        weights.append(w)
    return torch.stack(rows, -1), torch.stack(weights, -1), outside


def grid_encode(x01, table, meta, consts):
    """[N, L * C] trilinear blend of the 8 corner rows per level; 0 outside
    the unit box.  Differentiable in `table`."""
    rows, w, outside = grid_address(x01, meta, consts)
    out = None
    for c in range(8):
        term = w[..., c, None] * table[rows[..., c]]
        out = term if out is None else out + term
    out = out.masked_fill(outside[:, None, None], 0.0)
    return out.reshape(x01.shape[0], -1)


def sh4(d):
    """Real spherical harmonics of degree 4 (16 values) of unit directions."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999, -1.0925484305920792 * xz,
        0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2), 0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ], -1)


class _Round(torch.autograd.Function):
    """x rounded to `dtype` and back; the gradient rounded the same way."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


class _RoundValue(torch.autograd.Function):
    """x rounded to `dtype` and back; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def rounded(x, dtype):
    return x if dtype == torch.float32 else _Round.apply(x, dtype)


def round_grad(g, dtype):
    """A render's summed weight gradient, rounded as its cast's backward does."""
    return g if dtype == torch.float32 else g.to(dtype).to(g.dtype)


class _TruncExp(torch.autograd.Function):
    """exp, with the gradient's exponent clamped to [-15, 15] (activation.py)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def mlp(weights, h, precision):
    """Bias-free MLP, ReLU between layers, float32 products of rounded
    operands; the last layer's output stays float32.  The weights'
    gradient is the float32 sum (see the module docstring)."""
    h = rounded(h, precision)
    for i, w in enumerate(weights):
        h = h @ (w if precision == torch.float32 else _RoundValue.apply(w, precision))
        if i != len(weights) - 1:
            h = rounded(torch.relu(h), precision)
    return h


class Field:
    """The published field: hash grid 16 x 2 at 2^19, desired resolution
    2048 x bound, sigma net 32 -> 64 -> 1 + 15, colour net 16 + 15 -> 64 ->
    64 -> C."""

    def __init__(self, cfg, device, precision=torch.bfloat16):
        self.bound = float(cfg["bound"])
        self.meta = GridMeta(cfg.get("num_levels", 16), cfg.get("level_dim", 2), 16, 19,
                             2048 * max(self.bound, 1.0))
        self.consts = self.meta.tensors(device)
        self.hidden = cfg.get("hidden_dim", 64)
        self.hidden_color = cfg.get("hidden_dim_color", 64)
        self.geo = cfg.get("geo_feat_dim", 15)
        self.out_dim = cfg["out_dim_color"]
        self.precision = precision

    def shapes(self):
        """Name -> shape of every parameter, [in, out] weights."""
        L, C = self.meta.num_levels, self.meta.level_dim
        return {"hash_table": (self.meta.entries, C),
                "sigma_w0": (L * C, self.hidden), "sigma_w1": (self.hidden, 1 + self.geo),
                "color_w0": (16 + self.geo, self.hidden_color),
                "color_w1": (self.hidden_color, self.hidden_color),
                "color_w2": (self.hidden_color, self.out_dim)}

    def density(self, params, x):
        x01 = (x + self.bound) / (2.0 * self.bound)
        enc = grid_encode(x01, params["hash_table"], self.meta, self.consts)
        h = mlp([params["sigma_w0"], params["sigma_w1"]], enc, self.precision)
        return _TruncExp.apply(h[..., 0]), h[..., 1:]

    def color(self, params, d, geo):
        h = torch.cat([rounded(sh4(d), self.precision), rounded(geo, self.precision)], -1)
        h = mlp([params["color_w0"], params["color_w1"], params["color_w2"]], h,
                self.precision)
        return torch.sigmoid(h)
