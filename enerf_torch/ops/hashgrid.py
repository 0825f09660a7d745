"""Multiresolution hash-grid encoding (instant-ngp section 3).

Counterpart of enerf_tpu/ops/hashgrid.py (reference gridencoder.cu:34-222,
grid.py:113-135): per level, pos = x01 * scale + 0.5; each of the 2^3
corners of the sample's cell is addressed by the dense linear index while
the level fits its table, else by the spatial hash x*1 ^ y*2654435761 ^
z*805459861, modulo the level's table size; the corner embeddings are
blended trilinearly.  Samples outside [0, 1]^3 encode to 0.

The uint32 arithmetic of the CUDA and XLA versions (the dense index and the
hash wrap at 2^32) is done in int64, masked with 0xFFFFFFFF after each
product and each sum, which gives the same indices; torch's uint32 dtype
has only partial operator support.

`hash_address` is the address step alone (flat table indices and trilinear
weights per sample, level and corner), so tests can hand the same addresses
to both packages.  The table gradient is the gather's VJP, an `index_add_`
of w * g per corner into the table; `hash_encode`'s autograd node keeps the
[N, L, 8] indices (int32) and weights, not the gathered values.  Positions
get no gradient (the port's callers pass ray samples, which are data).
"""

import numpy as np
import torch

# Hash primes, reference gridencoder.cu:41 (instant-ngp constants)
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
CORNERS = 8


class HashGridMeta:
    """Static per-level constants (numpy), identical to enerf_tpu's
    HashGridMeta (reference grid.py:113-126) for 3-D inputs (the 2-D grid
    of the background net is not ported)."""

    def __init__(
        self,
        num_levels=16,
        level_dim=2,
        per_level_scale=2.0,
        base_resolution=16,
        log2_hashmap_size=19,
        desired_resolution=None,
        gridtype="hash",
    ):
        if desired_resolution is not None and num_levels > 1:
            per_level_scale = float(
                np.exp2(np.log2(desired_resolution / base_resolution) / (num_levels - 1)))
        self.input_dim = 3
        self.num_levels = int(num_levels)
        self.level_dim = int(level_dim)
        self.per_level_scale = float(per_level_scale)
        self.base_resolution = int(base_resolution)
        self.log2_hashmap_size = int(log2_hashmap_size)
        self.gridtype = gridtype
        self.output_dim = self.num_levels * self.level_dim

        D, L = self.input_dim, self.num_levels
        S = np.log2(self.per_level_scale)
        H = self.base_resolution
        max_params = 2 ** self.log2_hashmap_size
        scales, resolutions, sizes, offsets = [], [], [], [0]
        for lvl in range(L):
            scale = np.exp2(lvl * S) * H - 1.0  # gridencoder.cu:124-125
            res = int(np.ceil(scale)) + 1
            n = min(max_params, (res + 1) ** D)  # grid.py:117-119
            n = int(np.ceil(n / 8) * 8)
            scales.append(scale)
            resolutions.append(res)
            sizes.append(n)
            offsets.append(offsets[-1] + n)
        self.scales = np.asarray(scales, np.float32)
        self.resolutions = np.asarray(resolutions, np.int64)
        self.sizes = np.asarray(sizes, np.int64)
        self.offsets = np.asarray(offsets, np.int64)
        self.total_entries = int(self.offsets[-1])

        # dense index: gridencoder.cu:58-62 adds pos[d] * stride while
        # stride <= size (checked before the add, then multiplied by res+1)
        strides = np.ones((L, D), np.int64)
        use_dim = np.zeros((L, D), bool)
        for lvl in range(L):
            stride = 1
            for d in range(D):
                if stride <= sizes[lvl]:
                    strides[lvl, d] = stride
                    use_dim[lvl, d] = True
                    stride *= resolutions[lvl] + 1
        # gridencoder.cu:66: hash iff gridtype == hash and the final stride
        # (res+1)^{dims processed} overflows the table
        final_stride = np.where(use_dim.all(axis=1), (self.resolutions + 1) ** D,
                                2 ** 62).astype(np.int64)
        self.is_hashed = (gridtype == "hash") & (final_stride > self.sizes)
        self.dense_strides = strides
        self.use_dim = use_dim
        self._dev = {}

    def tensors(self, device):
        """Per-level constants as tensors on `device` (cached per device):
        the strides as the uint32 values the CUDA code multiplies by."""
        key = str(device)
        if key not in self._dev:
            strides = (self.dense_strides % 2 ** 32) * self.use_dim
            self._dev[key] = {
                "scales": torch.as_tensor(self.scales, device=device),
                "strides": torch.as_tensor(strides, device=device),
                "sizes": torch.as_tensor(self.sizes, device=device),
                "offsets": torch.as_tensor(self.offsets[:-1], device=device),
                "hashed": torch.as_tensor(self.is_hashed, device=device),
            }
        return self._dev[key]


def init_hash_table(meta, generator=None, device="cpu"):
    """[total_entries, level_dim] f32 parameters, U(-1e-4, 1e-4) (grid.py:133-135)."""
    t = torch.empty(meta.total_entries, meta.level_dim, device=device)
    return t.uniform_(-1e-4, 1e-4, generator=generator)


def hash_address(x01, meta):
    """The address step for positions x01 [N, 3] (in [0, 1] inside the box).

    Returns (idx [N, L, 8] int32 flat table rows, level offsets added;
    w [N, L, 8] f32 trilinear weights; oob [N] bool, samples outside the
    unit box).  Corner c takes bit d of c as its offset along axis d, and
    its weight is the product over d of frac or 1 - frac, in axis order.
    """
    x = x01.to(torch.float32)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    x = x.clamp(0.0, 1.0)
    m = meta.tensors(x.device)
    pos = x[:, None, :] * m["scales"][None, :, None] + 0.5  # [N, L, 3]
    pg = torch.floor(pos)
    frac = pos - pg
    pg = pg.to(torch.int64)
    strides = m["strides"][None]
    idx, w = [], []
    for c in range(CORNERS):
        bits = [(c >> d) & 1 for d in range(3)]
        corner = [pg[..., d] + bits[d] for d in range(3)]
        wc = None
        for d in range(3):
            f = frac[..., d] if bits[d] else 1.0 - frac[..., d]
            wc = f if wc is None else wc * f
        dense = (corner[0] * strides[..., 0]) & _U32
        dense = (dense + ((corner[1] * strides[..., 1]) & _U32)) & _U32
        dense = (dense + ((corner[2] * strides[..., 2]) & _U32)) & _U32
        h = (corner[0] * _PRIMES[0]) & _U32
        h = h ^ ((corner[1] * _PRIMES[1]) & _U32)
        h = h ^ ((corner[2] * _PRIMES[2]) & _U32)
        flat = torch.remainder(torch.where(m["hashed"][None], h, dense), m["sizes"][None])
        idx.append((flat + m["offsets"][None]).to(torch.int32))
        w.append(wc)
    return torch.stack(idx, -1), torch.stack(w, -1), oob


def encode_from_address(idx, w, oob, table):
    """[N, L * C] encoding from the addresses: the per-corner gather and the
    trilinear blend, summed over the corners in order."""
    N, L, _ = idx.shape
    out = None
    for c in range(CORNERS):
        term = w[..., c, None].to(table.dtype) * table[idx[..., c]]  # [N, L, C]
        out = term if out is None else out + term
    out = out.masked_fill(oob[:, None, None], 0.0)
    return out.reshape(N, L * table.shape[1])


def table_grad_from_address(idx, w, oob, g, table_shape):
    """The f32 table gradient of `encode_from_address` for the output
    gradient g [N, L * C]: per corner, index_add_ of w * g into the rows."""
    N, L, _ = idx.shape
    C = table_shape[1]
    g = g.reshape(N, L, C).to(torch.float32).masked_fill(oob[:, None, None], 0.0)
    grad = torch.zeros(table_shape, dtype=torch.float32, device=g.device)
    for c in range(CORNERS):
        grad.index_add_(0, idx[..., c].reshape(-1), (w[..., c, None] * g).reshape(-1, C))
    return grad


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x01, table, meta, out):
        idx, w, oob = hash_address(x01, meta)
        ctx.save_for_backward(idx, w, oob)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        if out is not None:  # replay of a kept encoding (remat_fixed=2)
            return out.clone()
        return encode_from_address(idx, w, oob, table)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[0]:
            raise NotImplementedError("hash_encode: position gradients")
        idx, w, oob = ctx.saved_tensors
        grad = table_grad_from_address(idx, w, oob, g, ctx.table_shape)
        return None, grad.to(ctx.table_dtype), None, None


def hash_encode(x01, table, meta, out=None):
    """Encode [N, 3] positions in [0, 1] -> [N, L * C] (level-major, then
    channel); samples outside the unit box encode to 0.  Differentiable in
    `table`.  `out`: a previously computed encoding of the same positions,
    returned (copied) without the gather, with the same table backward."""
    return _HashEncode.apply(x01, table, meta, out)
