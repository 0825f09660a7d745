"""Block-packed multiresolution grid encoding (the --ff / --tcnn encoder).

Counterpart of enerf_tpu/ops/blockgrid.py: cells are grouped into
block^3 blocks stored as one table row of (block+1)^3 cells (a one-cell
halo), so each sample's 8 trilinear corners live in ONE row: one gather per
sample per level, then a trilinear contraction over the row.  Levels whose
blocks fit the table are laid out densely; larger levels hash the block
coordinate with the reference's xor-prime hash modulo the level's rows.

Memory: the gathered rows are [chunk, L, C*row_cells] f32 (1 GB at a 65,536
point chunk, 16 levels, blk4), so `block_encode` walks the points in chunks
and its backward never saves them: the table gradient is a plain
`index_add_` of g (x) W into the rows, with the row ids and trilinear
weights recomputed from the saved positions (the same design as the JAX
package's linear-gather VJP).  Positions get no gradient (the port's
callers pass ray samples, which are data).  ops/scatter_accum.py holds the
other table backward, kernel K2 (`FieldStatic(fast_table_grad=True)`).
"""

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
BLOCK = 4


class BlockGridMeta:
    """Static per-level constants (numpy), identical to enerf_tpu's."""

    def __init__(
        self,
        num_levels=16,
        level_dim=2,
        per_level_scale=2.0,
        base_resolution=16,
        log2_hashmap_size=19,
        desired_resolution=None,
        block=BLOCK,
    ):
        self.block = int(block)
        self.halo = self.block + 1
        self.row_cells = self.halo ** 3
        if desired_resolution is not None and num_levels > 1:
            per_level_scale = float(
                np.exp2(np.log2(desired_resolution / base_resolution) / (num_levels - 1))
            )
        self.input_dim = 3
        self.num_levels = int(num_levels)
        self.level_dim = int(level_dim)
        self.per_level_scale = float(per_level_scale)
        self.base_resolution = int(base_resolution)
        self.log2_hashmap_size = int(log2_hashmap_size)
        self.output_dim = self.num_levels * self.level_dim

        S = np.log2(self.per_level_scale)
        H = self.base_resolution
        BLK = self.block
        # hashed levels hold ~2x the reference's entry budget whatever the
        # block size (block=4: 8192 rows x 125 cells at log2 size 19)
        max_rows = max((2 ** self.log2_hashmap_size * 128) // (64 * self.row_cells), 1)

        scales, nbs, n_rows, hashed, offsets = [], [], [], [], [0]
        for lvl in range(self.num_levels):
            scale = np.exp2(lvl * S) * H - 1.0
            res = int(np.ceil(scale)) + 1
            nb = (res + 1 + BLK - 1) // BLK  # blocks per dim (corners <= res)
            dense_rows = nb ** 3
            is_hashed = dense_rows > max_rows
            rows = max_rows if is_hashed else dense_rows
            scales.append(scale)
            nbs.append(nb)
            n_rows.append(rows)
            hashed.append(is_hashed)
            offsets.append(offsets[-1] + rows)
        self.scales = np.asarray(scales, np.float32)
        self.nbs = np.asarray(nbs, np.int64)
        self.n_rows = np.asarray(n_rows, np.int64)
        self.hashed = np.asarray(hashed, bool)
        self.offsets = np.asarray(offsets, np.int64)
        self.total_rows = int(self.offsets[-1])
        self._dev = {}

    def tensors(self, device):
        """Per-level constants as tensors on `device` (cached per device)."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {
                "scales": torch.as_tensor(self.scales, device=device),
                "nbs": torch.as_tensor(self.nbs, device=device),
                "rows": torch.as_tensor(self.n_rows, device=device),
                "hashed": torch.as_tensor(self.hashed, device=device),
                "offsets": torch.as_tensor(self.offsets[:-1], device=device),
            }
        return self._dev[key]


def init_block_table(meta, generator=None, device="cpu"):
    """[total_rows, row_cells * C] f32 parameters, U(-1e-4, 1e-4) like the reference."""
    t = torch.empty(meta.total_rows, meta.row_cells * meta.level_dim, device=device)
    return t.uniform_(-1e-4, 1e-4, generator=generator)


def block_address(x, meta):
    """Block addressing for pre-clipped [n, 3] positions in [0, 1].

    Returns (rid_local [n, L] int64 row within each level's table,
    lo [n, L, 3] int64 cell offset in the block, frac [n, L, 3] f32).
    The uint32 hash of the JAX package is done in int64 and masked to 32
    bits before the modulo, which gives the same row ids.
    """
    m = meta.tensors(x.device)
    pos = x[:, None, :] * m["scales"][None, :, None] + 0.5  # [n, L, 3]
    pg = torch.floor(pos)
    frac = pos - pg
    pg = pg.to(torch.int64)
    b = torch.div(pg, meta.block, rounding_mode="floor")
    lo = pg - b * meta.block

    nb = m["nbs"][None, :]
    dense = (b[..., 0] * nb + b[..., 1]) * nb + b[..., 2]
    h = (b[..., 0] * _PRIMES[0]) & _U32
    h = h ^ ((b[..., 1] * _PRIMES[1]) & _U32)
    h = h ^ ((b[..., 2] * _PRIMES[2]) & _U32)
    rid = torch.where(m["hashed"][None, :], h, dense & _U32)
    return torch.remainder(rid, m["rows"][None, :]), lo, frac


def _trilinear_weights(lo, frac, meta):
    """lo [..., 3] int, frac [..., 3] f32 -> W [..., row_cells] f32 with
    W[(px*HA + py)*HA + pz] = wx(px) * wy(py) * wz(pz)."""
    HA = meta.halo
    p = torch.arange(HA, device=lo.device)

    def axis_w(d):
        l = lo[..., d, None]
        f = frac[..., d, None]
        zero = torch.zeros((), dtype=f.dtype, device=f.device)
        return (torch.where(p == l, 1.0 - f, zero)
                + torch.where(p == l + 1, f, zero))  # [..., HA]

    wx, wy, wz = axis_w(0), axis_w(1), axis_w(2)
    W = (wx[..., :, None, None] * wy[..., None, :, None]) * wz[..., None, None, :]
    return W.reshape(*lo.shape[:-1], meta.row_cells)


def _chunk_rows(x, meta):
    """Global row ids [n, L] and trilinear weights [n, L, RC] of a chunk."""
    rid_local, lo, frac = block_address(x, meta)
    rid = rid_local + meta.tensors(x.device)["offsets"][None, :]
    return rid, _trilinear_weights(lo, frac, meta)


def _encode_chunk(x, table, meta):
    """[n, 3] in [0, 1] (pre-clipped) -> [n, L, C]; rows are channel-planar
    (row[c * RC + p])."""
    n = x.shape[0]
    L, C, RC = meta.num_levels, meta.level_dim, meta.row_cells
    rid, W = _chunk_rows(x, meta)
    rows = table[rid].view(n, L, C, RC)  # the gather
    return torch.einsum("nlcr,nlr->nlc", rows, W.to(rows.dtype))


def encode_forward(x01, table, meta, point_chunk, out=None):
    """The encoder's forward pass in point chunks -> (enc [N, L*C], the
    clipped positions [N, 3] f32, the out-of-box mask [N]).  With `out`, a
    kept encoding of the same positions, the gather is skipped and a copy
    of `out` is returned."""
    N = x01.shape[0]
    x = x01.to(torch.float32)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    x = x.clamp(0.0, 1.0)
    if out is not None:
        return out.clone(), x, oob
    out = torch.cat([
        _encode_chunk(x[s:s + point_chunk], table, meta)
        for s in range(0, N, point_chunk)
    ]) if N else table.new_zeros(0, meta.num_levels, meta.level_dim)
    out = out.masked_fill(oob[:, None, None], 0.0)
    return out.reshape(N, meta.output_dim), x, oob


class _BlockEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, meta, point_chunk, out):
        out, x, oob = encode_forward(x, table, meta, point_chunk, out)
        ctx.save_for_backward(x, oob)
        ctx.meta, ctx.point_chunk = meta, point_chunk
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[0]:
            raise NotImplementedError("block_encode: position gradients")
        x, oob = ctx.saved_tensors
        meta, chunk = ctx.meta, ctx.point_chunk
        L, C, RC = meta.num_levels, meta.level_dim, meta.row_cells
        g = g.reshape(-1, L, C).to(torch.float32).masked_fill(oob[:, None, None], 0.0)
        grad = torch.zeros(ctx.table_shape, dtype=torch.float32, device=g.device)
        for s in range(0, x.shape[0], chunk):
            rid, W = _chunk_rows(x[s:s + chunk], meta)
            contrib = g[s:s + chunk, :, :, None] * W[:, :, None, :]  # [n, L, C, RC]
            grad.index_add_(0, rid.reshape(-1), contrib.reshape(-1, C * RC))
        return None, grad.to(ctx.table_dtype), None, None, None


def block_encode(x01, table, meta, point_chunk=1 << 16, out=None):
    """Encode [N, 3] positions in [0, 1] -> [N, L*C]; samples outside the
    unit box encode to 0.  Differentiable in `table`.  `out`: a kept
    encoding of the same positions, returned (copied) without the gather."""
    return _BlockEncode.apply(x01, table, meta, point_chunk, out)
