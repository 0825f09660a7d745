"""Multiresolution hash-grid encoding (instant-ngp section 3).

Counterpart of enerf_tpu/ops/hashgrid.py (reference gridencoder.cu:34-222,
grid.py:113-135): per level, pos = x01 * scale + 0.5; each of the 2^D
corners of the sample's cell is addressed by the dense linear index while
the level fits its table, else by the spatial hash x*1 ^ y*2654435761 ^
z*805459861 (the first D primes), modulo the level's table size; the corner
embeddings are blended (bi/tri)linearly.  Samples outside [0, 1]^D encode
to 0.  D = 3 for the field, D = 2 for the background net's sphere
coordinates.

`hash_encode` runs kernel pair H1 (csrc/hash_encode.cu) on CUDA tensors:
H1.fwd computes the addresses in registers and writes only the encoding,
H1.bwd recomputes them from the positions and scatter-adds the table
gradient with atomics.  Its autograd node keeps the positions x01 (and the
table only when x01 needs a gradient), never the addresses.  On CPU tensors
it runs the plain functions below, the backward recomputing the addresses
the same way; they are also what the card tests hold H1 to.

The plain version's uint32 arithmetic (the dense index and the hash wrap at
2^32, as in the CUDA and XLA versions) is done in int64, masked with
0xFFFFFFFF after each product and each sum, which gives the same indices;
torch's uint32 dtype has only partial operator support.

`hash_address` is the address step alone (flat table indices and weights
per sample, level and corner), so tests can hand the same addresses to
both packages.  The table gradient is the gather's VJP, an `index_add_` of
w * g per corner into the table (`table_grad_from_address`).  When the
positions need a gradient it is the one JAX's autodiff gives (reference
dy_dx, gridencoder.cu:176-221): dx_d = sum over levels of scale_l times
sum over corners of dw/dfrac_d * <g, table row>, zero outside the box
(`position_grad_from_address`, over recomputed addresses, on either
device).
"""

import ctypes

import numpy as np
import torch

from enerf_torch.utils import profiling

# Hash primes, reference gridencoder.cu:41 (instant-ngp constants)
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class HashGridMeta:
    """Static per-level constants (numpy), identical to enerf_tpu's
    HashGridMeta (reference grid.py:113-126), for 2-D or 3-D inputs."""

    def __init__(
        self,
        input_dim=3,
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
        if input_dim not in (2, 3):
            raise ValueError(f"HashGridMeta: input_dim must be 2 or 3, got {input_dim}")
        self.input_dim = int(input_dim)
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
        # H1's per-level constants as its C interface takes them: scales,
        # uint32 strides [L, D], sizes, offsets, the hashed levels' bit mask
        self.kernel_constants = (
            self.scales, ((strides % 2 ** 32) * use_dim).astype(np.uint32),
            self.sizes.astype(np.uint32), self.offsets[:-1].astype(np.uint32),
            sum(1 << lvl for lvl in range(L) if self.is_hashed[lvl]))

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


def _corner_bits(D):
    """[2^D][D] offsets: corner c takes bit d of c along axis d (JAX's order)."""
    return [[(c >> d) & 1 for d in range(D)] for c in range(2 ** D)]


def _cell(x01, meta):
    """Clipped positions -> (pg [N, L, D] int64 cell, frac [N, L, D] f32,
    oob [N] samples outside the unit box)."""
    x = x01.to(torch.float32)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    x = x.clamp(0.0, 1.0)
    pos = x[:, None, :] * meta.tensors(x.device)["scales"][None, :, None] + 0.5  # [N, L, D]
    pg = torch.floor(pos)
    return pg.to(torch.int64), pos - pg, oob


def hash_address(x01, meta):
    """The address step for positions x01 [N, D] (in [0, 1] inside the box).

    Returns (idx [N, L, 2^D] int32 flat table rows, level offsets added;
    w [N, L, 2^D] f32 weights; oob [N] bool, samples outside the unit
    box).  Corner c takes bit d of c as its offset along axis d, and its
    weight is the product over d of frac or 1 - frac, in axis order.
    """
    D = meta.input_dim
    pg, frac, oob = _cell(x01, meta)
    m = meta.tensors(pg.device)
    strides = m["strides"][None]
    idx, w = [], []
    for bits in _corner_bits(D):
        corner = [pg[..., d] + bits[d] for d in range(D)]
        wc = None
        for d in range(D):
            f = frac[..., d] if bits[d] else 1.0 - frac[..., d]
            wc = f if wc is None else wc * f
        dense = (corner[0] * strides[..., 0]) & _U32
        h = (corner[0] * _PRIMES[0]) & _U32
        for d in range(1, D):
            dense = (dense + ((corner[d] * strides[..., d]) & _U32)) & _U32
            h = h ^ ((corner[d] * _PRIMES[d]) & _U32)
        flat = torch.remainder(torch.where(m["hashed"][None], h, dense), m["sizes"][None])
        idx.append((flat + m["offsets"][None]).to(torch.int32))
        w.append(wc)
    return torch.stack(idx, -1), torch.stack(w, -1), oob


def encode_from_address(idx, w, oob, table):
    """[N, L * C] encoding from the addresses: the per-corner gather and the
    blend, summed over the corners in order."""
    N, L, corners = idx.shape
    out = None
    for c in range(corners):
        term = w[..., c, None].to(table.dtype) * table[idx[..., c]]  # [N, L, C]
        out = term if out is None else out + term
    out = out.masked_fill(oob[:, None, None], 0.0)
    return out.reshape(N, L * table.shape[1])


def table_grad_from_address(idx, w, oob, g, table_shape):
    """The f32 table gradient of `encode_from_address` for the output
    gradient g [N, L * C]: per corner, index_add_ of w * g into the rows."""
    N, L, corners = idx.shape
    C = table_shape[1]
    g = g.reshape(N, L, C).to(torch.float32).masked_fill(oob[:, None, None], 0.0)
    grad = torch.zeros(table_shape, dtype=torch.float32, device=g.device)
    for c in range(corners):
        grad.index_add_(0, idx[..., c].reshape(-1), (w[..., c, None] * g).reshape(-1, C))
    return grad


def position_grad_from_address(x01, idx, oob, table, g, meta):
    """dL/dx01 [N, D] of `encode_from_address` for the output gradient g
    [N, L * C]: sum over levels of scale_l times sum over corners of
    dw/dfrac_d * <g, table row>; zero for samples outside the box (their
    encoding is the constant 0) and nothing from floor()."""
    N, L, corners = idx.shape
    D = meta.input_dim
    _, frac, _ = _cell(x01, meta)
    g = g.reshape(N, L, -1).to(torch.float32).masked_fill(oob[:, None, None], 0.0)
    # <g, row> of each corner: [N, L, 2^D]
    gv = torch.stack([(g * table[idx[..., c]].float()).sum(-1) for c in range(corners)], -1)
    dx = []
    for d in range(D):
        acc = None
        for c, bits in enumerate(_corner_bits(D)):
            dw = None  # dw_c / dfrac_d: +-1 times the other axes' factors
            for e in range(D):
                if e != d:
                    f = frac[..., e] if bits[e] else 1.0 - frac[..., e]
                    dw = f if dw is None else dw * f
            term = dw * gv[..., c]
            term = term if bits[d] else -term
            acc = term if acc is None else acc + term
        dx.append((acc * meta.tensors(g.device)["scales"][None]).sum(-1))
    return torch.stack(dx, -1).to(x01.dtype)


def _lib():
    from enerf_torch.ops.cuda_build import load_library
    lib = load_library("hash_encode")
    for fn in (lib.hash_encode_forward_launch, lib.hash_encode_backward_launch):
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                           + [ctypes.c_void_p] * 4 + [ctypes.c_uint, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _check_kernel(x01, rows, meta, g=None):
    """Raise on what H1 does not take: float32 contiguous CUDA tensors on one
    device, x01 [N, D], the table or gradient [total_entries, C] 16-byte
    aligned, g [N, L * C]; C in 1, 2, 4, 8 and at most 32 levels."""
    D, C, L = meta.input_dim, meta.level_dim, meta.num_levels
    if C not in (1, 2, 4, 8) or L > 32:
        raise ValueError(f"the hash-grid kernel takes 1, 2, 4 or 8 channels and at most 32 "
                         f"levels, got {C} and {L}")
    ops = [x01, rows] + ([] if g is None else [g])
    if not all(t.is_cuda and t.device == x01.device for t in ops):
        raise ValueError("the hash-grid kernel takes CUDA tensors on one device")
    if not all(t.dtype == torch.float32 for t in ops):
        raise TypeError(f"the hash-grid kernel takes float32 tensors, got "
                        f"{[t.dtype for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the hash-grid kernel takes contiguous tensors")
    N = x01.shape[0]
    if x01.shape != (N, D) or rows.shape != (meta.total_entries, C) or (
            g is not None and g.shape != (N, L * C)):
        raise ValueError(f"the hash-grid kernel takes x01 [N, {D}], a table [{meta.total_entries}, "
                         f"{C}] and g [N, {L * C}], got {[tuple(t.shape) for t in ops]}")
    if rows.data_ptr() % 16:
        raise ValueError("the hash-grid kernel takes a 16-byte aligned table")


def _launch(fn, x01, src, dst, meta):
    with torch.cuda.device(x01.device):
        err = fn(x01.data_ptr(), src.data_ptr(), dst.data_ptr(), x01.shape[0], meta.input_dim,
                 meta.level_dim, meta.num_levels,
                 *(c.ctypes.data for c in meta.kernel_constants[:4]), meta.kernel_constants[4],
                 torch.cuda.current_stream(x01.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash-grid kernel launch failed: cudaError {err}")


def hash_encode_kernel(x01, table, meta):
    """H1.fwd on CUDA tensors: the encoding [N, L * C] f32 of positions
    x01 [N, D], bit-equal to encode_from_address(*hash_address(x01, meta),
    table)."""
    _check_kernel(x01, table, meta)
    out = torch.empty(x01.shape[0], meta.output_dim, device=x01.device)
    if x01.shape[0]:
        _launch(_lib().hash_encode_forward_launch, x01, table, out, meta)
        hash_encode_kernel.launches += 1
    return out


def hash_table_grad_kernel(x01, g, meta):
    """H1.bwd on CUDA tensors: the f32 table gradient of hash_encode for the
    output gradient g [N, L * C], the addresses recomputed from x01; the
    addends of table_grad_from_address, summed by atomics in another
    order."""
    grad = torch.zeros(meta.total_entries, meta.level_dim, device=x01.device)
    _check_kernel(x01, grad, meta, g)
    if x01.shape[0]:
        _launch(_lib().hash_encode_backward_launch, x01, g, grad, meta)
        hash_table_grad_kernel.launches += 1
    return grad


hash_encode_kernel.launches = 0      # H1.fwd launches
hash_table_grad_kernel.launches = 0  # H1.bwd launches


class _HashEncode(torch.autograd.Function):
    """The encode and its VJP, as the spans `encode.fwd` and `encode.bwd`
    (utils/profiling.py).  The node saves the positions x01, and the table
    only when x01 needs a gradient; the backward recomputes the addresses
    from x01.  CUDA tensors go to H1 (a shape, type or layout H1 does not
    take raises), CPU tensors to the plain functions.  The position
    gradient is position_grad_from_address over recomputed addresses on
    either device: no training path asks for it (the sample positions
    derive from rays, not from parameters; `position_grads` is a TPU
    variant, config.py TPU_ONLY)."""

    @staticmethod
    def forward(ctx, x01, table, meta, out):
        with profiling.span("encode.fwd", x01.device):
            dx = ctx.needs_input_grad[0]
            ctx.save_for_backward(x01, table if dx else None)
            ctx.meta, ctx.table_shape, ctx.table_dtype = meta, table.shape, table.dtype
            if out is not None:  # replay of a kept encoding (remat_fixed=2)
                return out.clone()
            if x01.is_cuda or table.is_cuda:
                return hash_encode_kernel(x01, table, meta)
            return encode_from_address(*hash_address(x01, meta), table)

    @staticmethod
    def backward(ctx, g):
        with profiling.span("encode.bwd", g.device):
            x01, table = ctx.saved_tensors
            meta = ctx.meta
            if x01.is_cuda:
                grad = hash_table_grad_kernel(x01, g.contiguous(), meta)
            else:
                grad = table_grad_from_address(*hash_address(x01, meta), g, ctx.table_shape)
            dx = None
            if ctx.needs_input_grad[0]:
                idx, _, oob = hash_address(x01, meta)
                dx = position_grad_from_address(x01, idx, oob, table, g, meta)
            return dx, grad.to(ctx.table_dtype), None, None


def hash_encode(x01, table, meta, out=None):
    """Encode [N, D] positions in [0, 1] -> [N, L * C] (level-major, then
    channel); samples outside the unit box encode to 0.  Differentiable in
    `table` and in `x01`.  H1 on CUDA tensors, the plain functions on CPU
    tensors.  `out`: a previously computed encoding of the same positions,
    returned (copied) without the gather, with the same table backward."""
    return _HashEncode.apply(x01, table, meta, out)
