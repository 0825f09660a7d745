"""Block-grid table gradient: kernel K2 (csrc/block_table_grad.cu) and its twin.

Counterpart of enerf_tpu/ops/scatter_accum.py.  The table gradient of the
block-packed encoder adds, for each (sample, level) pair, the trilinear
weights over the sample's row (halo^3 cells) times the pair's two feature
gradients into that row.  `block_table_grad` picks its implementation from
the device of its inputs: the plain PyTorch version on CPU tensors, kernel
K2 on CUDA tensors (a failed build or launch raises).

Inputs are flat over the pairs, pair i = sample * L + level: `rid` [P]
int32 global row ids (level offsets added), `lo` [P, 3] int32 cell offsets
in the block, `frac` [P, 3] f32, `g` [P, 2] f32.  The output is the flat
[total_rows, 2 * row_cells] gradient in the table's channel-planar layout
(row[c * row_cells + p]); K2 needs no padding and no depad, unlike the TPU
kernel's per-level [rows_max, 2 * cell_pad] tiles.

`block_encode_fast` is `block_encode` with this backward: positions get a
zero gradient, as in the JAX package (rays are data, not parameters).
"""

import ctypes

import torch

from enerf_torch.ops.blockgrid import _trilinear_weights, block_address, encode_forward

PAIR_CHUNK = 1 << 20  # pairs per chunk of the plain version's dense rows


def pair_inputs(x, g_out, meta, oob=None):
    """K2's inputs for clipped positions x [N, 3] and the gradient of the
    encoding g_out [N, L * 2], zeroed for the out-of-box samples `oob` [N]:
    (rid [N*L] int32, lo [N*L, 3] int32, frac [N*L, 3] f32, g [N*L, 2] f32)."""
    rid, lo, frac = block_address(x, meta)
    rid = rid + meta.tensors(x.device)["offsets"][None, :]
    g = g_out.reshape(-1, meta.num_levels, 2).to(torch.float32)
    if oob is not None:
        g = g.masked_fill(oob[:, None, None], 0.0)
    return (rid.reshape(-1).to(torch.int32), lo.reshape(-1, 3).to(torch.int32),
            frac.reshape(-1, 3).contiguous(), g.reshape(-1, 2).contiguous())


def block_table_grad_reference(rid, lo, frac, g, total_rows, meta, dtype=torch.float32):
    """The plain version of K2: the dense g (x) W rows [P, 2 * row_cells],
    scattered with `index_add_` (enerf_tpu's block_table_grad_reference),
    in point chunks.  `dtype` is the arithmetic type (float64 gives the
    error bound the card's checks use)."""
    RC = meta.row_cells
    grad = torch.zeros(total_rows, 2 * RC, dtype=dtype, device=g.device)
    for s in range(0, rid.shape[0], PAIR_CHUNK):
        W = _trilinear_weights(lo[s:s + PAIR_CHUNK], frac[s:s + PAIR_CHUNK].to(dtype), meta)
        rows = g[s:s + PAIR_CHUNK, :, None].to(dtype) * W[:, None, :]  # [p, 2, RC]
        grad.index_add_(0, rid[s:s + PAIR_CHUNK].long(), rows.reshape(-1, 2 * RC))
    return grad


def _check(rid, lo, frac, g, meta):
    P = rid.shape[0]
    if meta.level_dim != 2:
        raise ValueError(f"block_table_grad takes level_dim 2, got {meta.level_dim}")
    if (rid.dtype != torch.int32 or lo.dtype != torch.int32
            or frac.dtype != torch.float32 or g.dtype != torch.float32):
        raise TypeError("block_table_grad takes rid, lo int32 and frac, g float32, got "
                        f"{[t.dtype for t in (rid, lo, frac, g)]}")
    if (rid.dim() != 1 or lo.shape != (P, 3) or frac.shape != (P, 3)
            or g.shape != (P, 2)):
        raise ValueError("block_table_grad: inconsistent shapes "
                         f"{[tuple(t.shape) for t in (rid, lo, frac, g)]}")
    if any(t.device != rid.device for t in (lo, frac, g)):
        raise ValueError("block_table_grad: operands on different devices")


def _lib():
    from enerf_torch.ops.cuda_build import load_library
    lib = load_library("block_table_grad")
    fn = lib.block_table_grad_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_kernel(rid, lo, frac, g, total_rows, meta):
    """Launch K2 on CUDA tensors -> [total_rows, 2 * row_cells] f32."""
    _check(rid, lo, frac, g, meta)
    if not rid.is_cuda:
        raise ValueError("launch_kernel needs CUDA tensors")
    ops = [t.contiguous() for t in (rid, lo, frac, g)]
    grad = torch.empty(total_rows, 2 * meta.row_cells, dtype=torch.float32,
                       device=rid.device)
    fn = _lib()
    with torch.cuda.device(rid.device):
        stream = torch.cuda.current_stream(rid.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ops], grad.data_ptr(), rid.shape[0],
                 total_rows, meta.halo, meta.row_cells, stream)
    if err != 0:
        raise RuntimeError(f"block_table_grad kernel launch failed: cudaError {err}")
    block_table_grad.launches += 1
    return grad


def block_table_grad(rid, lo, frac, g, total_rows, meta):
    """Table gradient [total_rows, 2 * row_cells] f32: K2 on CUDA tensors,
    the plain version on CPU tensors."""
    if rid.is_cuda:
        return launch_kernel(rid, lo, frac, g, total_rows, meta)
    _check(rid, lo, frac, g, meta)
    return block_table_grad_reference(rid, lo, frac, g, total_rows, meta)


block_table_grad.launches = 0  # kernel launches (CUDA path only)


class _BlockEncodeFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x01, table, meta, point_chunk, out):
        if meta.level_dim != 2:
            raise ValueError("block_encode_fast supports level_dim == 2")
        out, x, oob = encode_forward(x01, table, meta, point_chunk, out)
        ctx.save_for_backward(x, oob)
        ctx.meta = meta
        ctx.x_dtype, ctx.table_dtype = x01.dtype, table.dtype
        return out

    @staticmethod
    def backward(ctx, g_out):
        x, oob = ctx.saved_tensors
        meta = ctx.meta
        grad = block_table_grad(*pair_inputs(x, g_out, meta, oob), meta.total_rows, meta)
        gx = (torch.zeros(x.shape, dtype=ctx.x_dtype, device=x.device)
              if ctx.needs_input_grad[0] else None)
        return gx, grad.to(ctx.table_dtype), None, None, None


def block_encode_fast(x01, table, meta, point_chunk=1 << 16, out=None):
    """`block_encode` whose table backward is K2 (the plain version on the
    CPU); the gradient with respect to the positions is zero."""
    return _BlockEncodeFast.apply(x01, table, meta, point_chunk, out)
