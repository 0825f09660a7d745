"""Block-grid table gradient: kernel K2 (csrc/block_table_grad.cu) and its twin.

Counterpart of enerf_tpu/ops/scatter_accum.py.  The table gradient of the
block-packed encoder adds, for each (sample, level) pair, the trilinear
weights over the sample's row (halo^3 cells) times the pair's two feature
gradients into that row.  `block_table_grad` picks its implementation from
the device of its inputs: the plain PyTorch version on CPU tensors, kernel
K2 on CUDA tensors (a failed build or launch raises).

Inputs are flat over the (sample, level) pairs, in any order
(`pair_inputs` lists them level by level): `rid` [P] int32 global row ids
(level offsets added), `lo` [P, 3] int32 cell offsets in the block, `frac`
[P, 3] f32, `g` [P, 2] f32.  The output is the flat
[total_rows, 2 * row_cells] gradient in the table's channel-planar layout
(row[c * row_cells + p]); K2 needs no padding and no depad, unlike the TPU
kernel's per-level [rows_max, 2 * cell_pad] tiles.

K2 first sorts the pairs into tiles of consecutive rows whose gradient
fits one block's shared memory, cut into chunks of at most CHUNK_PAIRS
pairs; `table_grad_plan` computes that plan in plain PyTorch, and the CPU
tests accumulate chunk by chunk along it as the kernel does.

`block_encode_fast` is `block_encode` with this backward: positions get a
zero gradient, as in the JAX package (rays are data, not parameters).
"""

import ctypes
from typing import NamedTuple

import torch

from enerf_torch.ops.blockgrid import _trilinear_weights, block_address, encode_forward

PAIR_CHUNK = 1 << 20  # pairs per chunk of the plain version's dense rows
TILE_BYTES = 96 * 1024  # shared memory of one K2 block: a tile of rows' gradient
CHUNK_PAIRS = 4096  # K2's work list: pairs per chunk at most


def pair_inputs(x, g_out, meta, oob=None):
    """K2's inputs for clipped positions x [N, 3] and the gradient of the
    encoding g_out [N, L * 2], zeroed for the out-of-box samples `oob` [N]:
    (rid [L*N] int32, lo [L*N, 3] int32, frac [L*N, 3] f32, g [L*N, 2] f32),
    listed level by level (pair level * N + sample), so that a run of
    consecutive pairs falls on few of K2's tiles.  The addresses come out
    in that order; only g is transposed."""
    rid, lo, frac = block_address(x, meta, level_major=True)
    rid = rid + meta.tensors(x.device)["offsets"][:, None]
    L, N = rid.shape
    g = torch.empty(L, N, 2, dtype=torch.float32, device=x.device)
    g.copy_(g_out.reshape(N, L, 2).transpose(0, 1))
    if oob is not None:
        g.masked_fill_(oob[None, :, None], 0.0)
    return (rid.reshape(-1).to(torch.int32), lo.reshape(-1, 3).to(torch.int32),
            frac.reshape(-1, 3), g.reshape(-1, 2))


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


def tile_rows_of(meta):
    """Rows per tile of K2's plan: the most whose gradient (2 * row_cells
    f32 each) fits TILE_BYTES of shared memory, rounded down to an even
    count, so that every tile's span of the flat gradient starts on a
    16-byte boundary."""
    rows = TILE_BYTES // (8 * meta.row_cells)
    rows -= rows % 2
    if rows < 2:
        raise ValueError(f"block_table_grad: rows of {8 * meta.row_cells} bytes, fewer than 2 "
                         f"fit a tile of {TILE_BYTES} bytes")
    return rows


class TablePlan(NamedTuple):
    """The plan of K2's pre-pass.  Tile t holds the rows [t * tile_rows,
    (t + 1) * tile_rows); its records are [offsets[t], offsets[t + 1]) of
    `order` (the pair of each record), cut into chunks of at most
    chunk_pairs records; a tile of one chunk is owned, a tile of several
    shared.  A tile with no record has one chunk, empty, which writes its
    zeros."""
    tile_rows: int
    counts: torch.Tensor        # [tiles] int64, the live pairs on each tile
    offsets: torch.Tensor       # [tiles + 1] int64
    order: torch.Tensor         # [records] int64 pair indices, tile by tile
    chunk_tile: torch.Tensor    # [chunks] int64
    chunk_begin: torch.Tensor   # [chunks] int64 first record
    chunk_end: torch.Tensor     # [chunks] int64 one past the last record
    chunk_shared: torch.Tensor  # [chunks] bool


def table_grad_plan(rid, g, total_rows, tile_rows, chunk_pairs=CHUNK_PAIRS):
    """The plan that K2's pre-pass builds, in plain PyTorch: pairs whose g
    is all zero (out-of-box samples) are left out, the others are listed
    tile by tile in pair order (the kernel's order within a tile is any)."""
    dev = rid.device
    tiles = -(-total_rows // tile_rows)
    live = torch.nonzero((g != 0).any(dim=1)).squeeze(1)
    tile = rid[live].long() // tile_rows
    counts = torch.bincount(tile, minlength=tiles)
    offsets = torch.zeros(tiles + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    order = live[torch.argsort(tile, stable=True)]
    per_tile = torch.clamp((counts + chunk_pairs - 1) // chunk_pairs, min=1)
    chunk_tile = torch.repeat_interleave(torch.arange(tiles, device=dev), per_tile)
    first = torch.cumsum(per_tile, 0) - per_tile  # each tile's first chunk
    begin = offsets[chunk_tile] + (torch.arange(chunk_tile.shape[0], device=dev)
                                   - first[chunk_tile]) * chunk_pairs
    end = torch.minimum(begin + chunk_pairs, offsets[chunk_tile + 1])
    return TablePlan(tile_rows, counts, offsets, order, chunk_tile, begin, end,
                     per_tile[chunk_tile] > 1)


def _scratch(P, total_rows, tile_rows, device):
    """K2's scratch (csrc/block_table_grad.cu: Scratch), one byte buffer:
    the records (16 + 8 bytes per pair), then the int32 plan."""
    tiles = -(-total_rows // tile_rows)
    max_chunks = tiles + -(-P // CHUNK_PAIRS)
    return torch.empty(24 * P + 4 * (4 * tiles + 4 + max_chunks), dtype=torch.uint8,
                       device=device)


def _lib():
    from enerf_torch.ops.cuda_build import load_library
    lib = load_library("block_table_grad")
    pre, launch = lib.block_table_grad_prepass, lib.block_table_grad_launch
    if pre.argtypes is None:
        pre.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        pre.restype = ctypes.c_int
        launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        launch.restype = ctypes.c_int
    return pre, launch


def launch_prepass(rid, lo, frac, g, total_rows, meta):
    """K2's pre-pass alone on CUDA tensors -> its scratch (records, plan)."""
    if not rid.is_cuda:
        raise ValueError("launch_prepass needs CUDA tensors")
    P, tile_rows = rid.shape[0], tile_rows_of(meta)
    scratch = _scratch(P, total_rows, tile_rows, rid.device)
    ops = [t.contiguous() for t in (rid, lo, frac, g)]
    pre, _ = _lib()
    with torch.cuda.device(rid.device):
        err = pre(*[t.data_ptr() for t in ops], scratch.data_ptr(), P, total_rows, tile_rows,
                  CHUNK_PAIRS, meta.halo,
                  torch.cuda.current_stream(rid.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_table_grad pre-pass launch failed: cudaError {err}")
    return scratch


def device_plan(rid, lo, frac, g, total_rows, meta):
    """The plan of K2's pre-pass as the card builds it, on CUDA tensors:
    {counts, offsets, chunk_tile} as int64, TablePlan's fields of those
    names (the card's order of the records within a tile is any)."""
    _check(rid, lo, frac, g, meta)
    P, T = rid.shape[0], -(-total_rows // tile_rows_of(meta))
    plan = launch_prepass(rid, lo, frac, g, total_rows, meta)[24 * P:].view(torch.int32)
    return dict(counts=plan[:T].long(), offsets=plan[T:2 * T + 1].long(),
                chunk_tile=plan[4 * T + 4:4 * T + 4 + int(plan[4 * T + 2])].long())


def launch_kernel(rid, lo, frac, g, total_rows, meta):
    """Launch K2 on CUDA tensors -> [total_rows, 2 * row_cells] f32: the
    pre-pass sorts the pairs into tiles of rows that fit TILE_BYTES of
    shared memory, and persistent blocks accumulate each chunk of at most
    CHUNK_PAIRS pairs in shared memory and write its tile."""
    _check(rid, lo, frac, g, meta)
    if not rid.is_cuda:
        raise ValueError("launch_kernel needs CUDA tensors")
    grad = torch.empty(total_rows, 2 * meta.row_cells, dtype=torch.float32, device=rid.device)
    if total_rows == 0:
        return grad
    P = rid.shape[0]
    tile_rows = tile_rows_of(meta)
    scratch = _scratch(P, total_rows, tile_rows, rid.device)
    ops = [t.contiguous() for t in (rid, lo, frac, g)]
    _, launch = _lib()
    with torch.cuda.device(rid.device):
        err = launch(*[t.data_ptr() for t in ops], grad.data_ptr(), scratch.data_ptr(), P,
                     total_rows, tile_rows, CHUNK_PAIRS, meta.halo, meta.row_cells,
                     torch.cuda.current_stream(rid.device).cuda_stream)
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
