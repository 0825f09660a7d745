"""Morton (Z-order) codes and the density grid's bit packing.

Counterpart of enerf_tpu/ops/morton.py (reference raymarching.cu:216-302:
__morton3D by bit expansion, __morton3D_invert, kernel_packbits).  The
uint32 products of the CUDA and XLA versions are done in int64: each mask
keeps bits below 2^32 only, which gives the same bits (torch's uint32 dtype
has only partial operator support).
"""

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v):
    """Spread the low 10 bits of v so that two zero bits separate them."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords):
    """[..., 3] int coordinates (each < 1024) -> [...] int32 Morton codes."""
    c = coords.to(torch.int64) & _U32
    x, y, z = (_expand_bits(c[..., d]) for d in range(3))
    return ((x | (y << 1) | (z << 2)) & _U32).to(torch.int32)


def _compact_bits(v):
    v = v & 0x49249249
    v = (v | (v >> 2)) & 0xC30C30C3
    v = (v | (v >> 4)) & 0x0F00F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def morton3d_invert(indices):
    """[...] int32 Morton codes -> [..., 3] int32 coordinates."""
    i = indices.to(torch.int64) & _U32
    return torch.stack([_compact_bits(i), _compact_bits(i >> 1), _compact_bits(i >> 2)],
                       dim=-1).to(torch.int32)


def packbits(grid, density_thresh):
    """[C, H^3] float density grid -> [C * H^3 / 8] uint8 bitfield: bit i of
    byte n is cell 8 n + i (reference kernel_packbits)."""
    occ = (grid.reshape(-1, 8) > density_thresh).to(torch.int64)
    shifts = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], device=grid.device)
    return (occ * shifts).sum(-1).to(torch.uint8)


def occupancy_bool(grid, density_thresh):
    """[C, H^3] float grid -> [C, H^3] bool occupancy."""
    return grid > density_thresh
