"""Helpers of the port's parity tests around the march.

The port's march takes the occupancy bitfield packed into 32-bit words
(enerf_torch.render.occupancy.pack_bitfield); JAX's takes the bool one.
A test hands the port packed words and JAX their unpacked bits.
"""

import torch

from enerf_torch.render.occupancy import GRID_SIZE, SUPER


def unpack_bitfield(occ_packed):
    """[CAS * (H/4)^3, 2] int32 -> [CAS, H^3] bool: pack_bitfield's inverse."""
    HS = GRID_SIZE // SUPER
    words = occ_packed.to(torch.int64) & 0xFFFFFFFF
    bits = (words[..., None] >> torch.arange(32, device=words.device)) & 1   # [.., 2, 32]
    cells = bits.reshape(-1, HS, HS, HS, SUPER, SUPER, SUPER).bool()
    return cells.permute(0, 1, 4, 2, 5, 3, 6).reshape(-1, GRID_SIZE ** 3)


def per_render(march):
    """A stand-in for march_rays_pair that runs `march`, a stand-in for
    march_rays, on each render of the pair with that render's jitter."""
    def march_rays_pair(rays_o, rays_d, occ, nears, fars, *, jitter, **kw):
        return tuple(march(o, d, occ, nn, ff, jitter=j, **kw)
                     for o, d, nn, ff, j in zip(rays_o, rays_d, nears, fars, jitter))

    return march_rays_pair
