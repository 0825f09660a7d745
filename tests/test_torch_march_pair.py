"""The march of both renders of a ray pair in one call, and the plain
version of the march kernel's pre-pass, on the CPU.

The training step marches the event pair's two renders as one batch
(one launch of the march kernel on the card).  The plain march gives each
ray what a march of its render alone gives, bit for bit; the step's
renders equal two separate march renders.  `march_aux_reference` (the
superblock mask and the DDA exit table the kernel keeps in shared memory)
is held to its definition on the packed bitfield.
"""

import numpy as np
import pytest
import torch

from torch_march_parity import unpack_bitfield
from torch_parity import unit_dirs

from enerf_torch.models import field as tfield
from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
from enerf_torch.render import march as tmarch, occupancy as tocc
from enerf_torch.train import step as tstep


def ray_pair(count, seed, bound=1.0):
    """Two renders' rays from a shell around the box, some axis-parallel
    (0 * inf at a cell face) and some missing it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        o = unit_dirs(rng, count) * np.float32(2.5 * bound)
        d = rng.uniform(-0.5, 0.5, (count, 3)).astype(np.float32) - o / np.float32(2.5 * bound)
        d[:6, 1:] = 0.0
        d[-6:] = -d[-6:]  # pointing away: misses
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        out.append((torch.from_numpy(o), torch.from_numpy(d.astype(np.float32)),
                    torch.from_numpy(rng.uniform(0, 1, count).astype(np.float32))))
    return out


def bitfield(cascades, radius=0.6, seed=0):
    """A ball in cascade 0 and random cells in the others (packed)."""
    bf = tocc.ball_bitfield(radius=radius, cascades=cascades)
    rng = np.random.default_rng(seed)
    for c in range(1, cascades):
        bf[c] = torch.from_numpy(rng.uniform(size=bf.shape[1]) < 0.02)
    return tocc.pack_bitfield(bf), bf


def bits_of(x):
    return x.contiguous().view(torch.uint8)


@pytest.mark.parametrize("dt_gamma,max_steps,bound", [(0.0, 1024, 1.0), (1.0 / 256, 1024, 1.0),
                                                      (0.0, 256, 3.0)])
def test_pair_march_equals_two_marches(dt_gamma, max_steps, bound):
    """march_rays_pair against march_rays of each render (ts, dts, valid),
    and the plain march of the concatenation against each render's (ts,
    dts, valid, t_end): bit for bit."""
    cascades = tocc.num_cascades(bound)
    packed, _ = bitfield(cascades)
    pair = ray_pair(257, 1, bound)
    aabb = aabb_tensor(bound, "cpu")
    nf = [near_far_from_aabb(o, d, aabb, 0.2) for o, d, _ in pair]
    kw = dict(num_samples=29, max_steps=max_steps, cascades=cascades, bound=bound,
              dt_gamma=dt_gamma)
    got = tmarch.march_rays_pair(tuple(o for o, _, _ in pair), tuple(d for _, d, _ in pair),
                                 packed, *zip(*nf), jitter=tuple(j for _, _, j in pair),
                                 perturb=True, **kw)
    valid = 0
    for (o, d, j), (nears, fars), out in zip(pair, nf, got):
        ref = tmarch.march_rays(o, d, packed, nears, fars, jitter=j, perturb=True, **kw)
        valid += int(ref[2].sum())
        for a, b in zip(out, ref):
            assert torch.equal(bits_of(a), bits_of(b))
    assert valid > 300
    # t_end too, through the plain march itself
    t0 = [nears + (2.0 * tmarch.SQRT3 / max_steps) * j for (_, _, j), (nears, _) in zip(pair, nf)]
    both = tmarch._march(*(torch.cat(x) for x in zip(*[(o, d) for o, d, _ in pair])), packed,
                         *(torch.cat(x) for x in zip(*nf)), torch.cat(t0), **kw)
    n = pair[0][0].shape[0]
    for i, ((o, d, _), (nears, fars)) in enumerate(zip(pair, nf)):
        one = tmarch._march(o, d, packed, nears, fars, t0[i], **kw)
        rows = slice(i * n, (i + 1) * n)
        for a, b in zip(both, one):
            assert torch.equal(bits_of(a[rows]), bits_of(b))


@pytest.mark.parametrize("dt_gamma", [0.0, 1.0 / 256])
def test_step_pair_render_equals_two_march_renders(dt_gamma):
    """The step's pair on the march (one march of both renders) against two
    render_rays_march calls: images, depths and weights bit for bit."""
    st = tfield.FieldStatic(bound=1.0, out_dim_color=1, num_levels=2, log2_hashmap_size=10,
                            encoding="blockgrid", use_fused_head=True)
    params = tfield.init_field_params(st, seed=0)
    ss = tstep.StepStatics(field_static=st, min_near=0.2, density_scale=1.0, C_thres=0.2,
                           event_only=True, use_luma=False, linlog=True, out_dim_color=1,
                           use_march=True, march_samples=24, max_steps=1024, dt_gamma=dt_gamma,
                           compact_frac=0.5)
    packed, _ = bitfield(1)
    pair = ray_pair(65, 2)
    batch = {f"rays_evs_{k}{i}": x for i, (o, d, _) in ((1, pair[0]), (2, pair[1]))
             for k, x in (("o", o), ("d", d))}
    noise = {"jitter1": pair[0][2], "jitter2": pair[1][2]}
    bg = torch.full((65, 1), 0.25)
    before = tmarch.march_rays.host_syncs
    outs = tstep._render_pair(params, ss, batch, "evs", bg, noise, "", packed)
    pair_syncs = tmarch.march_rays.host_syncs - before
    before = tmarch.march_rays.host_syncs
    for (o, d, j), out in zip(pair, outs):
        ref = tmarch.render_rays_march(
            params, st, packed, o, d, num_samples=24, max_steps=1024, bg_color=bg, perturb=True,
            jitter=j, min_near=0.2, dt_gamma=dt_gamma, compact_frac=0.5)
        for k in ("image", "depth", "weights_sum"):
            assert torch.equal(out[k], ref[k]), k
    # one march: its skip loops' syncs are those of the longer render's, not both
    assert 0 < pair_syncs < tmarch.march_rays.host_syncs - before


@pytest.mark.parametrize("cascades,bound", [(1, 1.0), (2, 2.0), (3, 3.0), (1, 0.5)])
def test_march_aux_reference_matches_definition(cascades, bound):
    """The pre-pass's plain version: the mask word of each 32 superblocks
    against the bool bitfield's superblocks, and the exit table against
    the DDA exit's cell part evaluated in float32 step by step (1 / (H - 1)
    as the float32 reciprocal, the card's scalar divide), at every
    (level, sign, cell)."""
    packed, bf = bitfield(cascades, seed=cascades)
    assert torch.equal(unpack_bitfield(packed), bf)
    aux = tmarch.march_aux_reference(packed, cascades, bound)
    HS = tocc.GRID_SIZE // tocc.SUPER
    assert aux.shape == (cascades * (HS ** 3 // 32 + 3 * tmarch.EXIT_ROW),)
    mask = aux[:cascades * HS ** 3 // 32].numpy().view(np.uint32)
    sb = bf.reshape(cascades, HS, 4, HS, 4, HS, 4).any(6).any(4).any(2).reshape(-1).numpy()
    bit = (mask[np.arange(sb.size) // 32] >> (np.arange(sb.size) % 32).astype(np.uint32)) & 1
    np.testing.assert_array_equal(bit.astype(bool), sb)
    assert 0 < sb.sum() < sb.size
    table = aux[cascades * HS ** 3 // 32:].numpy().view(np.float32).reshape(cascades, 3, -1)
    f = np.float32
    inv_hm1 = f(1.0) / f(tocc.GRID_SIZE - 1)
    for lvl in range(cascades):
        mip_bound = min(f(2.0 ** lvl), f(bound))
        for s, sgn in enumerate((-1.0, 0.0, 1.0)):
            for j in range(tmarch.EXIT_ROW):
                block = f(1.0) if j < tocc.GRID_SIZE else f(tocc.SUPER)
                c = f(j if j < tocc.GRID_SIZE else j - tocc.GRID_SIZE)
                x = (c * block + f(0.5) * block + f(sgn) * (f(0.5) * block)) * inv_hm1
                x = (x * f(2.0) - f(1.0)) * mip_bound
                assert table[lvl, s, j].view(np.uint32) == f(x).view(np.uint32), (lvl, s, j)
