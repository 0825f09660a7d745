"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so on a machine without it they run with the JAX suite's conftest
left out:

    python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -q
"""

import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch.ops import fused_mlp, group_gather, hashgrid, scatter_accum
from enerf_torch.ops.blockgrid import BlockGridMeta
from enerf_torch.utils import profiling


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_twin_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    B = 70_000  # not a multiple of the 128-thread block

    def rnd(*shape, scale=1.0):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1).mul(scale).to(dt)

    args = (rnd(B, 32), rnd(B, 16), rnd(32, 64, scale=0.18), rnd(64, 16, scale=0.125),
            rnd(31, 64, scale=0.18), rnd(64, 64, scale=0.125), rnd(64, 1, scale=0.125))
    before = fused_mlp.fused_field_head.launches
    s_k, c_k = fused_mlp.fused_field_head(*args)
    torch.cuda.synchronize()
    assert fused_mlp.fused_field_head.launches == before + 1
    s_p, c_p = fused_mlp.head_reference(*args)
    if dt == torch.float32:
        # same f32 math, other summation order
        torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(c_k, c_p, rtol=1e-4, atol=1e-6)
    else:
        # bf16 rounding flips from the summation order (see the bf16 test)
        torch.testing.assert_close(s_k, s_p, rtol=3e-2, atol=1e-6)
        torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-2)


def _head_args(B, C, D, dtype, seed=0, E=32):
    """K1's operands on the card (G 15, hidden 64; the main path's E is 32)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1).mul(scale).to(dtype)

    return [rnd(B, E), rnd(B, D), rnd(E, 64, scale=0.18), rnd(64, 16, scale=0.125),
            rnd(D + 15, 64, scale=0.18), rnd(64, 64, scale=0.125), rnd(64, C, scale=0.125)]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [0, 1, 15, 70_000, 131_072])
@pytest.mark.parametrize("C", [1, 3])
def test_bf16_head_ragged_batches_on_card(B, C):
    """The tensor-core kernel masks a batch that is not a multiple of its
    16-sample tiles (or of a block's tiles); B = 0 launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    args = _head_args(B, C, 16, torch.bfloat16, seed=B + C)
    before = fused_mlp.fused_field_head.launches
    s_k, c_k = fused_mlp.fused_field_head(*args)
    torch.cuda.synchronize()
    assert fused_mlp.fused_field_head.launches == before + (B > 0)
    assert s_k.shape == (B,) and c_k.shape == (B, C)
    s_p, c_p = fused_mlp.head_reference(*args)
    torch.testing.assert_close(s_k, s_p, rtol=3e-2, atol=1e-6)
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("E", [32, 48])
def test_bf16_head_padded_widths_and_infinite_sigma_on_card(E):
    """D = 9 (SH degree 3) is zero-padded to 16 and E = 48 to 64 by the
    wrapper; an infinite sigma_raw must not reach the colour net (its column
    is zeroed before the geo features become an operand)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    args = _head_args(1000, 3, 9, torch.bfloat16, seed=5, E=E)
    args[3] = args[3].clone()
    args[3][:, 0] = 3e38
    s_k, c_k = fused_mlp.fused_field_head(*args)
    torch.cuda.synchronize()
    s_p, c_p = fused_mlp.head_reference(*args)
    assert torch.isinf(s_k).any() and torch.isinf(s_p).any()
    assert torch.isfinite(c_k).all()
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-2)


def _table_grad_on_card(pairs, meta):
    """K2 through its entry point on the card against the float64 plain
    version: atomics sum in any order, so per cell within 1e-5 of the sum
    of the addends' magnitudes (plus 1e-7), and exactly zero where no pair
    adds.  Returns (K2's gradient, the bound)."""
    before = scatter_accum.block_table_grad.launches
    got = scatter_accum.block_table_grad(*pairs, meta.total_rows, meta)
    torch.cuda.synchronize()
    assert scatter_accum.block_table_grad.launches == before + 1
    rid, lo, frac, gg = pairs
    ref64 = scatter_accum.block_table_grad_reference(*pairs, meta.total_rows, meta,
                                                     dtype=torch.float64)
    mag = scatter_accum.block_table_grad_reference(rid, lo, frac, gg.abs(), meta.total_rows,
                                                   meta, dtype=torch.float64)
    bound = 1e-5 * mag + 1e-7
    assert ((got.double() - ref64).abs() <= bound).all()
    assert (got[mag == 0] == 0).all()  # cells with no addend are written as exact zeros
    return got, bound


@pytest.mark.gpu
@pytest.mark.parametrize("block", [4, 3])
def test_table_grad_kernel_matches_twin_on_card(block):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(1)
    meta = BlockGridMeta(num_levels=16, level_dim=2, block=block)
    B = 70_000  # samples; x 16 levels, not a multiple of a chunk or a pre-pass block
    x = torch.rand(B, 3, device="cuda", generator=g)
    g_out = torch.randn(B, 32, device="cuda", generator=g)
    pairs = scatter_accum.pair_inputs(x, g_out, meta)
    _, bound = _table_grad_on_card(pairs, meta)
    ref64 = scatter_accum.block_table_grad_reference(*pairs, meta.total_rows, meta,
                                                     dtype=torch.float64)
    twin = scatter_accum.block_table_grad_reference(*pairs, meta.total_rows, meta)
    assert ((twin.double() - ref64).abs() <= bound).all()
    # the card's pre-pass builds the plain plan
    plan = scatter_accum.table_grad_plan(pairs[0], pairs[3], meta.total_rows,
                                         scatter_accum.tile_rows_of(meta))
    got = scatter_accum.device_plan(*pairs, meta.total_rows, meta)
    for k, v in got.items():
        assert torch.equal(v, getattr(plan, k)), k


def _pairs_on_rows(rows, meta, gen, live=True):
    """K2's inputs with the given global rows, random cell offsets and
    fractions; g ~ N(0, 1), or all zero (out-of-box samples)."""
    P = rows.shape[0]
    lo = torch.randint(0, meta.block, (P, 3), device="cuda", generator=gen, dtype=torch.int32)
    frac = torch.rand(P, 3, device="cuda", generator=gen)
    g = torch.randn(P, 2, device="cuda", generator=gen) * float(live)
    return rows.to(torch.int32), lo, frac, g


@pytest.mark.gpu
@pytest.mark.parametrize("block", [4, 3])
@pytest.mark.parametrize("case", ["one_row", "more_chunks_than_blocks", "zero_pairs",
                                  "all_out_of_box", "last_rows"])
def test_table_grad_kernel_edge_cases_on_card(case, block):
    """What the tile design can get wrong: one shared tile of many chunks,
    a work list longer than the persistent grid, no pair, no live pair,
    the ragged last tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    meta = BlockGridMeta(num_levels=16, level_dim=2, block=block)
    T = meta.total_rows
    if case == "one_row":  # ~25 chunks of one tile, every add on one row
        pairs = _pairs_on_rows(torch.full((100_000,), 300, device="cuda"), meta, gen)
    elif case == "more_chunks_than_blocks":  # >= 1 chunk a tile: ~1,000 chunks, ~2 blocks an SM
        x = torch.rand(70_000, 3, device="cuda", generator=gen)
        g_out = torch.randn(70_000, 32, device="cuda", generator=gen)
        pairs = scatter_accum.pair_inputs(x, g_out, meta)
    elif case == "zero_pairs":
        pairs = _pairs_on_rows(torch.zeros(0, device="cuda"), meta, gen)
    elif case == "all_out_of_box":
        x = torch.rand(5_000, 3, device="cuda", generator=gen)
        g_out = torch.randn(5_000, 32, device="cuda", generator=gen)
        oob = torch.ones(5_000, dtype=torch.bool, device="cuda")
        pairs = scatter_accum.pair_inputs(x, g_out, meta, oob)
    else:  # the last rows: the table's last tile is shorter than the others
        assert T % scatter_accum.tile_rows_of(meta)
        rows = torch.randint(T - 40, T, (50_000,), device="cuda", generator=gen)
        pairs = _pairs_on_rows(rows, meta, gen)
    got, _ = _table_grad_on_card(pairs, meta)
    if case in ("zero_pairs", "all_out_of_box"):
        assert torch.equal(got, torch.zeros_like(got))
    else:
        assert got.abs().max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,groups,windows", [(1024, 128, 5000, 4), (97824, 250, 70_001, 8),
                                                   (64, 1, 33, 16), (80, 3, 1, 1),
                                                   # more groups than the persistent grid's
                                                   # blocks x stages; the largest ring
                                                   (2048, 64, 200_003, 4),
                                                   (97824, 250, 70_001, 16),
                                                   # 16 slices of the walk, spans of 2 chunks
                                                   (32768, 1000, 5000, 8)])
def test_group_gather_kernel_matches_twin_on_card(rows, d, groups, windows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(2)
    table = torch.randn(rows, d, device="cuda", generator=g)
    gidx = torch.randint(0, rows // 8, (groups,), device="cuda", generator=g,
                         dtype=torch.int32)
    before = group_gather.group_gather.launches
    got = group_gather.group_gather(gidx, table, windows)
    torch.cuda.synchronize()
    assert group_gather.group_gather.launches == before + 1
    # a copy: bit-exact
    assert torch.equal(got, group_gather.group_gather_reference(gidx, table))


def _march_case(N, bound, max_steps, grid="ball", seed=3):
    """M1's inputs on the card: rays from a shell (a few parallel to an
    axis, so 0 * inf meets a cell face), some missing the box; the packed
    bitfield of a ball (and 2% of the cells of each outer cascade), of a
    full grid or of an empty one."""
    from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb
    from enerf_torch.render import march as M
    from enerf_torch.render.occupancy import ball_bitfield, num_cascades, pack_bitfield
    g = torch.Generator(device="cuda").manual_seed(seed)
    cas = num_cascades(bound)
    o = torch.randn(N, 3, device="cuda", generator=g)
    o = 2.5 * bound * o / o.norm(dim=-1, keepdim=True)
    d = torch.rand(N, 3, device="cuda", generator=g) - 0.5 - o / (2.5 * bound)
    d[:20, 1:] = 0.0  # axis-parallel rays
    d = d / d.norm(dim=-1, keepdim=True)
    nears, fars = near_far_from_aabb(o, d, aabb_tensor(bound, "cuda"), 0.2)
    t0 = nears + (2.0 * M.SQRT3 / max_steps) * torch.rand(N, device="cuda", generator=g)
    bf = ball_bitfield(radius=0.6, cascades=cas, device="cuda")
    bf[1:] = torch.rand(bf[1:].shape, device="cuda", generator=g) < 0.02
    if grid != "ball":
        bf[:] = grid == "full"
    return (o, d, pack_bitfield(bf), nears, fars, t0), cas


def _bit_equal(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("dt_gamma,max_steps,bound,grid", [
    (0.0, 1024, 1.0, "ball"), (1.0 / 256, 1024, 1.0, "ball"), (0.0, 256, 2.0, "ball"),
    # bound 3 (30 published configs): 3 cascades, the top level's mip_bound clamped to 3
    (0.0, 1024, 3.0, "ball"), (1.0 / 256, 1024, 3.0, "ball"),
    (0.0, 1024, 1.0, "full"), (0.0, 1024, 1.0, "empty"), (0.0, 1024, 3.0, "full")])
def test_march_kernel_matches_twin_on_card(dt_gamma, max_steps, bound, grid):
    """M1 against `_march` on rays from a shell, some missing the box:
    ts, dts, valid and t_end bit-equal on every ray."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (M1 has no CPU mode)")
    from enerf_torch.render import march as M
    (o, d, bits, nears, fars, t0), cas = _march_case(3001, bound, max_steps, grid)
    kw = dict(num_samples=37, max_steps=max_steps, cascades=cas, bound=bound, dt_gamma=dt_gamma)
    before = M.march_rays.launches
    got = M.launch_kernel(o, d, bits, nears, fars, t0, **kw)
    torch.cuda.synchronize()
    assert M.march_rays.launches == before + 1
    ref = M._march(o, d, bits, nears, fars, t0, **kw)
    assert int(ref[2].sum()) == 0 if grid == "empty" else int(ref[2].sum()) > 1000
    _bit_equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dt_gamma,bound", [(0.0, 1.0), (1.0 / 256, 3.0)])
def test_march_pair_in_one_launch_matches_two_launches(dt_gamma, bound):
    """The pair's rays marched in one launch (the training step's
    march_rays_pair) against a launch for each render: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (M1 has no CPU mode)")
    from enerf_torch.render import march as M
    (o1, d1, bits, n1, f1, _), cas = _march_case(2049, bound, 1024, seed=4)
    (o2, d2, _, n2, f2, _), _ = _march_case(2049, bound, 1024, seed=5)
    g = torch.Generator(device="cuda").manual_seed(6)
    j1, j2 = (torch.rand(2049, device="cuda", generator=g) for _ in range(2))
    kw = dict(num_samples=64, max_steps=1024, cascades=cas, bound=bound, dt_gamma=dt_gamma,
              perturb=True)
    before = M.march_rays.launches
    got = M.march_rays_pair((o1, o2), (d1, d2), bits, (n1, n2), (f1, f2), jitter=(j1, j2), **kw)
    assert M.march_rays.launches == before + 1
    for out, (o, d, n, f, j) in zip(got, ((o1, d1, n1, f1, j1), (o2, d2, n2, f2, j2))):
        _bit_equal(out, M.march_rays(o, d, bits, n, f, jitter=j, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("cascades,bound", [(1, 1.0), (3, 3.0)])
def test_march_prepass_matches_twin_on_card(cascades, bound):
    """M1's pre-pass (superblock mask, DDA exit table) against its plain
    version: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (M1's pre-pass has no CPU mode)")
    from enerf_torch.render import march as M
    (_, _, bits, _, _, _), cas = _march_case(64, bound, 1024)
    assert cas == cascades
    got = M.march_prepass(bits, cascades, bound)
    torch.cuda.synchronize()
    assert torch.equal(got, M.march_aux_reference(bits, cascades, bound))


@pytest.mark.gpu
def test_march_bit_arithmetic_exhaustive_on_card():
    """M1's mip level from the float's exponent equals ceil(log2f) +
    exp2f's correction on every non-negative float32 (NaN, inf and
    subnormals included) for 1-4 cascades; its product with 2^-l equals
    the division by 2^l on every float32 for l = 1-3; exp2f(l) = 2^l."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from enerf_torch.render import march as M
    assert M.mip_check() == {"level": 0, "division": 0, "exp2": 0}


# H1's grids: the published field grid (16 x 2 at 2^19, desired_resolution
# 4096 at bound 2), the background net's 2-D grid, a tiled grid (every
# level dense and wrapped) and the other channel counts, one with more
# levels than a block has warps
H1_GRIDS = {
    "published": dict(num_levels=16, level_dim=2, log2_hashmap_size=19, desired_resolution=4096),
    "background": dict(input_dim=2, num_levels=4, level_dim=2, log2_hashmap_size=19,
                       desired_resolution=2048),
    "tiled": dict(num_levels=8, level_dim=2, log2_hashmap_size=14, desired_resolution=512,
                  gridtype="tiled"),
    "c1": dict(num_levels=6, level_dim=1, log2_hashmap_size=12, desired_resolution=256),
    "c4_20_levels": dict(num_levels=20, level_dim=4, log2_hashmap_size=12,
                         desired_resolution=1024),
    "c8_2d": dict(input_dim=2, num_levels=3, level_dim=8, base_resolution=4,
                  log2_hashmap_size=10),
}


def _h1_case(meta, rays, steps, seed):
    """Positions as the renderer lays them out (the `steps` samples of a ray
    consecutive, on a segment through the unit box), 3% of them moved to
    [-0.1, 1.1]^D, some on the box's faces, 17 more at random (N not a
    multiple of a block's 32); a table U(-1, 1); an output gradient N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = meta.input_dim
    a, b = (torch.rand(rays, 1, D, device="cuda", generator=g) for _ in range(2))
    t = (torch.arange(steps, device="cuda") + 0.5) / steps
    x = torch.cat([(a + (b - a) * t[None, :, None]).reshape(-1, D),
                   torch.rand(17, D, device="cuda", generator=g)])
    moved = torch.rand(x.shape[0], device="cuda", generator=g) < 0.03
    x[moved] = x[moved] * 1.2 - 0.1
    x[:5, 0], x[5:10, D - 1] = 0.0, 1.0
    table = torch.rand(meta.total_entries, meta.level_dim, device="cuda", generator=g) * 2 - 1
    gout = torch.randn(x.shape[0], meta.output_dim, device="cuda", generator=g)
    return x.contiguous(), table, gout


def _h1_grad_bound(x, gout, meta):
    """The exact table gradient (float64 sums of the float32 addends w * g)
    and its bound.  H1.bwd adds the same float32 addends as the plain
    version, in an order its atomics and its merge of equal rows set; any
    order of k float32 sums lies within (k - 1) 2^-24 of the sum of the
    addends' magnitudes from the exact sum, so a row of k addends is held to
    k 2^-24 of that magnitude, and a row that no sample touches to 0."""
    idx, w, oob = hashgrid.hash_address(x, meta)
    C = meta.level_dim
    add = (w[..., None] * gout.reshape(x.shape[0], meta.num_levels, 1, C))  # float32 addends
    add = add.masked_fill(oob[:, None, None, None], 0.0).reshape(-1, C).double()
    rows = idx.reshape(-1).long()
    exact = torch.zeros(meta.total_entries, C, dtype=torch.float64, device=x.device)
    mag, count = torch.zeros_like(exact), torch.zeros_like(exact)
    exact.index_add_(0, rows, add)
    mag.index_add_(0, rows, add.abs())
    count.index_add_(0, rows, torch.ones_like(add))
    return exact, count * 2.0 ** -24 * mag


@pytest.mark.gpu
@pytest.mark.parametrize("grid", list(H1_GRIDS))
def test_hash_encode_kernel_matches_twin_on_card(grid):
    """H1.fwd is bit-equal to encode_from_address(*hash_address(...)) (the
    same float32 operations in the same order; zeros outside the box);
    H1.bwd's table gradient is within the atomics-order bound of the exact
    sum (_h1_grad_bound), as is the plain version's index_add_."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (H1 has no CPU mode)")
    meta = hashgrid.HashGridMeta(**H1_GRIDS[grid])
    x, table, gout = _h1_case(meta, 2048, 128, seed=len(grid))
    f0, b0 = hashgrid.hash_encode_kernel.launches, hashgrid.hash_table_grad_kernel.launches
    got = hashgrid.hash_encode_kernel(x, table, meta)
    torch.cuda.synchronize()
    plain = hashgrid.encode_from_address(*hashgrid.hash_address(x, meta), table)
    oob = ((x < 0) | (x > 1)).any(-1)
    assert oob.any() and (got[oob] == 0).all() and got.abs().max() > 0.1
    assert torch.equal(got, plain)
    grad = hashgrid.hash_table_grad_kernel(x, gout, meta)
    torch.cuda.synchronize()
    assert hashgrid.hash_encode_kernel.launches == f0 + 1
    assert hashgrid.hash_table_grad_kernel.launches == b0 + 1
    exact, bound = _h1_grad_bound(x, gout, meta)
    assert ((grad.double() - exact).abs() <= bound).all()
    assert (grad[bound == 0] == 0).all() and (bound > 0).sum() > 1000
    plain_grad = hashgrid.table_grad_from_address(*hashgrid.hash_address(x, meta), gout,
                                                  table.shape)
    assert ((plain_grad.double() - exact).abs() <= bound).all()


@pytest.mark.gpu
def test_hash_encode_on_card_raises_on_what_h1_does_not_take():
    """A CUDA tensor goes to H1 or raises: never to the plain path (the
    launch counts move only for what H1 runs, forward and VJP)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (H1 has no CPU mode)")
    meta = hashgrid.HashGridMeta(num_levels=4, level_dim=2, log2_hashmap_size=10)
    x, table, _ = _h1_case(meta, 8, 16, seed=3)
    wide = torch.zeros(meta.total_entries + 1, 2, device="cuda")
    counts = lambda: (hashgrid.hash_encode_kernel.launches,  # noqa: E731
                      hashgrid.hash_table_grad_kernel.launches)
    before = counts()
    bad = [(x.double(), table, TypeError), (x, table.half(), TypeError),
           (x.t().contiguous().t(), table, ValueError), (x[:, :2], table, ValueError),
           (x, table[:-8], ValueError), (x, wide[1:], ValueError),  # 8 bytes off: misaligned
           (x.cpu(), table, ValueError)]
    for xi, ti, err in bad:
        with pytest.raises(err):
            hashgrid.hash_encode(xi, ti, meta)
    with pytest.raises(ValueError):
        hashgrid.hash_encode(x, torch.zeros(meta.total_entries, 3, device="cuda"),
                             hashgrid.HashGridMeta(num_levels=4, level_dim=3,
                                                   log2_hashmap_size=10))
    assert counts() == before
    with pytest.raises(ValueError):
        hashgrid.hash_table_grad_kernel(x, torch.zeros(x.shape[0], 7, device="cuda"), meta)
    # the forward, then the VJP of a gradient autograd hands in expanded
    tp = table.clone().requires_grad_()
    hashgrid.hash_encode(x, tp, meta).sum().backward()
    assert counts() == (before[0] + 1, before[1] + 1)
    assert tp.grad.abs().sum() > 0


@pytest.mark.gpu
def test_hash_encode_in_a_captured_graph_replays_its_eager_step():
    """The encode and its VJP captured in a CUDA graph (as the training
    window captures them) launch H1 once each a replay; a replay's encoding
    is bit-equal to the eager one, its table gradient within the
    atomics-order bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (H1 has no CPU mode)")
    meta = hashgrid.HashGridMeta(**H1_GRIDS["published"])
    x, table, gout = _h1_case(meta, 512, 128, seed=11)
    table.requires_grad_()

    def step():
        out = hashgrid.hash_encode(x, table, meta)
        return out, torch.autograd.grad(out, table, gout)[0]

    eager_out, eager_grad = (v.detach().clone() for v in step())  # no graph kept
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    owners = (hashgrid.hash_encode_kernel, hashgrid.hash_table_grad_kernel)
    with profiling.recording(owners) as replay, torch.cuda.graph(graph):
        out, grad = step()
    assert replay.launches[owners[0]] == 1 and replay.launches[owners[1]] == 1
    for _ in range(2):
        profiling.replayed(replay)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager_out)
    exact, bound = _h1_grad_bound(x, gout, meta)
    for got in (grad, eager_grad):
        assert ((got.double() - exact).abs() <= bound).all()


def _state_copy(tr):
    st = tr.state
    return ({name: {k: v.detach().clone() for k, v in getattr(st, name).items()}
             for name in ("params", "ema_params", "exp_avg", "exp_avg_sq")},
            st.count.clone(), st.step, [g.get_state() for g in (tr.generator, tr.rank_generator)])


def _state_put(tr, copy):
    """Put a _state_copy back into the same tensors (a captured graph reads them)."""
    tensors, count, step, gens = copy
    st = tr.state
    with torch.no_grad():
        for name, d in tensors.items():
            for k, v in d.items():
                getattr(st, name)[k].copy_(v)
        st.count.copy_(count)
    st.step = step
    for g, s in zip((tr.generator, tr.rank_generator), gens):
        g.set_state(s)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,renders", [("events", 2), ("frames", 1)])
def test_a_captured_window_through_h1_matches_its_eager_window(tmp_path, mode, renders):
    """A training window on the hash grid (the published configs' renderer)
    captured and replayed against the same window run eagerly from the same
    state and draws: H1's forward and VJP launch once a render in the
    captured step; the window's loss within 1e-4 and each leaf within 2e-2
    of its update by norm (H1.bwd's atomics make two runs differ at the
    rounding level after the first step, and Adam steps small gradients
    either way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (H1 has no CPU mode)")
    from enerf_torch.config import build_config
    from enerf_torch.data import provider as tprov
    from enerf_torch.train.trainer import Trainer

    extra = () if mode == "events" else ("--events", "0", "--event_only", "0",
                                         "--num_rays", "64")
    cfg = build_config([
        "--mode", "synthetic", "--H", "24", "--W", "24", "--syn_frames", "8",
        "--events", "1", "--event_only", "1", "--out_dim_color", "1", "--C_thres", "0.2",
        "--bound", "1", "--num_levels", "4", "--num_steps", "16", "--batch_size_evs", "64",
        "--outdir", str(tmp_path), *extra])
    tr = Trainer(cfg, device="cuda", workspace=str(tmp_path / "ws"))
    train, _ = tprov.make_providers(cfg, device="cuda")
    chunk = tr._chunk(train, 3, tr.state.step)
    start = _state_copy(tr)
    runs = {}
    for graphed in (False, True):
        _state_put(tr, start)
        run = chunk if graphed else chunk.eager
        tr.occupancy, aux = run(tr.state, tr.occupancy, train, tr.generator, tr.rank_generator)
        torch.cuda.synchronize()
        runs[graphed] = float(aux["loss"]), {k: v.detach().clone()
                                            for k, v in tr.state.params.items()}
    assert chunk.per_replay.launches[hashgrid.hash_encode_kernel] == renders
    assert chunk.per_replay.launches[hashgrid.hash_table_grad_kernel] == renders
    (loss_e, p_e), (loss_g, p_g) = runs[False], runs[True]
    assert abs(loss_g - loss_e) <= 1e-4 * abs(loss_e)
    for k, pe in p_e.items():
        update = torch.linalg.vector_norm(pe - start[0]["params"][k])
        assert torch.linalg.vector_norm(p_g[k] - pe) <= 2e-2 * update, k
