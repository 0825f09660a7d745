"""The plan of kernel K2's pre-pass (scatter_accum.table_grad_plan): the
pairs sorted into tiles of rows, cut into chunks, each chunk owned or
shared.  Accumulating chunk by chunk along the plan, as the kernel does,
must give JAX's block_table_grad_reference on the same pairs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from torch_parity import n, t
from test_torch_scatter import ATOL, _inputs, _metas, _pairs_from_jax

from enerf_tpu.ops import scatter_accum as jsa
from enerf_torch.ops import scatter_accum as tsa
from enerf_torch.ops import blockgrid as tbg
from enerf_torch.ops.blockgrid import BlockGridMeta, _trilinear_weights


def _pairs_on_rows(rows, meta, seed, live=True):
    """Flat pair inputs on the given global rows: random cell offsets and
    fractions, g ~ N(0, 1) (or all zero)."""
    rng = np.random.default_rng(seed)
    P = rows.shape[0]
    lo = rng.integers(0, meta.block, (P, 3)).astype(np.int32)
    frac = rng.uniform(size=(P, 3)).astype(np.float32)
    g = rng.normal(size=(P, 2)).astype(np.float32) * float(live)
    return t(rows.astype(np.int32)), t(lo), t(frac), t(g)


def _case(name):
    """(pairs, meta, tile_rows, chunk_pairs) of a named case."""
    if name in ("blk4", "blk3"):  # JAX's addresses, 16 of 257 samples out of the box
        mj, mt = _metas(4 if name == "blk4" else 3)
        x, g = _inputs(257, mj.num_levels, seed=6, oob=16)
        return _pairs_from_jax(mj, x, g)[0], mt, 10, 64
    if name == "levels_16x2_blk4":  # 8,388-row levels, the default tiles and chunks
        mj, mt = _metas(4, levels=16, log2=19)
        x, g = _inputs(257, 16, seed=7, oob=3)
        return _pairs_from_jax(mj, x, g)[0], mt, tsa.tile_rows_of(mt), tsa.CHUNK_PAIRS
    if name == "levels_16x2_blk4_shared":  # the same, in chunks that share tiles
        mj, mt = _metas(4, levels=16, log2=19)
        x, g = _inputs(257, 16, seed=7, oob=3)
        return _pairs_from_jax(mj, x, g)[0], mt, tsa.tile_rows_of(mt), 16
    _, mt = _metas(4)
    T = mt.total_rows
    if name == "one_row":  # one shared tile of 8 chunks, every pair on row 7
        return _pairs_on_rows(np.full(500, 7), mt, 8), mt, 10, 64
    if name == "zero_pairs":
        return _pairs_on_rows(np.zeros(0), mt, 9), mt, 10, 64
    if name == "all_out_of_box":
        return _pairs_on_rows(np.arange(300) % T, mt, 10, live=False), mt, 10, 64
    assert name == "ragged_last_tile"  # T % 10 != 0: the last tile is short
    assert T % 10
    rows = np.random.default_rng(11).integers(T - 25, T, 400)
    return _pairs_on_rows(rows, mt, 12), mt, 10, 64


CASES = ["blk4", "blk3", "levels_16x2_blk4", "levels_16x2_blk4_shared", "one_row",
         "zero_pairs", "all_out_of_box", "ragged_last_tile"]


def _jax_reference(pairs, meta):
    """JAX's block_table_grad_reference of flat pairs (one 'level' of
    global rows, offset 0); its reshape cannot take zero pairs, whose
    gradient is all zero."""
    rid, lo, frac, g = (n(a) for a in pairs)
    if rid.shape[0] == 0:
        return np.zeros((meta.total_rows, 2 * meta.row_cells), np.float32)
    meta8 = np.concatenate([lo.astype(np.float32), g, frac], axis=-1)[None]
    return np.asarray(jsa.block_table_grad_reference(
        jnp.asarray(rid[None]), jnp.asarray(meta8), meta.total_rows, np.zeros(1, np.int32),
        halo=meta.halo, row_cells=meta.row_cells))


def _accumulate_by_plan(plan, pairs, meta):
    """K2's accumulation along the plan, chunk by chunk: a tile of zeros,
    each record's 16 products added at its row within the tile, then the
    tile written (owned) or added into rows zeroed first (shared).  The
    output starts as NaN, like the kernel's torch.empty: a row no chunk
    writes stays NaN."""
    rid, lo, frac, g = pairs
    T, RC, tr = meta.total_rows, meta.row_cells, plan.tile_rows
    W = _trilinear_weights(lo, frac, meta)
    rows = (g[:, :, None] * W[:, None, :]).reshape(-1, 2 * RC)
    out = torch.full((T, 2 * RC), float("nan"))
    for tile in plan.chunk_tile[plan.chunk_shared].unique().tolist():
        out[tile * tr:(tile + 1) * tr] = 0.0
    for tile, begin, end, shared in zip(plan.chunk_tile.tolist(), plan.chunk_begin.tolist(),
                                        plan.chunk_end.tolist(), plan.chunk_shared.tolist()):
        idx = plan.order[begin:end]
        local = rid[idx].long() - tile * tr
        assert ((local >= 0) & (local < tr)).all(), "a record outside its tile"
        acc = torch.zeros(tr, 2 * RC).index_add_(0, local, rows[idx])
        span = out[tile * tr:(tile + 1) * tr]
        if shared:
            span += acc[:span.shape[0]]
        else:
            span.copy_(acc[:span.shape[0]])
    return out


@pytest.mark.parametrize("name", CASES)
def test_plan_holds_every_live_pair_once(name):
    pairs, meta, tile_rows, chunk_pairs = _case(name)
    rid, _, _, g = pairs
    T = meta.total_rows
    plan = tsa.table_grad_plan(rid, g, T, tile_rows, chunk_pairs)
    tiles = -(-T // tile_rows)
    assert plan.tile_rows == tile_rows and plan.counts.shape == (tiles,)
    # every pair with a non-zero g is in exactly one chunk, every other in none
    listed = torch.cat([plan.order[b:e] for b, e in zip(plan.chunk_begin.tolist(),
                                                        plan.chunk_end.tolist())])
    live = torch.nonzero((g != 0).any(dim=1)).squeeze(1)
    assert torch.equal(torch.sort(listed).values, live)
    # each record lies in its tile's rows, tiles in order
    assert torch.equal(plan.offsets, torch.cat([torch.zeros(1, dtype=torch.int64),
                                                torch.cumsum(plan.counts, 0)]))
    rec_tile = torch.repeat_interleave(torch.arange(tiles), plan.counts)
    r = rid[plan.order].long()
    assert ((r >= rec_tile * tile_rows) & (r < (rec_tile + 1) * tile_rows)).all()
    # each tile's chunks cut its segment in order, at most chunk_pairs each;
    # a tile of several chunks is shared, a tile of one (empty or not) owned
    for tile in range(tiles):
        mine = torch.nonzero(plan.chunk_tile == tile).squeeze(1)
        assert mine.numel() >= 1
        bounds = torch.cat([plan.chunk_begin[mine], plan.chunk_end[mine][-1:]])
        assert int(bounds[0]) == int(plan.offsets[tile])
        assert int(bounds[-1]) == int(plan.offsets[tile + 1])
        assert torch.equal(plan.chunk_end[mine][:-1], plan.chunk_begin[mine][1:])
        sizes = plan.chunk_end[mine] - plan.chunk_begin[mine]
        assert (sizes <= chunk_pairs).all() and (sizes[:-1] == chunk_pairs).all()
        assert (plan.chunk_shared[mine] == (mine.numel() > 1)).all()
    if name == "one_row":
        assert int(plan.chunk_shared.sum()) == 8


@pytest.mark.parametrize("name", CASES)
def test_accumulation_by_plan_matches_jax_reference(name):
    pairs, meta, tile_rows, chunk_pairs = _case(name)
    plan = tsa.table_grad_plan(pairs[0], pairs[3], meta.total_rows, tile_rows, chunk_pairs)
    got = _accumulate_by_plan(plan, pairs, meta)
    assert not torch.isnan(got).any(), "a row that no chunk wrote"
    ref = _jax_reference(pairs, meta)
    np.testing.assert_allclose(n(got), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(n(got), n(tsa.block_table_grad_reference(
        *pairs, meta.total_rows, meta)), rtol=0, atol=ATOL)
    if name in ("zero_pairs", "all_out_of_box"):
        assert not got.any()
    else:
        assert got.abs().max() > 0.1
    if name.endswith("shared") or name == "one_row":
        assert plan.chunk_shared.any()


def test_tile_rows_fit_the_tile_bytes():
    for block, rows in ((4, 98), (3, 192), (1, 1536)):
        meta = BlockGridMeta(num_levels=16, level_dim=2, block=block)
        assert tsa.tile_rows_of(meta) == rows  # 2 * row_cells f32 each, even
        assert rows * 8 * meta.row_cells <= tsa.TILE_BYTES
    with pytest.raises(ValueError):  # rows of 74 KB: not two to a tile
        tsa.tile_rows_of(BlockGridMeta(num_levels=2, level_dim=2, block=20))


def test_prepass_refuses_cpu_tensors():
    pairs, meta, _, _ = _case("one_row")
    with pytest.raises(ValueError, match="CUDA"):
        tsa.launch_prepass(*pairs, meta.total_rows, meta)
    with pytest.raises(ValueError, match="CUDA"):
        tsa.device_plan(*pairs, meta.total_rows, meta)


@pytest.mark.parametrize("block", [4, 3])
def test_pair_inputs_list_pairs_level_by_level(block):
    """pair_inputs' level-major addresses are the sample-major ones of
    block_address, transposed, bit for bit; out-of-box samples get g = 0."""
    _, mt = _metas(block)
    x, g = _inputs(257, mt.num_levels, seed=13, oob=9)
    xc, g_out = t(np.clip(x, 0.0, 1.0)), t(g)
    oob = torch.zeros(257, dtype=torch.bool)
    oob[:9] = True
    rid, lo, frac, gg = tsa.pair_inputs(xc, g_out, mt, oob)
    rid_s, lo_s, frac_s = tbg.block_address(xc, mt)
    rid_s = rid_s + torch.as_tensor(mt.offsets[:-1])[None, :]
    L = mt.num_levels
    assert torch.equal(rid, rid_s.t().reshape(-1).to(torch.int32))
    assert torch.equal(lo, lo_s.transpose(0, 1).reshape(-1, 3).to(torch.int32))
    assert torch.equal(frac, frac_s.transpose(0, 1).reshape(-1, 3))
    want = g_out.reshape(257, L, 2).masked_fill(oob[:, None, None], 0.0)
    assert torch.equal(gg, want.transpose(0, 1).reshape(-1, 2))


def test_bench_table_grad_runs_on_cpu(tmp_path):
    """The table backward benchmark's control flow, with K2's plain version
    (the CPU), on uniform samples and on a saved set of samples."""
    from enerf_torch.tools import bench_table_grad
    x, g = _inputs(40, 16, seed=14, oob=0)
    oob = torch.zeros(40, dtype=torch.bool)
    oob[:30] = True
    path = tmp_path / "step1.pt"
    torch.save([dict(x=t(x), g_out=t(g), oob=oob)], path)
    res = bench_table_grad.run(24, str(path), torch.device("cpu"))
    assert [r["name"] for r in res] == ["uniform blk4", "uniform blk3", "K2 path render 1 blk4",
                                        "K2 path render 1 blk4, no live pair"]
    assert [(r["pairs"], r["live"]) for r in res] == [(384, 384), (384, 384), (640, 160),
                                                      (640, 0)]
    assert all(r[k] > 0 for r in res for k in ("pair_inputs_ms", "k2_ms", "both_ms"))
