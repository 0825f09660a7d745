"""Kernel E1's plan on the CPU (enerf_torch/data/native_events.py,
csrc/event_chains.cu): the digit plan, and a numpy emulation of the
kernel's arithmetic (tile ranks, the look-back's prefix over tiles, runs
staged in digit order, the group pass's (count, last start) scan, the
fix-up) against the plain version, sort_plain.  The card runs the kernel
itself, and checks the workspace the .cu lays out, in
tests/test_torch_native_events.py (marker `gpu`)."""

import numpy as np
import pytest

from enerf_torch.data import native_events as tnat

KERNEL_TILE = 4096  # keys a tile of the kernel's passes ranks (event_chains.cu: TILE)


@pytest.mark.parametrize("K, bits", [(1, 0), (2, 1), (255, 8), (256, 8), (257, 9),
                                     (1280 * 720 * 19, 25), (1 << 30, 30), (1 << 12, 12),
                                     (4160, 13), ((1 << 13) + 1, 14), (1 << 15, 15),
                                     ((1 << 22) + 1, 23)])
def test_digit_plan_covers_the_key_bits_in_the_fewest_passes(K, bits):
    """b = ceil(log2 K) bits in the fewest passes of at most 11 bits, as
    even as they go, the wider digits first.  The widths are 8-11 bits
    where the fewest passes allow it (b of 8-11, 16-22, 24-30); 12-15 bits
    take two digits of 6-8 ([6, 6] up to [8, 7]; the main path's scene,
    ~4,160 keys, [7, 6]), 23 bits [8, 8, 7], and fewer than 8 bits one
    pass of its bits."""
    plan = tnat.digit_plan(K)
    assert (K - 1).bit_length() == bits  # b = ceil(log2 K)
    assert sum(plan) == bits
    assert len(plan) == -(-bits // tnat.MAX_DIGIT)  # the fewest passes of <= 11 bits
    assert all(w <= tnat.MAX_DIGIT for w in plan)
    assert max(plan, default=0) - min(plan, default=0) <= 1
    assert plan == sorted(plan, reverse=True)
    if bits < 8:
        assert plan == ([bits] if bits else [])
    elif bits <= 11 or 16 <= bits <= 22 or bits >= 24:
        assert min(plan) >= 8
    if K == 4160:
        assert plan == [7, 6]


# ------------------------------------------------------ the kernel, emulated


def keys_of(xs, ys, fids, W):
    """The composite key the histogram and the first pass compute, and K."""
    pix = (np.asarray(ys, np.float32).astype(np.int64) * W
           + np.asarray(xs, np.float32).astype(np.int64))
    f = np.asarray(fids, np.int64)
    P = pix.max() - pix.min() + 1
    return (f - f.min()) * P + (pix - pix.min()), (f.max() - f.min() + 1) * P


def emulate_pass(keys, vals, shift, bits, tile_size):
    """One LSD pass as the kernel computes it: each tile's stable rank of
    its keys by the digit, its buckets' offsets (the digit's start plus the
    counts of the tiles before it: the look-back's sum), its keys staged in
    digit order and stored as runs."""
    n, bins = len(keys), 1 << bits
    dig = (keys >> shift) & (bins - 1)
    tile = np.arange(n) // tile_size
    hist = np.bincount(dig, minlength=bins)
    start = np.cumsum(hist) - hist                       # the digit's bucket starts
    count = np.zeros((tile[-1] + 1, bins), np.int64)     # each tile's counts
    np.add.at(count, (tile, dig), 1)
    before = np.cumsum(count, 0) - count                 # the look-back's prefix
    tstart = np.cumsum(count, 1) - count                 # the tile's bucket starts
    by = np.lexsort((np.arange(n), dig, tile))           # (tile, digit, index)
    first = np.r_[True, (tile[by][1:] != tile[by][:-1]) | (dig[by][1:] != dig[by][:-1])]
    rank = np.empty(n, np.int64)                         # stable rank in (tile, digit)
    rank[by] = np.arange(n) - np.maximum.accumulate(np.where(first, np.arange(n), 0))
    local = tstart[tile, dig] + rank                     # the staged place in the tile
    dst = (start[dig] + before[tile, dig] - tstart[tile, dig]) + local
    assert np.all(local < tile_size) and np.array_equal(np.sort(dst), np.arange(n))
    out_k, out_v = np.empty_like(keys), np.empty_like(vals)
    out_k[dst], out_v[dst] = keys, vals
    return out_k, out_v


def emulate_groups(keys, tile_size):
    """The group pass: flags where the key changes, a scan of (count, last
    start + 1) in tiles with each tile's prefix from the ones before it;
    the group ids, and each group's count where the group ends."""
    n = len(keys)
    flag = np.r_[True, keys[1:] != keys[:-1]]
    last = np.where(flag, np.arange(n) + 1, 0)
    tile = np.arange(n) // tile_size
    tiles = tile[-1] + 1
    agg_n = np.bincount(tile, flag, tiles).astype(np.int64)
    agg_last = np.zeros(tiles, np.int64)
    np.maximum.at(agg_last, tile, last)
    pre_n = np.cumsum(agg_n) - agg_n
    pre_last = np.r_[0, np.maximum.accumulate(agg_last)[:-1]]
    run_n = np.zeros(n, np.int64)
    run_last = np.zeros(n, np.int64)
    for t in range(tiles):
        s = slice(t * tile_size, (t + 1) * tile_size)
        run_n[s] = pre_n[t] + np.cumsum(flag[s])
        run_last[s] = np.maximum(pre_last[t], np.maximum.accumulate(last[s]))
    gid = run_n - 1
    end = np.r_[keys[1:] != keys[:-1], True]
    counts = np.zeros(gid[-1] + 1, np.int64)
    counts[gid[end]] = np.flatnonzero(end) + 2 - run_last[end]
    return gid, counts


def emulate_e1(xs, ys, ts, fids, W, tile_size):
    keys, K = keys_of(xs, ys, fids, W)
    vals = np.arange(len(keys), dtype=np.int64)
    shift = 0
    for w in tnat.digit_plan(K):
        keys, vals = emulate_pass(keys, vals, shift, w, tile_size)
        shift += w
    gid, counts = emulate_groups(keys, tile_size)
    if np.any(np.asarray(ts)[1:] < np.asarray(ts)[:-1]):  # the fix-up: (t, index) a group
        starts = np.cumsum(counts) - counts
        for a, c in zip(starts, counts):
            seg = vals[a:a + c]
            vals[a:a + c] = seg[np.lexsort((seg, ts[seg]))]
    return vals, gid, counts


def make(case, seed=0):
    """(xs, ys, ts, fids, W) of one case, made from a seed."""
    rng = np.random.default_rng(seed)
    n, W, H = 30_000, 300, 200
    xs = rng.integers(0, W - 1, n) + rng.choice([0.0, 0.5, 0.99999999], n)
    ys = rng.integers(0, H - 1, n) + rng.choice([0.0, 0.999999999], n)
    ts = np.sort(rng.uniform(0, 1e6, n))
    fids = np.minimum((ts / 1e6 * 5).astype(np.int64), 4)
    if case == "negative":  # pixels below 0, as a rectify map can give
        xs, ys = xs - 3.5, ys - 1.5
    if case == "hot_pixel":  # 70,000 events at one pixel: one bucket over many tiles
        m = 70_000
        xs, ys = np.r_[xs, np.full(m, 17.0)], np.r_[ys, np.full(m, 11.0)]
        ts = np.sort(np.r_[ts, np.round(rng.uniform(0, 1e6, m) / 1e3) * 1e3])
        fids = np.zeros(len(ts), np.int64)
    if case == "unsorted":
        p = rng.permutation(n)
        ts, fids = np.round(ts[p] / 100) * 100, rng.integers(0, 5, n)
        hot = rng.random(n) < 0.2
        xs[hot], ys[hot] = 40.0, 60.0
    return xs, ys, ts, fids, W


@pytest.mark.parametrize("case", ["sorted", "negative", "hot_pixel", "unsorted"])
def test_emulated_radix_passes_give_the_plain_order(case):
    _emulated_against_plain(case, KERNEL_TILE)


@pytest.mark.parametrize("tile_size", [1000, 257])
@pytest.mark.parametrize("case", ["sorted", "hot_pixel", "unsorted"])
def test_emulated_order_does_not_depend_on_the_tile(case, tile_size):
    """Tiles of other sizes than the kernel's 4096 keys: the order does not
    depend on where the tiles end (a partial last tile, a bucket over many
    tiles)."""
    _emulated_against_plain(case, tile_size)


def _emulated_against_plain(case, tile_size):
    xs, ys, ts, fids, W = make(case)
    assert len(tnat.digit_plan(keys_of(xs, ys, fids, W)[1])) >= 2
    pix = (np.asarray(ys, np.float32).astype(np.int64) * W
           + np.asarray(xs, np.float32).astype(np.int64))
    assert (pix.min() < 0) == (case == "negative")
    order, gid, counts = emulate_e1(xs, ys, ts, fids, W, tile_size)
    ref = tnat.sort_plain(xs, ys, ts, fids, W)
    for got, want, name in zip((order, gid, counts), ref, ("order", "group ids", "counts")):
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the group tables from run boundaries, as e1_group_tables takes them
    offs = np.flatnonzero(np.r_[True, gid[1:] != gid[:-1]])
    succ = np.r_[offs, len(gid)][gid + 1] - np.arange(len(gid)) - 1
    for got, want in zip((np.diff(np.r_[offs, len(gid)]), offs, succ),
                         tnat.group_tables_plain(gid, len(counts))):
        np.testing.assert_array_equal(got, want)

