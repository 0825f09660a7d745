"""The port's event-chain preprocessing (enerf_torch/data/native_events.py,
kernel E1) against the JAX package's native library
(enerf_tpu/data/native_events.py over native/event_preproc.cpp).

On the CPU: the port's four functions against the library's on the same
inputs, and the port's build_event_chains against JAX's (the library
loaded) field for field, on fractional float64 coordinates (the four
events at x = 3.99999999, 4, 3, 3 among them), unsorted times, equal times
at one pixel, a hot pixel of 10^4 events, several frames, and F * W * H >
2^28 (the library's std::stable_sort branch).  On the card (marker `gpu`,
skipped here): E1 against the plain version, bit-equal on every field, at
the same inputs.  The file imports JAX only inside its CPU tests, so the
card runs its `gpu` tests with

    python -m pytest tests/test_torch_native_events.py --noconftest -o addopts="" -q -m gpu
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch.data import events as tevents
from enerf_torch.data import native_events as tnat

CHAIN_FIELDS = ("xs", "ys", "ts", "pols", "cum_pols", "num_successors", "group_offset",
                "group_count", "frame_bounds", "pixel_bounds")


def make_events(case, n=5000, seed=0):
    """(events [M, 4] float64, frame ids [M] int64, n_frames) of one case."""
    rng = np.random.default_rng(seed)
    W, H, F = 64, 48, 3
    if case == "four":
        ev = np.array([[3.99999999, 2, 1, 1], [4, 2, 2, 1], [3, 2, 3, 1], [3, 2, 4, 1]])
        return ev, np.zeros(4, np.int64), 1
    if case == "big_keys":
        W, H, F = 8192, 8192, 5  # F * W * H > 2^28
    xs = rng.integers(0, W - 1, n).astype(np.float64)
    ys = rng.integers(0, H - 1, n).astype(np.float64)
    if case == "big_keys":  # 100 pixels spread over the frame, two at its far corner
        xs = rng.choice(np.r_[np.arange(9) * 1000, W - 2], n).astype(np.float64)
        ys = rng.choice(np.r_[np.arange(9) * 900, H - 2], n).astype(np.float64)
    ts = np.sort(rng.uniform(0, 1e6, n))
    if case in ("fractional", "frames", "n100k", "big_keys"):
        # float64 coordinates that float32 rounds across an integer
        xs += rng.choice([0.0, 0.25, 0.99999999, 1 - 1e-12], n)
        ys += rng.choice([0.0, 0.5, 0.999999999], n)
    if case == "unsorted":
        ts = rng.permutation(ts)
    if case == "equal_times":
        hot = rng.random(n) < 0.3
        xs[hot], ys[hot] = 5.0, 7.0
        ts = np.round(ts / 2e5) * 2e5  # five distinct times
    pols = rng.choice([-1.0, 1.0], n)
    if case == "hot_pixel":
        m = 10_000
        xs = np.concatenate([xs, np.full(m, 17.0)])
        ys = np.concatenate([ys, np.full(m, 11.0)])
        ts = np.sort(np.concatenate([ts, rng.uniform(0, 1e6, m)]))
        pols = np.concatenate([pols, rng.choice([-1.0, 1.0], m)])
    ev = np.stack([xs, ys, ts, pols], 1)
    fids = np.minimum((ev[:, 2] / 1e6 * F).astype(np.int64), F - 1)
    if case == "unsorted":
        fids = rng.integers(0, F, len(ev))
    if case == "negative":
        # pixels below 0, as a rectify map can give at the border
        ev[:, 0] -= 3.5
        ev[:, 1] -= 1.5
    return ev, fids, F


CASES = ["four", "fractional", "unsorted", "equal_times", "hot_pixel", "frames", "big_keys",
         "n100k"]


def _inputs(case):
    ev, fids, F = make_events(case, n=100_000 if case == "n100k" else 5000)
    W = int(ev[:, 0].max()) + 2
    H = int(ev[:, 1].max()) + 2
    return ev, fids, F, W, H


def _jax_native():
    pytest.importorskip("jax")
    from enerf_tpu.data import native_events as jnat
    if not jnat.available():
        pytest.skip("the JAX package's native library did not build (no g++)")
    return jnat


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", CASES)
def test_sort_and_group_tables_match_the_jax_library(case):
    jnat = _jax_native()
    ev, fids, _, W, H = _inputs(case)
    jo, jg, jn = jnat.sort_events_by_pixel(ev[:, 0], ev[:, 1], ev[:, 2], fids.astype(np.int32),
                                           W, H)
    to, tg, tn = tnat.sort_events_by_pixel(*(torch.from_numpy(np.ascontiguousarray(a)) for a in
                                             (ev[:, 0], ev[:, 1], ev[:, 2], fids)), W, H)
    assert tn == jn
    np.testing.assert_array_equal(_np(to), jo)
    np.testing.assert_array_equal(_np(tg), jg)
    jtables = jnat.group_tables(jg, jn)
    for got, ref in zip(tnat.group_tables(tg, tn), jtables):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(_np(got), ref)
    # sort_and_count: the same sort, each group's count beside it
    so, sg, sc = tnat.sort_and_count(*(torch.from_numpy(np.ascontiguousarray(a)) for a in
                                       (ev[:, 0], ev[:, 1], ev[:, 2], fids)), W)
    np.testing.assert_array_equal(_np(so), jo)
    np.testing.assert_array_equal(_np(sg), jg)
    assert sc.dtype == torch.int64
    np.testing.assert_array_equal(_np(sc), jtables[0])


def test_the_four_event_case_takes_float32_keys():
    """x = 3.99999999 rounds to 4.0f and joins x = 4: two groups of two,
    as in JAX's native path (its numpy fallback would give one group of
    three at x = 3 and drop the event at x = 4)."""
    ev, _, _ = make_events("four")
    chains, _ = tevents.build_event_chains(ev)
    np.testing.assert_array_equal(_np(chains.group_count), [2, 2])
    np.testing.assert_array_equal(_np(chains.xs), np.float32([3, 3, 4, 4]))
    np.testing.assert_array_equal(_np(chains.ts), np.float32([3, 4, 1, 2]))


@pytest.mark.parametrize("case", CASES)
def test_build_event_chains_matches_jax(case):
    _jax_native()
    from enerf_tpu.data import events as jevents
    ev, fids, F, _, _ = _inputs(case)
    if case == "four":
        fids, F = None, 1
    cj, tsj = jevents.build_event_chains(ev, fids, F)
    ct, tst = tevents.build_event_chains(ev, fids, F)
    np.testing.assert_array_equal(tst, tsj)
    for k in CHAIN_FIELDS:
        np.testing.assert_array_equal(_np(getattr(ct, k)), np.asarray(getattr(cj, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(_np(ct.frame_bounds_dev), ct.frame_bounds)
    np.testing.assert_array_equal(_np(ct.pixel_bounds_dev), ct.pixel_bounds)


def test_negative_pixels_sort_like_lexsort():
    """Events left of or above the image (no JAX counterpart: the library's
    counting sort indexes out of its arrays there) sort as numpy's lexsort
    by (frame, pixel, time)."""
    ev, fids, F = make_events("negative")
    W = int(ev[:, 0].max()) + 2
    order, gid, n = tnat.sort_events_by_pixel(*(torch.from_numpy(np.ascontiguousarray(a)) for a
                                                in (ev[:, 0], ev[:, 1], ev[:, 2], fids)), W, 0)
    pix = (ev[:, 1].astype(np.float32).astype(np.int64) * W
           + ev[:, 0].astype(np.float32).astype(np.int64))
    assert pix.min() < 0
    ref = np.lexsort((ev[:, 2], pix, fids))
    np.testing.assert_array_equal(_np(order), ref)
    key = np.stack([fids[ref], pix[ref]], 1)
    new = np.r_[True, (key[1:] != key[:-1]).any(1)]
    np.testing.assert_array_equal(_np(gid), np.cumsum(new) - 1)
    assert n == new.sum()
    chains, _ = tevents.build_event_chains(ev, fids, F)
    assert int(chains.num_successors.min()) >= 0


@pytest.mark.parametrize("tick", [1000.0, 1e6, 333.25])
def test_ms_to_idx_and_window_indices_match_the_jax_library(tick):
    jnat = _jax_native()
    rng = np.random.default_rng(1)
    ts = np.sort(rng.uniform(0, 50_000 if tick < 1e4 else 5e7, 3000))
    ts[10:20] = ts[10]  # equal times
    tt = torch.from_numpy(ts)
    np.testing.assert_array_equal(_np(tnat.ms_to_idx(tt, tick)), jnat.ms_to_idx(ts, tick))
    for lo, hi in [(ts[0], ts[-1]), (ts[10], ts[10]), (ts[10], ts[30]), (-1.0, 1e12),
                   (ts[5] + 1e-9, ts[2999])]:
        assert tnat.window_indices(tt, lo, hi) == jnat.window_indices(ts, lo, hi)
    assert _np(tnat.ms_to_idx(torch.zeros(0, dtype=torch.float64), tick)).shape == (0,)


# ------------------------------------------------------------ E1 on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (E1 has no CPU mode)")
    return torch.device("cuda")


def _columns(ev, fids, dev):
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a in (ev[:, 0], ev[:, 1], ev[:, 2], fids)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + ["negative"])
def test_e1_is_bit_equal_to_the_plain_version(case):
    dev = _cuda()
    ev, fids, F = make_events(case, n=100_000 if case == "n100k" else 5000)
    W, H = int(ev[:, 0].max()) + 2, int(ev[:, 1].max()) + 2
    before = tnat.sort_events_by_pixel.launches
    ko, kg, kn = tnat.sort_events_by_pixel(*_columns(ev, fids, dev), W, H)
    assert tnat.sort_events_by_pixel.launches == before + 1
    po, pg, pn = tnat.sort_events_by_pixel(*_columns(ev, fids, "cpu"), W, H)
    assert kn == pn
    np.testing.assert_array_equal(_np(ko), _np(po))
    np.testing.assert_array_equal(_np(kg), _np(pg))
    before = tnat.group_tables.launches
    for got, ref in zip(tnat.group_tables(kg, kn), tnat.group_tables(pg, pn)):
        np.testing.assert_array_equal(_np(got), _np(ref))
    assert tnat.group_tables.launches == before + 1
    for got, ref in zip(tnat.sort_and_count(*_columns(ev, fids, dev), W),
                        tnat.sort_and_count(*_columns(ev, fids, "cpu"), W)):
        np.testing.assert_array_equal(_np(got), _np(ref))
    ck, tk = tevents.build_event_chains(ev, fids, F, device=dev)
    cp, tp = tevents.build_event_chains(ev, fids, F, device="cpu")
    np.testing.assert_array_equal(tk, tp)
    for k in CHAIN_FIELDS:
        np.testing.assert_array_equal(_np(getattr(ck, k)), _np(getattr(cp, k)), err_msg=k)


@pytest.mark.gpu
def test_e1_sorts_a_hot_pixel_longer_than_a_merge_pass():
    """One pixel with 70,000 events in shuffled time (35 bitonic tiles, six
    merge passes) beside sparse ones."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    n = 70_000
    ev = np.stack([np.full(n, 3.0), np.full(n, 2.0), rng.uniform(0, 1, n),
                   np.ones(n)], 1)
    ev = np.concatenate([ev, make_events("unsorted")[0]])
    fids = np.zeros(len(ev), np.int64)
    W, H = int(ev[:, 0].max()) + 2, int(ev[:, 1].max()) + 2
    got = tnat.sort_and_count(*_columns(ev, fids, dev), W)
    ref = tnat.sort_and_count(*_columns(ev, fids, "cpu"), W)
    for g, r in zip(got, ref):  # order, group ids, counts (the hot pixel's from the block)
        np.testing.assert_array_equal(_np(g), _np(r))


@pytest.mark.gpu
def test_e1_ms_to_idx_and_windows_on_the_card():
    dev = _cuda()
    ts = np.sort(np.random.default_rng(2).uniform(0, 5e4, 4000))
    np.testing.assert_array_equal(_np(tnat.ms_to_idx(torch.from_numpy(ts).to(dev), 1000.0)),
                                  _np(tnat.ms_to_idx(torch.from_numpy(ts), 1000.0)))
    assert (tnat.window_indices(torch.from_numpy(ts).to(dev), 100.0, 3e4)
            == tnat.window_indices(torch.from_numpy(ts), 100.0, 3e4))


def _e1_against_plain(ev, fids, W):
    """E1's sort_and_count and group tables against the plain version's,
    bit for bit."""
    dev = _cuda()
    got = tnat.sort_and_count(*_columns(ev, fids, dev), W)
    ref = tnat.sort_and_count(*_columns(ev, fids, "cpu"), W)
    for name, g, r in zip(("order", "group ids", "counts"), got, ref):
        assert g.dtype == torch.int64, name
        np.testing.assert_array_equal(_np(g), _np(r), err_msg=name)
    for g, r in zip(tnat.group_tables(got[1], got[2].numel()),
                    tnat.group_tables(ref[1], ref[2].numel())):
        np.testing.assert_array_equal(_np(g), _np(r))


@pytest.mark.gpu
@pytest.mark.parametrize("side", [-1, 1])
def test_e1_at_a_tile_multiple_less_or_more_one(side):
    _cuda()
    n = 3 * tnat._lib().e1_tile() + side
    ev, fids, _ = make_events("frames", n=n, seed=7)
    _e1_against_plain(ev, fids, int(ev[:, 0].max()) + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [[1], [9], [9, 8, 8], [10, 10, 10]])
@pytest.mark.parametrize("side", [-1, 0, 1])
def test_e1_sort_workspace_for_m_off_a_tile_multiple(plan, side):
    """The workspace event_chains.cu lays out: each digit's counts and
    starts (2^bits each), a tile counter for each pass and for the group
    pass, a status word a tile a bucket for each pass and one a tile for
    the group pass, with the tiles rounded up."""
    _cuda()
    lib = tnat._lib()
    tile = lib.e1_tile()
    n = 7 * tile + side
    tiles = -(-n // tile)
    assert (tiles - 1) * tile < n <= tiles * tile
    words = sum(2 << w for w in plan) + len(plan) + 1 + sum(tiles << w for w in plan) + tiles
    digits = (len(plan), *plan, *[0] * (3 - len(plan)))
    assert lib.e1_sort_workspace(n, *digits) == words
    assert lib.e1_sort_workspace(n, 0, 0, 0, 0) == -1  # no digit
    assert lib.e1_sort_workspace(n, 1, 12, 0, 0) == -1  # a digit wider than 11 bits


@pytest.mark.gpu
@pytest.mark.parametrize("ids", [[0, 1, 1, 0], [-1, 0, 1, 2], [0, 1, 2, 3]])
def test_e1_group_tables_refuse_ids_not_sorted_in_range(ids):
    """E1 takes offsets where runs of the ids start: ids that decrease, or
    leave [0, n_groups) (here 3), raise instead of returning tables built
    from unwritten offsets."""
    dev = _cuda()
    with pytest.raises(ValueError, match="non-decreasing"):
        tnat.group_tables(torch.tensor(ids, dtype=torch.int64, device=dev), 3)
    counts, offsets, num_succ = tnat.group_tables(
        torch.tensor([0, 0, 2], dtype=torch.int64, device=dev), 3)  # a gap: a group of 0
    for got, want in zip((counts, offsets, num_succ),
                         tnat.group_tables_plain(np.array([0, 0, 2]), 3)):
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.gpu
@pytest.mark.parametrize("shuffled", [False, True])
def test_e1_with_one_key_takes_no_pass(shuffled):
    """Every event at one pixel in one frame: K = 1, no radix pass."""
    rng = np.random.default_rng(8)
    n = 5000
    ts = rng.uniform(0, 1, n)
    ts = ts if shuffled else np.sort(ts)
    ev = np.stack([np.full(n, 9.5), np.full(n, 4.0), ts, np.ones(n)], 1)
    assert tnat.digit_plan(1) == []
    _e1_against_plain(ev, np.full(n, 2, np.int64), 16)


@pytest.mark.gpu
def test_e1_over_the_widest_key_range():
    """Two frames x a pixel range of 2^29 (W = 2^15): K = 2^30, the most
    E1 takes, in three passes of ten bits."""
    rng = np.random.default_rng(9)
    n, W = 50_000, 1 << 15
    xs = rng.integers(0, W, n).astype(np.float64)
    ys = rng.integers(0, 1 << 14, n).astype(np.float64)
    xs[:2], ys[:2] = [0, W - 1], [0, (1 << 14) - 1]
    hot = rng.random(n) < 0.05
    xs[hot], ys[hot] = 123.0, 4567.0
    ts = np.sort(rng.uniform(0, 1e6, n))
    fids = (ts > 5e5).astype(np.int64)
    fids[:2] = [0, 1]
    assert (fids.max() - fids.min() + 1) * (1 << 29) == tnat.MAX_KEYS
    assert tnat.digit_plan(tnat.MAX_KEYS) == [10, 10, 10]
    _e1_against_plain(np.stack([xs, ys, ts, np.ones(n)], 1), fids, W)


@pytest.mark.gpu
def test_e1_with_unsorted_times_over_several_frames():
    """Shuffled times in five frames: short groups sorted by a thread, two
    hot pixels' groups (one per frame they span) by a block."""
    rng = np.random.default_rng(10)
    n = 60_000
    xs = rng.integers(0, 200, n).astype(np.float64)
    ys = rng.integers(0, 100, n).astype(np.float64)
    hot = rng.random(n) < 0.2
    xs[hot], ys[hot] = rng.choice([7.0, 150.0], int(hot.sum())), 33.0
    ts = np.round(rng.uniform(0, 1e6, n) / 50) * 50  # equal times among the hot pixels
    fids = rng.integers(0, 5, n)
    _e1_against_plain(np.stack([xs, ys, ts, np.ones(n)], 1), fids, 202)
