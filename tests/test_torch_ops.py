"""Parity of the port's leaf ops and block-grid encoder with enerf_tpu."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, t, unit_dirs

from enerf_tpu.ops import aabb as jaabb, blockgrid as jbg, sh as jsh
from enerf_tpu.ops.trunc_exp import trunc_exp as jtrunc_exp
from enerf_torch.ops import aabb, blockgrid as bg, sh
from enerf_torch.ops.trunc_exp import trunc_exp

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_trunc_exp_matches_jax_and_golden():
    g = np.load(os.path.join(GOLDEN, "trunc_exp.npz"))
    # f32 exp on both sides: the golden's own tolerances (test_golden.py)
    x = t(g["x"]).requires_grad_(True)
    y = trunc_exp(x)
    y.sum().backward()
    np.testing.assert_allclose(n(y), g["y"], rtol=1e-6)
    np.testing.assert_allclose(n(x.grad), g["dx"], rtol=1e-5)
    # including the clamp region |x| > 15, against the JAX custom VJP
    xs = np.linspace(-40, 40, 101).astype(np.float32)
    xt = t(xs).requires_grad_(True)
    trunc_exp(xt).sum().backward()
    dj = jax.grad(lambda v: jnp.sum(jtrunc_exp(v)))(jnp.asarray(xs))
    np.testing.assert_allclose(n(xt.grad), np.asarray(dj), rtol=1e-6)


@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_sh_encode_matches_jax(degree):
    d = unit_dirs(np.random.default_rng(degree), 300)
    ref = np.asarray(jsh.sh_encode(jnp.asarray(d), degree))
    got = n(sh.sh_encode(t(d), degree))
    # same polynomials in f32; rounding of the longer degree-8 terms only
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert sh.sh_output_dim(degree) == degree * degree


def test_near_far_from_aabb_including_behind_origin_miss():
    rng = np.random.default_rng(0)
    o = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
    d = unit_dirs(rng, 400)
    box = np.asarray([-1, -1, -1, 1, 1, 1], np.float32)
    nj, fj = jaabb.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(box), 0.2)
    nt, ft = aabb.near_far_from_aabb(t(o), t(d), t(box), 0.2)
    # slab test is elementwise f32: identical
    np.testing.assert_array_equal(n(nt), np.asarray(nj))
    np.testing.assert_array_equal(n(ft), np.asarray(fj))
    # a box entirely behind the origin is a miss (FLT_MAX), as in JAX
    ob = np.asarray([[0, 0, 3.0]], np.float32)
    db = np.asarray([[0, 0, 1.0]], np.float32)
    nb, fb = aabb.near_far_from_aabb(t(ob), t(db), t(box), 0.2)
    assert float(nb[0]) == float(fb[0]) == aabb.MISS


@pytest.mark.parametrize("levels,log2,block", [(4, 10, 4), (4, 12, 3), (16, 19, 4)])
def test_block_grid_meta_and_address(levels, log2, block):
    kw = dict(num_levels=levels, level_dim=2, log2_hashmap_size=log2,
              desired_resolution=2048, block=block)
    mj, mt = jbg.BlockGridMeta(**kw), bg.BlockGridMeta(**kw)
    assert mt.total_rows == mj.total_rows
    np.testing.assert_array_equal(mt.offsets, mj.offsets)
    np.testing.assert_array_equal(mt.n_rows, mj.n_rows)
    x = np.random.default_rng(1).uniform(0, 1, (700, 3)).astype(np.float32)
    rj, lj, fj = jbg.block_address(jnp.asarray(x), mj)
    rt, lt, ft = bg.block_address(t(x), mt)
    # integer addressing (incl. the uint32 xor-prime hash) must be exact
    np.testing.assert_array_equal(n(rt), np.asarray(rj))
    np.testing.assert_array_equal(n(lt), np.asarray(lj))
    np.testing.assert_array_equal(n(ft), np.asarray(fj))


@pytest.mark.parametrize("levels,log2,block,npts", [
    (4, 12, 4, 700), (4, 12, 3, 700),
    # the production 16x2 blk4 shape: level row counts not multiples of 8
    (16, 19, 4, 257)])
def test_block_encode_forward_and_table_vjp(levels, log2, block, npts):
    meta_j = jbg.BlockGridMeta(num_levels=levels, level_dim=2, log2_hashmap_size=log2,
                               desired_resolution=2048, block=block)
    meta_t = bg.BlockGridMeta(num_levels=levels, level_dim=2, log2_hashmap_size=log2,
                              desired_resolution=2048, block=block)
    rng = np.random.default_rng(2)
    table = rng.uniform(-1e-2, 1e-2, (meta_j.total_rows, meta_j.row_cells * 2)).astype(np.float32)
    # a few samples outside [0, 1] must encode to (and scatter) zero
    x = rng.uniform(-0.05, 1.05, (npts, 3)).astype(np.float32)
    g = rng.normal(size=(npts, levels * 2)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda tb: jbg.block_encode(jnp.asarray(x), tb, meta_j),
                         jnp.asarray(table))
    (gt_j,) = vjp(jnp.asarray(g))
    tt = t(table).requires_grad_(True)
    # a small point_chunk exercises the chunked forward and backward
    out_t = bg.block_encode(t(x), tt, meta_t, point_chunk=128)
    (out_t * t(g)).sum().backward()
    # Against a float64 evaluation on the port's (exactly JAX-equal, see
    # test_block_grid_meta_and_address) addressing the port is off by ~1e-9.
    # The JAX CPU reduction over the 125-cell row is off by up to 9e-7 at
    # 16 levels (3e-8 at 4), so the JAX comparison is held at 2e-6 absolute,
    # 2e-4 of the table's 1e-2 scale.
    xc = t(np.clip(x, 0.0, 1.0))
    rid, lo, frac = bg.block_address(xc, meta_t)
    W = bg._trilinear_weights(lo, frac, meta_t).double()
    rows = t(table).double()[rid + torch.as_tensor(meta_t.offsets[:-1])]
    exact = torch.einsum("nlcr,nlr->nlc", rows.view(npts, levels, 2, -1), W)
    exact = exact.reshape(npts, -1).numpy()
    exact[((x < 0) | (x > 1)).any(-1)] = 0.0
    np.testing.assert_allclose(n(out_t), exact, rtol=0, atol=1e-8)
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), rtol=1e-5, atol=2e-6)
    # Table gradient (max |value| ~2.6 here): the port's index_add_ is within
    # 1.3e-7 of a float64 scatter; the JAX scatter-add within 5.5e-5 at 16
    # levels (many duplicate rows on coarse levels).  Port vs float64 at
    # 1e-6, port vs JAX at 1e-4 (4e-5 of the gradient's scale).
    contrib = t(g).double().view(npts, levels, 2).clone()
    contrib[t(((x < 0) | (x > 1)).any(-1))] = 0.0
    exact_g = torch.zeros(table.shape, dtype=torch.float64).index_add_(
        0, (rid + torch.as_tensor(meta_t.offsets[:-1])).reshape(-1),
        (contrib[..., None] * W[:, :, None, :]).reshape(-1, 2 * meta_t.row_cells))
    np.testing.assert_allclose(n(tt.grad), exact_g.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(tt.grad), np.asarray(gt_j), rtol=0, atol=1e-4)


def test_block_encode_refuses_position_grads():
    meta = bg.BlockGridMeta(num_levels=2, log2_hashmap_size=10)
    table = bg.init_block_table(meta, torch.Generator().manual_seed(0))
    x = torch.rand(8, 3, requires_grad=True)
    with pytest.raises(NotImplementedError):
        bg.block_encode(x, table, meta).sum().backward()
