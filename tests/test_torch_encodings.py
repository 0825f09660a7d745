"""Parity of the port's remaining encoders with enerf_tpu: the frequency
encoding (and its golden), the identity encoding, Morton codes and bit
packing, the background sphere's polar coordinates, the 2-D hash grid of
the background net, and the position gradients of both grid encoders.

Position gradients: JAX's are autodiff (`jax.vjp` of the jitted
`hash_encode` / `block_encode`) and `block_encode_segsum(compute_dx=True)`.
Inside its jits JAX may contract x * scale + 0.5 into an FMA and flip a
floor() (ROADMAP §3), which moves a sample to another cell; so these tests
keep every in-box point at least 1e-4 of a cell from each cell face at
every level (`_clear_points`), and add points outside the box, whose
gradient is 0.  dx is held within 1e-4 of the largest |dx|.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, t, unit_dirs

from enerf_tpu.ops import aabb as jaabb, blockgrid as jbg, freq as jfreq, hashgrid as jh
from enerf_tpu.ops import morton as jmorton
from enerf_tpu.ops.scatter_accum import block_encode_fast as jblock_encode_fast
from enerf_torch.models import field as tfield
from enerf_torch.ops import aabb, blockgrid as bg, freq, hashgrid as th, morton
from enerf_torch.ops.scatter_accum import block_encode_fast

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DX_TOL = 1e-4  # of the largest |dx|


def _clear_points(count, seed, scales, D=3, margin=0.05, out_share=0.1, face=1e-4):
    """[count, D] f32 points: about out_share of them outside [0, 1]^D (by
    up to `margin`), the rest inside with frac = x * scale + 0.5 - floor at
    least `face` from 0 and 1 at every level and axis (in float64, so an
    FMA or a rounding cannot flip a floor)."""
    rng = np.random.default_rng(seed)
    keep = []
    while sum(len(k) for k in keep) < count:
        x = rng.uniform(0.0, 1.0, (4 * count, D)).astype(np.float32)
        pos = x.astype(np.float64)[:, None, :] * np.asarray(scales, np.float64)[None, :, None]
        frac = pos + 0.5 - np.floor(pos + 0.5)
        keep.append(x[(np.minimum(frac, 1.0 - frac) >= face).all(axis=(1, 2))])
    x = np.concatenate(keep)[:count]
    n_out = int(count * out_share)
    u = rng.uniform(0.01, margin, n_out)
    x[:n_out, 0] = np.where(rng.random(n_out) < 0.5, -u, 1.0 + u)
    return x.astype(np.float32)


def _assert_dx(dx_t, dx_j, oob):
    scale = np.abs(dx_j).max()
    assert scale > 0
    np.testing.assert_allclose(dx_t, dx_j, rtol=0, atol=DX_TOL * scale)
    assert (dx_t[oob] == 0).all() and (np.asarray(dx_j)[oob] == 0).all()


def _assert_table_grad(got, ref):
    """f32 scatter-adds of the same addends in another order
    (test_torch_hashgrid.py's tolerance)."""
    scale = np.abs(ref).max()
    assert scale > 0.5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * scale)


# ------------------------------------------------------------- the encoders

def test_freq_encode_matches_jax_and_golden():
    g = np.load(os.path.join(GOLDEN, "freq_encoder.npz"))
    # the golden's own tolerances (tests/test_golden.py:32)
    x = t(g["x"]).requires_grad_()
    assert int(g["N_freqs"]) == freq.MULTIRES
    y = freq.freq_encode(x)
    np.testing.assert_allclose(n(y), g["y"], atol=1e-5)
    (y * t(g["w"])).sum().backward()
    np.testing.assert_allclose(n(x.grad), g["dx"], atol=1e-4)
    # against JAX on the same points: the value (sin / cos of the same f32
    # products) within 1e-6; dx, a sum of 13 terms up to 32 w in size
    # summed in another order, within 1e-6 of the largest |dx|
    xs = np.random.default_rng(0).uniform(0, 1, (700, 3)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(700, 39)).astype(np.float32)
    yj, vjp = jax.vjp(lambda v: jfreq.freq_encode(v, multires=6), jnp.asarray(xs))
    (dj,) = vjp(jnp.asarray(w))
    xt = t(xs).requires_grad_()
    yt = freq.freq_encode(xt)
    (yt * t(w)).sum().backward()
    assert freq.freq_output_dim(3) == jfreq.freq_output_dim(3) == yt.shape[1] == 39
    np.testing.assert_allclose(n(yt), np.asarray(yj), rtol=0, atol=1e-6)
    scale = np.abs(np.asarray(dj)).max()
    np.testing.assert_allclose(n(xt.grad), np.asarray(dj), rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("encoding,width", [("frequency", 39), ("none", 3)])
def test_grid_free_field_encoding(encoding, width):
    st = tfield.FieldStatic(encoding=encoding, out_dim_color=1)
    assert st.grid_meta is None and st.in_dim == width
    params = tfield.init_field_params(st)
    assert "hash_table" not in params and params["sigma_w0"].shape == (width, 64)
    x01 = t(np.random.default_rng(2).uniform(0, 1, (50, 3)).astype(np.float32))
    enc = tfield._encode(params, st, x01)
    ref = freq.freq_encode(x01) if encoding == "frequency" else x01
    assert torch.equal(enc, ref)


def test_morton_and_packbits_match_jax():
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 1024, (700, 3)).astype(np.int32)
    codes_j = np.asarray(jmorton.morton3d(jnp.asarray(coords)))
    codes_t = morton.morton3d(t(coords))
    assert codes_t.dtype == torch.int32
    np.testing.assert_array_equal(n(codes_t), codes_j)
    np.testing.assert_array_equal(n(morton.morton3d_invert(codes_t)), coords)
    np.testing.assert_array_equal(n(morton.morton3d_invert(codes_t)),
                                  np.asarray(jmorton.morton3d_invert(jnp.asarray(codes_j))))
    grid = rng.uniform(0, 1, (2, 16 ** 3)).astype(np.float32)
    bits = morton.packbits(t(grid), 0.5)
    assert bits.dtype == torch.uint8 and bits.shape == (2 * 16 ** 3 // 8,)
    np.testing.assert_array_equal(n(bits), np.asarray(jmorton.packbits(jnp.asarray(grid), 0.5)))
    np.testing.assert_array_equal(n(morton.occupancy_bool(t(grid), 0.5)),
                                  np.asarray(jmorton.occupancy_bool(jnp.asarray(grid), 0.5)))


def test_polar_from_ray_matches_jax():
    rng = np.random.default_rng(0)
    # origins inside the sphere (every ray exits) and outside it, where some
    # rays miss and B^2 - AC < 0 clamps to 0
    o = np.concatenate([rng.uniform(-2, 2, (400, 3)),
                        rng.uniform(-9, 9, (300, 3))]).astype(np.float32)
    d = unit_dirs(rng, 700) * rng.uniform(0.5, 2.0, (700, 1)).astype(np.float32)
    pj = np.asarray(jaabb.polar_from_ray(jnp.asarray(o), jnp.asarray(d), 4.0))
    pt = n(aabb.polar_from_ray(t(o), t(d), 4.0))
    assert pt.shape == (700, 2) and np.isfinite(pt).all()
    assert (np.abs(pt) <= 1.0).all()
    missed = ((o * d).sum(-1) ** 2 - (d * d).sum(-1) * ((o * o).sum(-1) - 16.0)) < 0
    assert missed.any()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)


# ------------------------------------------------------- the 2-D hash grid

BG_META = dict(input_dim=2, num_levels=4, level_dim=2, base_resolution=16,
               log2_hashmap_size=19, desired_resolution=2048)


@pytest.mark.parametrize("kw", [BG_META, dict(BG_META, log2_hashmap_size=10)])
def test_2d_hash_grid_matches_jax(kw):
    mj, mt = jh.HashGridMeta(**kw), th.HashGridMeta(**kw)
    assert mt.input_dim == 2 and mt.total_entries == mj.total_entries
    for k in ("scales", "resolutions", "sizes", "offsets", "is_hashed", "dense_strides",
              "use_dim"):
        np.testing.assert_array_equal(getattr(mt, k), getattr(mj, k), err_msg=k)
    assert mt.is_hashed.any() and not mt.is_hashed.all()
    x = _clear_points(700, 1, mt.scales, D=2)
    oob = ((x < 0) | (x > 1)).any(-1)
    rng = np.random.default_rng(2)
    table = rng.uniform(-1, 1, (mt.total_entries, 2)).astype(np.float32)
    g = rng.normal(size=(700, mt.output_dim)).astype(np.float32)
    # JAX op by op (no jit, so no FMA contraction): the same f32 operations
    # in the same order as the port's
    with jax.disable_jit():
        out_j, vjp = jax.vjp(lambda tb: jh.hash_encode(jnp.asarray(x), tb, mj),
                             jnp.asarray(table))
        (gt_j,) = vjp(jnp.asarray(g))
    idx, w, oob_t = th.hash_address(t(x), mt)
    assert idx.shape == (700, 4, 4) and torch.equal(oob_t, t(oob))
    tt = t(table).requires_grad_()
    out_t = th.hash_encode(t(x), tt, mt)
    (out_t * t(g)).sum().backward()
    # four bilinear terms of U(-1, 1) rows, summed in the same order
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), rtol=0, atol=1e-6)
    assert (n(out_t)[oob] == 0).all()
    _assert_table_grad(n(tt.grad), np.asarray(gt_j))


# ------------------------------------------------------- position gradients

HASH_METAS = [dict(num_levels=4, level_dim=2, log2_hashmap_size=10, desired_resolution=2048),
              dict(num_levels=6, level_dim=2, base_resolution=4, log2_hashmap_size=7,
                   per_level_scale=2.0),
              BG_META]


@pytest.mark.parametrize("kw", HASH_METAS)
def test_hash_encode_position_grads_match_jax(kw):
    mj, mt = jh.HashGridMeta(**kw), th.HashGridMeta(**kw)
    D = mt.input_dim
    x = _clear_points(700, 3, mt.scales, D=D)
    oob = ((x < 0) | (x > 1)).any(-1)
    rng = np.random.default_rng(4)
    table = rng.uniform(-1, 1, (mt.total_entries, 2)).astype(np.float32)
    g = rng.normal(size=(700, mt.output_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda v, tb: jh.hash_encode(v, tb, mj), jnp.asarray(x),
                     jnp.asarray(table))
    dx_j, gt_j = vjp(jnp.asarray(g))
    xt, tt = t(x).requires_grad_(), t(table).requires_grad_()
    out = th.hash_encode(xt, tt, mt)
    (out * t(g)).sum().backward()
    _assert_dx(n(xt.grad), np.asarray(dx_j), oob)
    _assert_table_grad(n(tt.grad), np.asarray(gt_j))
    # the out= replay of remat_fixed=2 gives the same gradients
    xr, tr = t(x).requires_grad_(), t(table).requires_grad_()
    kept = th.hash_encode(xr, tr, mt, out=out.detach())
    (kept * t(g)).sum().backward()
    assert torch.equal(xr.grad, xt.grad) and torch.equal(tr.grad, tt.grad)


@pytest.mark.parametrize("block", [3, 4])
def test_block_encode_position_grads_match_jax(block):
    kw = dict(num_levels=4, level_dim=2, log2_hashmap_size=12, desired_resolution=2048,
              block=block)
    mj, mt = jbg.BlockGridMeta(**kw), bg.BlockGridMeta(**kw)
    assert mt.hashed.any()
    x = _clear_points(700, 5, mt.scales)
    oob = ((x < 0) | (x > 1)).any(-1)
    rng = np.random.default_rng(6)
    table = rng.uniform(-1, 1, (mt.total_rows, mt.row_cells * 2)).astype(np.float32)
    g = rng.normal(size=(700, mt.output_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jbg.block_encode(v, jnp.asarray(table), mj), jnp.asarray(x))
    (dx_auto,) = vjp(jnp.asarray(g))
    _, vjp = jax.vjp(lambda v: jbg.block_encode_segsum(v, jnp.asarray(table), mj, True),
                     jnp.asarray(x))
    (dx_segsum,) = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_()
    # a small point_chunk exercises the chunked backward
    (bg.block_encode(xt, t(table), mt, point_chunk=128) * t(g)).sum().backward()
    _assert_dx(n(xt.grad), np.asarray(dx_auto), oob)
    _assert_dx(n(xt.grad), np.asarray(dx_segsum), oob)
    # the K2 route gives zero position gradients, as JAX's does
    xk = t(x).requires_grad_()
    (block_encode_fast(xk, t(table), mt) * t(g)).sum().backward()
    _, vjp = jax.vjp(lambda v: jblock_encode_fast(v, jnp.asarray(table), mj), jnp.asarray(x))
    assert (n(xk.grad) == 0).all() and (np.asarray(vjp(jnp.asarray(g))[0]) == 0).all()


def test_field_density_position_grads_through_the_hash_grid():
    """dL/dx through the field's hash grid and sigma net (x in [-bound,
    bound]) against jax.grad of field_density."""
    from enerf_tpu.models import field as jfield
    from enerf_torch.convert import params_from_jax

    kw = dict(bound=2.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    pj = jfield.init_field_params(jax.random.PRNGKey(0), sj)
    pj["hash_table"] = jnp.asarray(np.random.default_rng(7).uniform(
        -1, 1, pj["hash_table"].shape).astype(np.float32))
    x01 = _clear_points(300, 8, st.grid_meta.scales, out_share=0.0)
    x = (x01 * 4.0 - 2.0).astype(np.float32)
    dj = jax.grad(lambda v: jnp.sum(jfield.field_density(pj, sj, v)[0]))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    tfield.field_density(params_from_jax({k: np.asarray(v) for k, v in pj.items()}), st,
                         xt)[0].sum().backward()
    scale = np.abs(np.asarray(dj)).max()
    np.testing.assert_allclose(n(xt.grad), np.asarray(dj), rtol=0, atol=DX_TOL * scale)
