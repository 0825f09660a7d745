"""Parity of the port's block-grid table gradient (kernel K2's plain
version, block_encode_fast, fast_table_grad) with enerf_tpu, on the same
inputs.  JAX runs its Pallas kernel in interpret mode (tests/conftest.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t, unit_dirs
from torch_march_parity import unpack_bitfield

from enerf_tpu.models import field as jfield
from enerf_tpu.ops import blockgrid as jbg, scatter_accum as jsa
from enerf_tpu.render import march as jmarch, occupancy as jocc
from enerf_tpu.train import losses as jlosses
from enerf_torch.convert import params_from_jax
from enerf_torch.models import field as tfield
from enerf_torch.ops import blockgrid as tbg, scatter_accum as tsa
from enerf_torch.render import march as tmarch
from enerf_torch.render.occupancy import pack_bitfield
from enerf_torch.train import losses as tlosses

# Both table gradients are sums of the same f32 addends g * W (the weights
# are multiplied in the same order) in another order: 1e-5 absolute, the
# tolerance of tests/test_scatter_accum.py.
ATOL = 1e-5


def _metas(block=4, levels=4, log2=16):
    kw = dict(num_levels=levels, level_dim=2, base_resolution=16,
              log2_hashmap_size=log2, desired_resolution=256, block=block)
    return jbg.BlockGridMeta(**kw), tbg.BlockGridMeta(**kw)


def _inputs(count, levels, seed=0, oob=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(count, 3)).astype(np.float32)
    x[:oob] += 2.0  # out of the unit box: zero encoding, zero gradient
    g = rng.normal(size=(count, levels * 2)).astype(np.float32)
    return x, g


def _pairs_from_jax(mj, x, g):
    """JAX's block addressing of x, as the port's flat pair inputs."""
    rid, lo, frac = jbg.block_address(jnp.asarray(x), mj)
    rid = np.asarray(rid) + mj.offsets[:-1][None, :]
    L = mj.num_levels
    return (t(rid.reshape(-1).astype(np.int32)), t(np.asarray(lo).reshape(-1, 3).astype(np.int32)),
            t(np.asarray(frac).reshape(-1, 3)), t(g.reshape(-1, 2))), (rid, lo, frac, L)


@pytest.mark.parametrize("block", [4, 3])
def test_plain_version_matches_jax_reference_and_pallas(block):
    mj, mt = _metas(block)
    x, g = _inputs(257, mj.num_levels)
    pairs, (rid, lo, frac, L) = _pairs_from_jax(mj, x, g)
    got = n(tsa.block_table_grad(*pairs, mt.total_rows, mt))
    assert got.shape == (mt.total_rows, 2 * mt.row_cells) and np.abs(got).max() > 0.1

    rid_local = np.asarray(jbg.block_address(jnp.asarray(x), mj)[0])
    meta8 = jnp.concatenate([jnp.asarray(lo).astype(jnp.float32),
                             jnp.asarray(g).reshape(-1, L, 2), jnp.asarray(frac)], axis=-1)
    rid_t, meta8_t = jnp.asarray(rid_local).T, jnp.transpose(meta8, (1, 0, 2))
    ref = jsa.block_table_grad_reference(rid_t, meta8_t, mj.total_rows, mj.offsets[:-1],
                                         halo=mj.halo, row_cells=mj.row_cells)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    rows_max = -(-int(mj.n_rows.max()) // 8) * 8
    per_level = jsa.block_table_grad_pallas(rid_t, meta8_t, L, rows_max=rows_max,
                                            halo=mj.halo, row_cells=mj.row_cells)
    np.testing.assert_allclose(got, np.asarray(jsa.depad_level_grads(per_level, mj)),
                               rtol=0, atol=ATOL)
    # float64 arithmetic gives the same sums to f32 rounding
    got64 = n(tsa.block_table_grad_reference(*pairs, mt.total_rows, mt, dtype=torch.float64))
    np.testing.assert_allclose(got, got64, rtol=0, atol=ATOL)


def test_kernel_wrapper_refuses_what_it_cannot_take():
    _, mt = _metas()
    P = 10
    rid = torch.zeros(P, dtype=torch.int32)
    lo, frac, g = torch.zeros(P, 3, dtype=torch.int32), torch.zeros(P, 3), torch.zeros(P, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tsa.launch_kernel(rid, lo, frac, g, mt.total_rows, mt)
    with pytest.raises(TypeError):
        tsa.block_table_grad(rid.long(), lo, frac, g, mt.total_rows, mt)
    with pytest.raises(ValueError):
        tsa.block_table_grad(rid, lo, frac, torch.zeros(P, 3), mt.total_rows, mt)
    assert tsa.block_table_grad.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("block", [4, 3])
def test_block_encode_fast_forward_grads_and_out_of_box(block):
    mj, mt = _metas(block)
    x, g = _inputs(211, mj.num_levels, seed=1, oob=16)
    table = np.random.default_rng(2).uniform(-1, 1, (mt.total_rows, 2 * mt.row_cells)
                                             ).astype(np.float32)
    xt = t(x).requires_grad_(True)
    tt = t(table).requires_grad_(True)
    y = tsa.block_encode_fast(xt, tt, mt)
    (y * t(g)).sum().backward()
    # forward: the port's block_encode (held against JAX by test_torch_ops.py)
    tt2 = t(table).requires_grad_(True)
    y_slow = tbg.block_encode(t(x), tt2, mt)
    (y_slow * t(g)).sum().backward()
    np.testing.assert_array_equal(n(y), n(y_slow))
    assert not n(y)[:16].any()
    # table gradient: the index_add_ backward and JAX's fast backward
    np.testing.assert_allclose(n(tt.grad), n(tt2.grad), rtol=0, atol=ATOL)
    g_j = jax.grad(lambda tab: jnp.sum(jsa.block_encode_fast(jnp.asarray(x), tab, mj)
                                       * jnp.asarray(g)))(jnp.asarray(table))
    np.testing.assert_allclose(n(tt.grad), np.asarray(g_j), rtol=0, atol=ATOL)
    # positions get a zero gradient, as in JAX (:238)
    assert xt.grad is not None and not n(xt.grad).any()
    # out-of-box samples add nothing: dropping them leaves the gradient
    tt3 = t(table).requires_grad_(True)
    (tsa.block_encode_fast(t(x[16:]), tt3, mt) * t(g[16:])).sum().backward()
    np.testing.assert_allclose(n(tt.grad), n(tt3.grad), rtol=0, atol=ATOL)


def test_field_level_fast_grad_parity():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    grads = {}
    for fast in (True, False):
        kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=12,
                  encoding="blockgrid", fast_table_grad=fast)
        sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
        pj = jfield.init_field_params(jax.random.PRNGKey(0), sj)
        pt = {k: v.requires_grad_(True) for k, v in params_from_jax(params_np(pj)).items()}
        (tfield.field_density(pt, st, t(x))[0] ** 2).sum().backward()
        grads[fast] = n(pt["hash_table"].grad)
        if fast:
            g_j = jax.grad(lambda p: jnp.sum(jfield.field_density(p, sj, jnp.asarray(x))[0] ** 2)
                           )(pj)["hash_table"]
            np.testing.assert_allclose(grads[True], np.asarray(g_j), rtol=0, atol=ATOL)
    assert np.abs(grads[True]).max() > 0
    np.testing.assert_allclose(grads[True], grads[False], rtol=0, atol=ATOL)


def test_unaligned_level_rows_16x2_blk4():
    """The reference 16 x 2 blk4 shape has 8388-row levels (not a multiple
    of 8): the TPU kernel rounds rows_max up and depads; K2 needs neither."""
    kw = dict(num_levels=16, level_dim=2, block=4)
    mj, mt = jbg.BlockGridMeta(**kw), tbg.BlockGridMeta(**kw)
    assert int(mt.n_rows.max()) % 8 != 0
    x, g = _inputs(257, 16, seed=4)
    table = np.asarray(jbg.init_block_table(jax.random.PRNGKey(0), mj))
    g_j = jax.grad(lambda tab: jnp.sum(jsa.block_encode_fast(jnp.asarray(x), tab, mj)
                                       * jnp.asarray(g)))(jnp.asarray(table))
    # on JAX's addresses: JAX's jitted position math may be FMA-contracted,
    # which can flip a floor() where a corner weight is ~1e-5 (measured
    # 6.7e-5 on 12 cells of 28.7M when the port addresses the points itself)
    pairs, _ = _pairs_from_jax(mj, x, g)
    got = n(tsa.block_table_grad(*pairs, mt.total_rows, mt))
    np.testing.assert_allclose(got, np.asarray(g_j), rtol=0, atol=ATOL)
    tt, tt2 = t(table).requires_grad_(True), t(table).requires_grad_(True)
    (tsa.block_encode_fast(t(x), tt, mt) * t(g)).sum().backward()
    (tbg.block_encode(t(x), tt2, mt) * t(g)).sum().backward()
    np.testing.assert_allclose(n(tt.grad), n(tt2.grad), rtol=0, atol=ATOL)


def test_bench_march_step_matches_jax(monkeypatch):
    """One step of bench.py's march loss (fast_table_grad, separate
    marches, compact_frac 0.25, the ball bitfield, o = (0, 0, -2.5) and
    o + 0.01, bg 0.5, pols 1, C 0.2) at 4 levels, in f32 (the two
    frameworks round bf16 at other places)."""
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
              encoding="blockgrid", fast_table_grad=True, density_bias=3.0)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    pj = jfield.init_field_params(jax.random.PRNGKey(0), sj)
    rng = np.random.default_rng(5)
    pj["hash_table"] = jnp.asarray(
        rng.uniform(-1e-2, 1e-2, pj["hash_table"].shape).astype(np.float32))
    N = 64
    d = unit_dirs(rng, N)
    d[:, 2] = np.abs(d[:, 2]) + 1.0  # towards the ball
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.float32([[0.0, 0.0, -2.5]]), (N, 1))
    bitfield = np.asarray(jocc.ball_bitfield())
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    j1, j2 = (t(jax.random.uniform(k, (N,))) for k in (k1, k2))
    bg, pols = np.full((N, 1), 0.5, np.float32), np.ones(N, np.float32)

    def loss_j(p):
        outs = [jmarch.render_rays_march(p, sj, jnp.asarray(bitfield), jnp.asarray(oo),
                                         jnp.asarray(d), num_samples=32, max_steps=1024,
                                         bg_color=jnp.asarray(bg), perturb=True, rng=k,
                                         compact_frac=0.25)
                for oo, k in ((o, k1), (o + 0.01, k2))]
        ll = [jlosses.log_intensity(out["image"], use_luma=False) for out in outs]
        return jlosses.event_loss((ll[1] - ll[0])[None], jnp.asarray(pols)[None, :, None], 0.2)

    loss_jv, g_j = jax.value_and_grad(loss_j)(pj)

    # composite JAX's march samples (an FMA-contracted position can flip a
    # block-grid floor(), see tests/test_torch_train.py)
    keys = {id(j1): k1, id(j2): k2}

    def jax_march(rays_o, rays_d, occ_bitfield, nears, fars, *, jitter, **kw_):
        out = jmarch.march_rays(*(jnp.asarray(n(a)) for a in
                                  (rays_o, rays_d, unpack_bitfield(occ_bitfield), nears, fars)),
                                keys[id(jitter)], **kw_)
        return tuple(t(a) for a in out)

    monkeypatch.setattr(tmarch, "march_rays", jax_march)
    pt = {k: v.requires_grad_(True) for k, v in params_from_jax(params_np(pj)).items()}
    outs = [tmarch.render_rays_march(pt, st, pack_bitfield(t(bitfield)), t(oo), t(d),
                                     num_samples=32, max_steps=1024, bg_color=t(bg), perturb=True, jitter=j,
                                     compact_frac=0.25)
            for oo, j in ((o, j1), (o + 0.01, j2))]
    ll = [tlosses.log_intensity(out["image"], False) for out in outs]
    loss_t = tlosses.event_loss((ll[1] - ll[0])[None], t(pols)[None, :, None], 0.2)
    loss_t.backward()
    # f32 renders through log-intensity x 255: 1e-4 relative (test_torch_train.py)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_jv), rtol=1e-4)
    gj = np.asarray(g_j["hash_table"])
    scale = np.abs(gj).max()
    assert scale > 0
    # the event pair's renders cancel in the gradient: 1e-3 of its largest
    # entry, as tests/test_torch_train.py holds the step's gradients
    np.testing.assert_allclose(n(pt["hash_table"].grad), gj, rtol=0, atol=1e-3 * scale)
