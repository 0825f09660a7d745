"""Parity of the port's hash-grid encoder and hash-grid field with enerf_tpu
(and with the original reference's frozen outputs, tests/golden/network.npz).

Tables are drawn U(-1, 1) and output gradients N(0, 1), so every compared
value is far above the absolute floors of the tolerances.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t, unit_dirs

from enerf_tpu.models import field as jfield
from enerf_tpu.ops import hashgrid as jh
from enerf_torch.convert import params_from_jax
from enerf_torch.models import field as tfield
from enerf_torch.ops import hashgrid as th

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
METAS = [  # the default path's grid, the scalar-case grid, a small test grid
    dict(num_levels=16, level_dim=2, log2_hashmap_size=19, desired_resolution=2048),
    dict(num_levels=6, level_dim=2, base_resolution=4, log2_hashmap_size=7, per_level_scale=2.0),
    dict(num_levels=4, level_dim=2, log2_hashmap_size=10, desired_resolution=2048),
]


@pytest.mark.parametrize("kw", METAS)
def test_meta_constants_match_jax(kw):
    mj, mt = jh.HashGridMeta(**kw), th.HashGridMeta(**kw)
    assert mt.total_entries == mj.total_entries and mt.output_dim == mj.output_dim
    for k in ("scales", "resolutions", "sizes", "offsets", "is_hashed", "dense_strides",
              "use_dim"):
        np.testing.assert_array_equal(getattr(mt, k), getattr(mj, k), err_msg=k)
    # the uint32 strides the index math multiplies by
    np.testing.assert_array_equal(n(mt.tensors("cpu")["strides"]),
                                  np.asarray(mj._strides_dev).astype(np.int64))
    assert (th.HashGridMeta(**kw, gridtype="tiled").is_hashed == 0).all()


@jax.jit
def _jax_address_jit(x01, scales, strides, sizes, offsets, hashed):
    """enerf_tpu/ops/hashgrid.py:hash_encode's address math (:167-197), under
    jit as it runs there: flat rows [N, L, 8] and weights [N, L, 8]."""
    x = jnp.clip(x01.astype(jnp.float32), 0.0, 1.0)
    pos = x[:, None, :] * scales[None, :, None] + 0.5
    pos_grid = jnp.floor(pos)
    frac = pos - pos_grid
    pos_grid = pos_grid.astype(jnp.uint32)
    bits = jh._corner_bits(3)
    idxs, ws = [], []
    for c in range(8):
        cb = bits[c]
        corner = pos_grid + jnp.asarray(cb, jnp.uint32)[None, None, :]
        ws.append(jnp.prod(jnp.where(cb[None, None, :] == 1, frac, 1.0 - frac), axis=-1))
        dense = jnp.sum(corner * strides[None], axis=-1, dtype=jnp.uint32)
        h = jnp.zeros_like(dense)
        for d in range(3):
            h = h ^ (corner[..., d] * jnp.uint32(jh._PRIMES[d]))
        idx = jnp.where(hashed[None], h, dense) % sizes[None]
        idxs.append(idx.astype(jnp.int32) + offsets[None])
    return jnp.stack(idxs, -1), jnp.stack(ws, -1)


def jax_address(x, mj):
    idx, w = _jax_address_jit(jnp.asarray(x), mj._scales_dev, mj._strides_dev,
                              mj._sizes_dev, mj._offsets_dev, mj._is_hashed_dev)
    return np.asarray(idx), np.asarray(w)


def _points(count, seed, margin=0.05):
    """Positions in [-margin, 1 + margin]^3: some outside the unit box."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-margin, 1.0 + margin, (count, 3)).astype(np.float32)


def _numpy_address(x, mt):
    """The address math in float32 numpy, op by op (no fused multiply-add)."""
    x = np.clip(x, 0.0, 1.0)
    pos = x[:, None, :] * mt.scales[None, :, None] + np.float32(0.5)
    pg = np.floor(pos)
    frac = (pos - pg).astype(np.float32)
    pg = pg.astype(np.int64)
    strides = (mt.dense_strides % 2 ** 32) * mt.use_dim
    primes = (1, 2654435761, 805459861)
    idx, w = [], []
    for c in range(8):
        b = [(c >> d) & 1 for d in range(3)]
        cor = [pg[..., d] + b[d] for d in range(3)]
        f = [frac[..., d] if b[d] else np.float32(1.0) - frac[..., d] for d in range(3)]
        w.append((f[0] * f[1]) * f[2])
        dense = 0
        h = 0
        for d in range(3):
            dense = (dense + ((cor[d] * strides[None, :, d]) & 0xFFFFFFFF)) & 0xFFFFFFFF
            h = h ^ ((cor[d] * primes[d]) & 0xFFFFFFFF)
        rid = np.where(mt.is_hashed[None], h, dense) % mt.sizes[None]
        idx.append(rid + mt.offsets[None, :-1])
    return np.stack(idx, -1), np.stack(w, -1)


@pytest.mark.parametrize("kw", METAS)
def test_addresses_match_jax(kw):
    mj, mt = jh.HashGridMeta(**kw), th.HashGridMeta(**kw)
    x = _points(700, 1)
    idx_t, w_t, oob = th.hash_address(t(x), mt)
    oob_ref = ((x < 0) | (x > 1)).any(-1)
    np.testing.assert_array_equal(n(oob), oob_ref)
    assert oob_ref.any() and not oob_ref.all()
    # the same float32 ops in the same order: identical addresses
    idx_np, w_np = _numpy_address(x, mt)
    np.testing.assert_array_equal(n(idx_t), idx_np)
    np.testing.assert_array_equal(n(w_t), w_np)
    # JAX's jit may contract x * scale + 0.5 into an FMA: pos moves by up
    # to one ulp, which can flip a floor() (counted, bounded) and moves each
    # of the three weight factors by up to one ulp of pos
    idx_j, w_j = jax_address(x, mj)
    flipped = (n(idx_t) != idx_j).any(-1)  # [N, L] sample-levels
    assert flipped.mean() <= 1e-3, flipped.sum()
    ulp = np.spacing(mt.scales + np.float32(1.0)).astype(np.float32)  # per level
    tol = 3.0 * ulp[None, :, None]
    keep = ~flipped
    assert (np.abs(n(w_t) - w_j)[keep] <= np.broadcast_to(tol, w_j.shape)[keep]).all()


def test_hash_index_scalar_cases():
    """test_golden.py's hand-computable cases: with table[i, 0] = i % 997 the
    encoding is a weighted sum of the indices of the scalar CUDA
    transliteration (gridencoder.cu:34-71)."""
    from test_golden import _cu_get_grid_index

    meta = th.HashGridMeta(**METAS[1])
    table = np.zeros((meta.total_entries, 2), np.float32)
    table[:, 0] = np.arange(meta.total_entries) % 997
    xs = np.random.RandomState(7).uniform(0.0, 1.0, (24, 3)).astype(np.float32)
    out = n(th.hash_encode(t(xs), t(table), meta))
    for i in range(xs.shape[0]):
        for lvl in range(meta.num_levels):
            pos = xs[i] * np.float32(meta.scales[lvl]) + np.float32(0.5)
            pg = np.floor(pos).astype(np.int64)
            frac = pos - pg
            expected = 0.0
            for c in range(8):
                corner = [int(pg[d] + ((c >> d) & 1)) for d in range(3)]
                w = 1.0
                for d in range(3):
                    w *= frac[d] if (c >> d) & 1 else (1.0 - frac[d])
                idx = _cu_get_grid_index(bool(meta.is_hashed[lvl]), int(meta.sizes[lvl]),
                                         int(meta.resolutions[lvl]), corner)
                expected += w * table[int(meta.offsets[lvl]) + idx, 0]
            np.testing.assert_allclose(out[i, lvl * 2], expected, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kw", METAS[::2])
def test_encode_and_table_grad_match_jax_on_jax_addresses(kw):
    mj, mt = jh.HashGridMeta(**kw), th.HashGridMeta(**kw)
    rng = np.random.default_rng(2)
    x = _points(700, 2)
    table = rng.uniform(-1, 1, (mt.total_entries, 2)).astype(np.float32)
    g = rng.normal(size=(700, mt.output_dim)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda tb: jh.hash_encode(jnp.asarray(x), tb, mj), jnp.asarray(table))
    grad_j = np.asarray(vjp(jnp.asarray(g))[0])
    idx_j, w_j = jax_address(x, mj)
    oob = t(((x < 0) | (x > 1)).any(-1))
    out_t = th.encode_from_address(t(idx_j), t(w_j), oob, t(table))
    # the same eight f32 products summed in the same order
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), rtol=1e-6, atol=1e-6)
    assert np.abs(np.asarray(out_j)).max() > 0.1
    grad_t = th.table_grad_from_address(t(idx_j), t(w_j), oob, t(g), table.shape)
    # f32 scatter-adds of the same addends, in another order
    scale = np.abs(grad_j).max()
    assert scale > 0.5 and (grad_j != 0).sum() > 1000
    np.testing.assert_allclose(n(grad_t), grad_j, rtol=1e-5, atol=1e-6 * scale)
    assert (n(grad_t)[grad_j == 0] == 0).all()


def test_hash_encode_autograd_replay_and_position_grads():
    mt = th.HashGridMeta(**METAS[2])
    rng = np.random.default_rng(3)
    x = t(_points(500, 3))
    table = t(rng.uniform(-1, 1, (mt.total_entries, 2)).astype(np.float32)).requires_grad_()
    g = t(rng.normal(size=(500, mt.output_dim)).astype(np.float32))
    idx, w, oob = th.hash_address(x, mt)
    out = th.hash_encode(x, table, mt)
    assert torch.equal(out, th.encode_from_address(idx, w, oob, table.detach()))
    assert (out[oob] == 0).all()
    (gt,) = torch.autograd.grad(out, table, g)
    assert torch.equal(gt, th.table_grad_from_address(idx, w, oob, g, table.shape))
    # a kept encoding is returned as it is, with the same table backward
    kept = th.hash_encode(x, table, mt, out=out.detach())
    assert torch.equal(kept, out)
    assert torch.equal(torch.autograd.grad(kept, table, g)[0], gt)
    # positions get dL/dx (JAX parity: test_torch_encodings.py): float64
    # autograd of the blend on the same addresses and the same f32 frac
    # (d frac / dx = scale; floor() contributes nothing); 0 outside the
    # box; the same through the replay
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(th.hash_encode(xg, table, mt), xg, g)
    (dx_kept,) = torch.autograd.grad(th.hash_encode(xg, table, mt, out=out.detach()), xg, g)
    assert torch.equal(dx_kept, dx) and (dx[oob] == 0).all()
    xd = x.double().clamp(0.0, 1.0).requires_grad_()
    pos = xd[:, None, :] * torch.as_tensor(mt.scales).double()[None, :, None]
    frac = th._cell(x, mt)[1].double() + (pos - pos.detach())
    ref = 0.0
    for c in range(8):
        wc = 1.0
        for d in range(3):
            wc = wc * (frac[..., d] if (c >> d) & 1 else 1.0 - frac[..., d])
        ref = ref + wc[..., None] * table.detach().double()[idx[..., c].long()]
    (dx_ref,) = torch.autograd.grad((ref.reshape(500, -1)[~oob] * g[~oob].double()).sum(), xd)
    np.testing.assert_allclose(n(dx), n(dx_ref), rtol=0, atol=1e-5 * float(dx_ref.abs().max()))


def _golden_field():
    g = np.load(os.path.join(GOLDEN, "network.npz"))
    st = tfield.FieldStatic(bound=1.0, encoding="hashgrid", out_dim_color=1, sh_degree=4,
                            num_levels=16, level_dim=2, base_resolution=16, log2_hashmap_size=14)
    # the golden used desired_resolution=256 (a shrunk config, the same code)
    st.grid_meta = th.HashGridMeta(num_levels=16, level_dim=2, base_resolution=16,
                                   log2_hashmap_size=14, desired_resolution=256)
    assert st.grid_meta.total_entries == g["embeddings"].shape[0]
    params = {"hash_table": t(g["embeddings"])}
    for i in range(2):
        params[f"sigma_w{i}"] = t(g[f"sigma_w{i}"].T.copy())  # torch [out, in]
    for i in range(3):
        params[f"color_w{i}"] = t(g[f"color_w{i}"].T.copy())
    return g, st, {k: v.requires_grad_() for k, v in params.items()}


def test_field_matches_reference_golden():
    """The composed reference NeRFNetwork (network.py:104-214): forward and
    parameter gradients at test_golden.py:293-343's tolerances, and each
    gradient also within 1e-3 of its largest entry (the golden's table is
    U(+-1e-4), so some of the absolute floors alone would pass anything)."""
    g, st, params = _golden_field()
    x, d = t(g["x"]), t(g["d"])
    sigma, color = tfield.field_forward(params, st, x, d)
    np.testing.assert_allclose(n(sigma), g["sigma"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(color), g["color"], rtol=1e-4, atol=1e-5)
    ((sigma * t(g["ws"])).mean() + (color * t(g["wc"])).mean()).backward()
    checks = [("hash_table", "d_embeddings", False, dict(atol=1e-6))]
    checks += [(f"sigma_w{i}", f"d_sigma_w{i}", True, dict(rtol=1e-3, atol=1e-5))
               for i in range(2)]
    checks += [(f"color_w{i}", f"d_color_w{i}", True, dict(rtol=1e-3, atol=1e-5))
               for i in range(3)]
    for name, gname, transpose, tol in checks:
        ref = g[gname].T if transpose else g[gname]
        got = n(params[name].grad)
        np.testing.assert_allclose(got, ref, err_msg=name, **tol)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max(),
                                   err_msg=name)


def _fields(bf16):
    kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
              encoding="hashgrid")
    sj = jfield.FieldStatic(compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw)
    st = tfield.FieldStatic(compute_dtype=torch.bfloat16 if bf16 else torch.float32, **kw)
    pj = jfield.init_field_params(jax.random.PRNGKey(0), sj)
    rng = np.random.default_rng(4)
    pj["hash_table"] = jnp.asarray(
        rng.uniform(-1.0, 1.0, pj["hash_table"].shape).astype(np.float32))
    return sj, st, pj, params_from_jax(params_np(pj))


@pytest.mark.parametrize("bf16", [False, True])
def test_field_matches_jax(bf16):
    sj, st, pj, pt = _fields(bf16)
    assert st.grid_meta.total_entries == pj["hash_table"].shape[0]
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    d = unit_dirs(rng, 700)
    s_j, c_j = jfield.field_forward(pj, sj, jnp.asarray(x), jnp.asarray(d))
    s_t, c_t = tfield.field_forward(pt, st, t(x), t(d))
    if bf16:
        # bf16 rounding at the same points; a sum in another order (or an
        # FMA-moved weight) can land on the other side of a bf16 rounding
        np.testing.assert_allclose(n(s_t), np.asarray(s_j), rtol=3e-2, atol=1e-6)
        np.testing.assert_allclose(n(c_t), np.asarray(c_j), rtol=0, atol=1e-2)
        return
    # f32: JAX's FMA-moved weights (test_addresses_match_jax) move the
    # encoding by up to ~1e-4 of the table's scale
    np.testing.assert_allclose(n(s_t), np.asarray(s_j), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(n(c_t), np.asarray(c_j), rtol=1e-3, atol=1e-6)

    def loss_j(p):
        s, c = jfield.field_forward(p, sj, jnp.asarray(x), jnp.asarray(d))
        return jnp.mean(s) + jnp.sum(c ** 2)

    g_j = jax.grad(loss_j)(pj)
    pt = {k: v.requires_grad_(True) for k, v in pt.items()}
    s, c = tfield.field_forward(pt, st, t(x), t(d))
    (s.mean() + (c ** 2).sum()).backward()
    for k in g_j:
        gj = np.asarray(g_j[k])
        np.testing.assert_allclose(n(pt[k].grad), gj, rtol=0, atol=2e-3 * np.abs(gj).max(),
                                   err_msg=k)


# dense levels 0-1, hashed above (D = 3: 125 and 729 rows fit 2^10, 17^3 does
# not; D = 2: 25, 81, 289 fit, 33^2 does not)
SAVED_META = dict(num_levels=4, level_dim=2, base_resolution=4, per_level_scale=2.0,
                  log2_hashmap_size=10)


def _saved_case(dims, x_grad, seed):
    meta = th.HashGridMeta(input_dim=dims, **SAVED_META)
    assert meta.is_hashed.any() and not meta.is_hashed.all()
    rng = np.random.default_rng(seed)
    x = t(rng.uniform(-0.05, 1.05, (400, dims)).astype(np.float32)).requires_grad_(x_grad)
    table = t(rng.uniform(-1, 1, (meta.total_entries, 2)).astype(np.float32)).requires_grad_()
    g = t(rng.normal(size=(400, meta.output_dim)).astype(np.float32))
    return meta, x, table, g


@pytest.mark.parametrize("x_grad", [False, True])
def test_hash_encode_node_saves_the_positions_not_the_addresses(x_grad):
    """The VJP recomputes the addresses: the node keeps x01 alone, and the
    table only where x01 needs a gradient."""
    meta, x, table, _ = _saved_case(3, x_grad, 6)
    saved = th.hash_encode(x, table, meta).grad_fn.saved_tensors
    assert len(saved) == 2 and saved[0] is x
    assert (saved[1] is table) if x_grad else saved[1] is None
    assert not any(s is not None and s.dim() == 3 for s in saved)  # no [N, L, 2^D]


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("replay", [False, True])
def test_hash_encode_grads_equal_the_address_saving_path(dims, replay):
    """Table and position gradients through the recomputing node equal the
    plain functions on the forward's addresses, bit for bit on the CPU, with
    dense and hashed levels and samples outside the box, also through the
    `out` replay (remat_fixed=2)."""
    meta, x, table, g = _saved_case(dims, True, 7 + dims)
    idx, w, oob = th.hash_address(x.detach(), meta)
    assert oob.any() and not oob.all()
    plain = th.encode_from_address(idx, w, oob, table.detach())
    out = th.hash_encode(x, table, meta, out=plain if replay else None)
    assert torch.equal(out, plain)
    dx, dtable = torch.autograd.grad(out, (x, table), g)
    assert torch.equal(dtable, th.table_grad_from_address(idx, w, oob, g, table.shape))
    assert torch.equal(dx, th.position_grad_from_address(x.detach(), idx, oob, table.detach(), g,
                                                         meta))
    assert (dx[oob] == 0).all() and dx.abs().max() > 0
