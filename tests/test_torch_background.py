"""Parity of the port's background net and grid-free encoders with
enerf_tpu: the bg field on JAX's params carried across; the march
composite, `render_rays_infer` and the fixed-step renderer with the bg net;
the event and frames steps' gradients with the bg net and with the
frequency / identity encoders; the plain fused head (K1's CPU path) at the
grid-free widths E = 3 / 39 against JAX's Pallas head in interpret mode;
checkpoints of a bg field and a table-less field in the JAX layout, both
ways; a Trainer of each option taking a step on both renderers.

The bg net's 2-D hash grid runs inside JAX's jits, which may contract
x * scale + 0.5 into an FMA and flip a floor() (ROADMAP §3); the rays here
are kept where each level's bg coordinate is at least 1e-3 of a cell from
every cell face (`clear_bg`), so no floor() can flip.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t, unit_dirs
from torch_march_parity import per_render, unpack_bitfield

from enerf_tpu.models import field as jfield
from enerf_tpu.ops import fused_mlp as jfmlp
from enerf_tpu.ops.aabb import near_far_from_aabb as jnear_far
from enerf_tpu.render import march as jmarch, occupancy as jocc, renderer as jrend
from enerf_tpu.train import checkpoints as jckpt, state as jstate, step as jstep
from enerf_torch.config import build_config
from enerf_torch.convert import params_from_jax
from enerf_torch.data.provider import make_providers
from enerf_torch.models import field as tfield
from enerf_torch.ops import fused_mlp
from enerf_torch.ops.aabb import aabb_tensor, near_far_from_aabb, polar_from_ray
from enerf_torch.render import march as tmarch, renderer as trend
from enerf_torch.render.occupancy import pack_bitfield
from enerf_torch.train import checkpoints as tckpt, state as tstate, step as tstep
from enerf_torch.train.trainer import Trainer

BG = 4.0
BOX = np.asarray([-1, -1, -1, 1, 1, 1], np.float32)


def clear_bg(o, d, radius, meta, face=1e-3):
    """[N] bool: rays whose bg coordinate (float64 polar_from_ray) sits at
    least `face` of a cell from every cell face at every bg level."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    A, B = (d * d).sum(-1), (o * d).sum(-1)
    C = (o * o).sum(-1) - radius * radius
    p = o + ((-B + np.sqrt(np.maximum(B * B - A * C, 0.0))) / A)[:, None] * d
    theta = np.arctan2(np.sqrt(p[:, 0] ** 2 + p[:, 2] ** 2), p[:, 1])
    phi = np.arctan2(p[:, 2], p[:, 0])
    x01 = (np.stack([2.0 * theta / np.pi - 1.0, phi / np.pi], -1) + 1.0) / 2.0
    pos = x01[:, None, :] * meta.scales.astype(np.float64)[None, :, None] + 0.5
    frac = pos - np.floor(pos)
    return (np.minimum(frac, 1.0 - frac) >= face).all(axis=(1, 2))


def rays(count, seed, meta, miss=0):
    """Rays from a shell of radius ~2.5: count - miss aimed near the centre,
    then `miss` turned away from the box; all clear_bg."""
    rng = np.random.default_rng(seed)
    o = unit_dirs(rng, 4 * count) * rng.uniform(2.0, 3.0, (4 * count, 1)).astype(np.float32)
    d = rng.uniform(-0.5, 0.5, (4 * count, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    out = []
    for sign, k in ((1.0, count - miss), (-1.0, miss)):
        keep = np.flatnonzero(clear_bg(o, sign * d, BG, meta))[:k]
        assert len(keep) == k
        out.append((o[keep], sign * d[keep]))
    return np.concatenate([a for a, _ in out]), np.concatenate([b for _, b in out])


def fields(encoding="blockgrid", fused=True, out_dim_color=1, bg_radius=BG, **extra):
    kw = dict(bound=1.0, out_dim_color=out_dim_color, num_levels=4, log2_hashmap_size=10,
              encoding=encoding, use_fused_head=fused, bg_radius=bg_radius, **extra)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    pj = jfield.init_field_params(jax.random.PRNGKey(3), sj)
    rng = np.random.default_rng(3)
    # tables of a trained scale, so that the encodings matter
    for k, s in (("hash_table", 1.0), ("bg_table", 0.5)):
        if k in pj:
            pj[k] = jnp.asarray(rng.uniform(-s, s, pj[k].shape).astype(np.float32))
    return sj, st, pj, params_from_jax(params_np(pj))


@pytest.mark.parametrize("out_dim_color,no_view", [(3, False), (1, True)])
def test_field_background_matches_jax(out_dim_color, no_view):
    sj, st, pj, pt = fields(out_dim_color=out_dim_color, disable_view_direction=no_view)
    # params_from_jax carries the bg net 1:1, and the port draws the same
    # keys and shapes
    assert {k for k in pj if k.startswith("bg_")} == {"bg_table", "bg_w0", "bg_w1"}
    for k, v in pj.items():
        np.testing.assert_array_equal(n(pt[k]), np.asarray(v), err_msg=k)
    own = tfield.init_field_params(st)
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in pj.items()}
    assert st.mlp_dims("bg") == sj.mlp_dims("bg") == [(16 + 8, 64), (64, out_dim_color)]
    o, d = rays(300, 1, st.bg_grid_meta)
    polar = polar_from_ray(t(o), t(d), BG)
    # JAX op by op (no jit: no FMA), on the port's polar coordinates
    with jax.disable_jit():
        bj = jfield.field_background(pj, sj, jnp.asarray(n(polar)), jnp.asarray(d))
    bt = tfield.field_background(pt, st, polar, t(d))
    assert bt.shape == (300, out_dim_color) and float(bt.std()) > 1e-3
    np.testing.assert_allclose(n(bt), np.asarray(bj), rtol=1e-5, atol=1e-6)


def _march_both(o, d, bitfield, num_samples=32):
    nj, fj = jnear_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(BOX), 0.2)
    out_j = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bitfield), nj, fj,
                              jax.random.PRNGKey(5), num_samples=num_samples, max_steps=1024,
                              cascades=1, bound=1.0, dt_gamma=0.0, perturb=True)
    nt, ft = near_far_from_aabb(t(o), t(d), aabb_tensor(1.0, "cpu"), 0.2)
    return out_j, (nj, fj), (nt, ft)


def test_composite_and_infer_with_bg_match_jax():
    sj, st, pj, pt = fields()
    o, d = rays(128, 2, st.bg_grid_meta, miss=16)
    bitfield = np.asarray(jocc.ball_bitfield(radius=0.6))
    (tsj, dtsj, vj), (nj, fj), (nt, ft) = _march_both(o, d, bitfield)
    # the caller's bg_color is overridden by the bg net
    out_j = jmarch.composite_from_march(pj, sj, jnp.asarray(o), jnp.asarray(d), tsj, dtsj, vj,
                                        nj, fj, bg_color=0.3, compact_frac=0.5)
    out_t = tmarch.composite_from_march(pt, st, t(o), t(d), t(tsj), t(dtsj), t(vj), nt, ft,
                                        bg_color=0.3, compact_frac=0.5)
    ws = n(out_t["weights_sum"])
    assert ws.max() > 0.05 and (ws[-16:] == 0).all()  # the field shows, 16 rays miss
    for k in ("image", "depth", "weights_sum"):  # test_torch_render.py's tolerance
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    bgc = tfield.field_background(pt, st, polar_from_ray(t(o), t(d), BG), t(d))
    assert torch.equal(out_t["image"][-16:], bgc[-16:])  # a missing ray shows the bg net
    out_j = jmarch.render_rays_infer(pj, sj, jnp.asarray(bitfield), jnp.asarray(o),
                                     jnp.asarray(d), block=16, max_steps=1024, bg_color=0.3)
    out_t = tmarch.render_rays_infer(pt, st, pack_bitfield(t(bitfield)), t(o), t(d), block=16,
                                     max_steps=1024, bg_color=0.3)
    assert torch.equal(out_t["image"][-16:], bgc[-16:])
    for k in ("image", "depth", "weights_sum"):  # test_torch_render.py's tolerance
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("encoding", ["frequency", "none"])
def test_fixed_renderer_with_bg_matches_jax(encoding):
    sj, st, pj, pt = fields(encoding=encoding, fused=False, out_dim_color=3)
    o, d = rays(96, 3, st.bg_grid_meta, miss=8)
    key = jax.random.PRNGKey(7)
    out_j = jrend.render_rays(pj, sj, jnp.asarray(o), jnp.asarray(d), num_steps=32,
                              bg_color=0.3, perturb=True, rng=key, train=True)
    jitter = t(jax.random.uniform(jax.random.split(key)[0], (96, 32)))
    out_t = trend.render_rays(pt, st, t(o), t(d), num_steps=32, bg_color=0.3, perturb=True,
                              jitter=jitter, train=True)
    assert n(out_t["weights_sum"]).max() > 0.05
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the staged renderer cuts the rays (and the bg net's) into chunks
    staged = trend.render_rays_staged(pt, st, t(o), t(d), max_ray_batch=40, num_steps=32,
                                      bg_color=0.3, perturb=True, jitter=jitter, train=True)
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(n(staged[k]), n(out_t[k]), rtol=1e-6, atol=1e-7, err_msg=k)


# ------------------------------------------------------------ step gradients

STEP_CASES = [  # (mode, renderer, encoding, bg_radius)
    ("events", "march", "blockgrid", BG),
    ("frames", "fixed", "frequency", -1.0),
    ("frames", "fixed", "none", BG),
    ("frames", "march", "frequency", BG),
]


@pytest.mark.parametrize("mode,renderer,encoding,bg_radius", STEP_CASES)
def test_step_gradients_match_jax(mode, renderer, encoding, bg_radius, monkeypatch):
    march = renderer == "march"
    sj, st, pj, _ = fields(encoding=encoding, fused=march, bg_radius=bg_radius,
                           density_bias=3.0 if march else 0.0)
    common = dict(min_near=0.2, density_scale=1.0, C_thres=0.2, event_only=True,
                  use_luma=False, linlog=True, out_dim_color=1, num_steps=32,
                  upsample_steps=0, weight_loss_rgb=1.0, use_march=march, march_samples=32,
                  max_steps=1024, dt_gamma=0.0, compact_frac=0.5, w_opacity=0.01)
    ss_j = jstep.StepStatics(field_static=sj, negative_event_sampling=False, w_no_ev=1.0,
                             **common)
    ss_t = tstep.StepStatics(field_static=st, **common)
    meta = st.bg_grid_meta or tfield.FieldStatic(bg_radius=BG).bg_grid_meta
    rng = np.random.default_rng(4)
    # 96 event pairs, of which those clear_bg on both rays are kept; 64
    # frame rays (at 96, the identity case's colour net has a pre-activation
    # 1e-9 from zero, where the two packages' roundings put the ReLU on
    # different sides: a kink flip, like a floor() flip, not a fault)
    N = 96 if mode == "events" else 64
    o1, d1 = rays(N, 5, meta)
    key = jax.random.PRNGKey(11)
    if mode == "events":
        # test_torch_train.py's pair: the second ray moved by ~0.2 / ~0.1,
        # the pairs whose second ray is also clear_bg kept
        o2 = o1 + rng.normal(scale=0.2, size=(N, 3)).astype(np.float32)
        d2 = d1 + rng.normal(scale=0.1, size=(N, 3)).astype(np.float32)
        d2 = (d2 / np.linalg.norm(d2, axis=-1, keepdims=True)).astype(np.float32)
        keep = clear_bg(o2, d2, BG, meta)
        batch = {"rays_evs_o1": o1[keep], "rays_evs_d1": d1[keep], "rays_evs_o2": o2[keep],
                 "rays_evs_d2": d2[keep],
                 "pols": rng.choice([-1.0, 1.0], int(keep.sum())).astype(np.float32)}
        N = int(keep.sum())
        k_bg, k1, k2 = jax.random.split(key, 7)[:3]
        noise = {"bg": t(jax.random.uniform(k_bg, (1, 1))),
                 "jitter1": t(jax.random.uniform(k1, (N,))),
                 "jitter2": t(jax.random.uniform(k2, (N,)))}
        keys = {id(noise["jitter1"]): k1, id(noise["jitter2"]): k2}
        loss_fn, step_fn = jstep.event_loss_fn, tstep.train_step_events
    else:
        batch = {"rays_o": o1, "rays_d": d1,
                 "images": rng.uniform(0, 1, (N, 1)).astype(np.float32)}
        k_bg, k_r = jax.random.split(key)
        noise = {"bg_frames": t(jax.random.uniform(k_bg, (N, 1)))}
        if march:
            noise["jitter_frames"] = t(jax.random.uniform(k_r, (N,)))
            keys = {id(noise["jitter_frames"]): k_r}
        else:
            noise["jitter_frames"] = t(jax.random.uniform(jax.random.split(k_r)[0], (N, 32)))
        loss_fn, step_fn = jstep.frames_loss_fn, tstep.train_step_frames
    occ = None
    if march:
        occ = np.asarray(jocc.ball_bitfield(radius=0.6))

        # both packages composite JAX's march samples (test_torch_train.py)
        def jax_march(rays_o, rays_d, occ_bitfield, nears, fars, *, jitter, generator=None,
                      **kw):
            out = jmarch.march_rays(*(jnp.asarray(n(a)) for a in
                                      (rays_o, rays_d, unpack_bitfield(occ_bitfield), nears, fars)),
                                    keys[id(jitter)], **kw)
            return tuple(t(a) for a in out)

        monkeypatch.setattr(tmarch, "march_rays", jax_march)
        monkeypatch.setattr(tstep, "march_rays", jax_march)
        monkeypatch.setattr(tstep, "march_rays_pair", per_render(jax_march))
    state_j, opt = jstate.init_train_state(pj, 0.005, 1000)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, _), g_j = jax.value_and_grad(loss_fn, has_aux=True)(
        state_j.params, ss_j, bj, key, None if occ is None else jnp.asarray(occ))
    state_t = tstate.TrainState(params_from_jax(params_np(pj)), 0.005, 1000)
    aux_t = step_fn(state_t, {k: t(v) for k, v in batch.items()}, ss_t,
                    None if occ is None else pack_bitfield(t(occ)), noise=noise)
    np.testing.assert_allclose(float(aux_t["loss"]), float(loss_j), rtol=1e-4)
    assert set(g_j) == set(state_t.params)
    assert ("bg_table" in g_j) == (bg_radius > 0) and ("hash_table" in g_j) == (
        encoding == "blockgrid")
    for k, gj in g_j.items():
        gj, gt = np.asarray(gj), n(state_t.params[k].grad)
        scale = np.abs(gj).max()
        assert scale > 0, k
        # test_torch_frames_mode.py's tolerances: the density path's
        # gradients sum terms that cancel (3e-2 of the scale per entry,
        # 5e-3 in L2), the rest 1e-3 of the scale
        tol = 3e-2 if k in ("hash_table", "sigma_w0") else 1e-3
        np.testing.assert_allclose(gt, gj, rtol=0, atol=tol * scale, err_msg=k)
        assert np.linalg.norm(gt - gj) <= 5e-3 * np.linalg.norm(gj), k


# ------------------------------------------------------ K1 at the new widths

@pytest.mark.parametrize("E", [3, 39])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_fused_head_at_grid_free_widths_matches_jax(E, bf16):
    """K1's CPU path (the plain version) against JAX's Pallas head in
    interpret mode, on an enc E wide: the identity encoding's 3 (K1's KE = 1
    on the card) and the frequency encoding's 39 (KE = 4)."""
    rng = np.random.default_rng(E)
    B = 700
    enc = rng.uniform(-1, 1, (B, E)).astype(np.float32)
    denc = rng.uniform(-1, 1, (B, 16)).astype(np.float32)
    shapes = [(E, 64), (64, 16), (31, 64), (64, 64), (64, 3)]
    ws = [rng.uniform(-1, 1, s).astype(np.float32) / np.sqrt(s[0]) for s in shapes]
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    s_j, c_j = jfmlp.fused_field_head(*(jnp.asarray(a, jd) for a in (enc, denc, *ws)))
    launches = fused_mlp.fused_field_head.launches
    s_t, c_t = fused_mlp.fused_field_head(*(t(a).to(td) for a in (enc, denc, *ws)))
    assert fused_mlp.fused_field_head.launches == launches  # CPU: the plain version
    assert fused_mlp.k_steps(E) == {3: 1, 39: 4}[E]
    if bf16:  # test_torch_field.py's bf16 tolerances
        np.testing.assert_allclose(n(s_t), np.asarray(s_j), rtol=3e-2, atol=1e-6)
        np.testing.assert_allclose(n(c_t), np.asarray(c_j), rtol=0, atol=1e-2)
    else:  # test_fused_mlp.py's forward tolerance
        np.testing.assert_allclose(n(s_t), np.asarray(s_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(n(c_t), np.asarray(c_j), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("encoding", ["blockgrid", "none"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bg_and_tableless_checkpoint_round_trip(tmp_path, encoding, direction):
    """A bg field (block grid) and a table-less bg field (identity
    encoding) in the JAX file layout, read by the other package."""
    sj, st, pj, pt = fields(encoding=encoding)
    assert ("hash_table" in pj) == (encoding == "blockgrid") and "bg_table" in pj
    state_j, opt = jstate.init_train_state(pj, 5e-3, 100)
    rng = np.random.default_rng(0)
    tmpl_t = tstate.TrainState(tfield.init_field_params(st, 7), 5e-3, 100)
    if direction == "jax_to_port":
        for _ in range(2):
            state_j = jstate.apply_updates(state_j, {
                k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                for k, v in pj.items()}, opt)
        path = jckpt.save_checkpoint(str(tmp_path / "j_ep0001"), state_j, None, 1)
        state_t, _, _ = tckpt.load_checkpoint(path, tmpl_t, None)
        assert state_t.step == 2
        for k, p in state_t.params.items():
            np.testing.assert_array_equal(n(p), np.asarray(state_j.params[k]), err_msg=k)
            np.testing.assert_array_equal(n(state_t.ema_params[k]),
                                          np.asarray(state_j.ema_params[k]), err_msg=k)
    else:
        state_t = tstate.TrainState(pt, 5e-3, 100)
        for _ in range(3):
            for p in state_t.params.values():
                p.grad = t(rng.normal(size=p.shape).astype(np.float32))
            state_t.apply_updates()
        path = tckpt.save_checkpoint(str(tmp_path / "t_ep0002"), state_t, None, 2)
        loaded, _, _ = jckpt.load_checkpoint(path, state_j, None)
        assert int(loaded.step) == 3
        for k, p in state_t.params.items():
            np.testing.assert_array_equal(np.asarray(loaded.params[k]), n(p), err_msg=k)
            np.testing.assert_array_equal(np.asarray(loaded.opt_state[0].mu[k]),
                                          n(state_t.exp_avg[k]), err_msg=k)


# ------------------------------------------------------------------ trainers

def _cfg(tmp, *extra):
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return build_config([
        "--config", os.path.join(repo, "configs", "synthetic_demo.txt"), "--event_only", "0",
        "--H", "16", "--W", "16", "--syn_frames", "6", "--num_levels", "2",
        "--batch_size_evs", "32", "--num_rays", "32", "--num_steps", "8",
        "--march_samples", "8", "--outdir", str(tmp), *extra])


@pytest.mark.parametrize("option", [("--bg_radius", "4"), ("--encoding", "frequency"),
                                    ("--encoding", "none")])
@pytest.mark.parametrize("path", [(), ("--ff", "-O")])
def test_trainer_takes_a_step_with_each_option(tmp_path, option, path):
    cfg = _cfg(tmp_path, *path, *option)
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    assert tr.ss.use_march == bool(path)
    assert ("bg_table" in tr.state.params) == (cfg.bg_radius > 0)
    assert ("hash_table" in tr.state.params) == (cfg.encoding == "auto")
    train, _ = make_providers(cfg, device="cpu")
    aux = tr.train_step(train)
    assert np.isfinite(float(aux["loss"])) and float(aux["loss"]) > 0
    assert all(p.grad is not None for p in tr.state.params.values())
