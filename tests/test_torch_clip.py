"""Parity of the port's rand-pose CLIP step with enerf_tpu: the stub
embedder with JAX's projection carried across (the resize included), the
CLIP step's loss and gradients on the same pose on both renderers, the
rand-pose cadence and rays, a short CLIP-guided run, the trainer's
dispatch, and the refusal without --clip_text.

The two packages draw the stub's projection and text embedding from
different generators (threefry, torch.Generator), so the tests carry JAX's
across with `convert.embedder_from_jax` (ROADMAP §3).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t
from torch_march_parity import unpack_bitfield

from enerf_tpu.data import provider as jprov, synthetic as jsyn
from enerf_tpu.models import field as jfield
from enerf_tpu.ops import hashgrid as jh
from enerf_tpu.render import march as jmarch, occupancy as jocc
from enerf_tpu.train import clip_guidance as jclip, state as jstate, step as jstep
from enerf_torch.config import build_config
from enerf_torch.convert import embedder_from_jax, params_from_jax
from enerf_torch.data import provider as tprov
from enerf_torch.models import field as tfield
from enerf_torch.ops import hashgrid as th
from enerf_torch.render import march as tmarch
from enerf_torch.render.occupancy import pack_bitfield
from enerf_torch.train import clip_guidance as tclip, state as tstate, step as tstep
from enerf_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _carried(dim=64, channels=3, seed=0, text="a photo of a carpet"):
    je = jclip.StubEmbedder(dim=dim, channels=channels, seed=seed)
    tf = je.embed_text(text)
    emb, tf_t = embedder_from_jax(np.asarray(je._proj), np.asarray(tf))
    return je, tf, emb, tf_t


@pytest.mark.parametrize("side", [8, 16, 64, 173])
def test_stub_embedder_matches_jax(side):
    """jax.image.resize(..., "linear") antialiases when it shrinks: the
    port's explicit weight matrices give it within 1e-6 at every side the
    rand-pose step meets (8 upsamples, 16 is left as it is, 64 and 173
    shrink)."""
    je, tf, emb, tf_t = _carried()
    rng = np.random.default_rng(side)
    for C in (3, 1):
        img = rng.uniform(0, 1, (side, side, C)).astype(np.float32)
        x3 = np.repeat(img, 3, -1) if C == 1 else img
        rj = np.asarray(jax.image.resize(jnp.asarray(x3), (16, 16, 3), "linear"))
        np.testing.assert_allclose(n(tclip.resize_linear(t(x3), 16)), rj, rtol=0, atol=1e-6)
        zj = np.asarray(je(jnp.asarray(img)))
        zt = n(emb(t(img)))
        np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-6)
        # the loss and its gradient with respect to the image
        lj, gj = jax.value_and_grad(lambda x: 1.0 - jnp.sum(je(x) * tf))(jnp.asarray(img))
        xt = t(img).requires_grad_()
        lt = 1.0 - (emb(xt) * tf_t).sum()
        lt.backward()
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(n(xt.grad), np.asarray(gj), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(gj)).max())


def test_guidance_text_feature_and_the_clip_shim():
    assert not tclip.clip_available()  # neither machine has the clip package
    g = tclip.CLIPGuidance("a ball", tclip.StubEmbedder(dim=32))
    assert g.text_feat.shape == (32,)
    np.testing.assert_allclose(float(g.text_feat.norm()), 1.0, rtol=1e-6)
    assert torch.equal(g.text_feat, tclip.CLIPGuidance("a ball", tclip.StubEmbedder(dim=32))
                       .text_feat)  # stable per string
    assert not torch.equal(g.text_feat, g.embedder.embed_text("a cube"))
    img = torch.rand(8, 8, 1)
    np.testing.assert_allclose(float(g.loss(img)),
                               1.0 - float((g.embedder(img) * g.text_feat).sum()), rtol=1e-6)
    with pytest.raises(ImportError):
        tclip.CLIPLoss("a ball")
    with pytest.raises(ImportError):
        jclip.CLIPLoss("a ball")


# ---------------------------------------------------------- the rand pose

def _frames(rand_pose, num_rays=64, **kw):
    imgs = np.random.default_rng(0).uniform(size=(3, 16, 16, 1)).astype(np.float32)
    poses = np.stack([jsyn.circle_pose(v) for v in (0.0, 0.2, 0.4)])
    args = (imgs, poses, jsyn.default_intrinsics(16, 16))
    return (jprov.FramesProvider(*args, num_rays=num_rays, rand_pose=rand_pose, **kw),
            tprov.FramesProvider(*args, num_rays=num_rays, rand_pose=rand_pose, **kw))


@pytest.mark.parametrize("rand_pose,want", [(-1, ""), (0, "rrrrrr"), (1, ".r.r.r"),
                                            (4, "....r.")])
def test_rand_pose_cadence_and_rays(rand_pose, want):
    """tests/test_modes.py:71's cadence on both packages, then each rand
    batch's rays against JAX's from the same three draws."""
    pj, pt = _frames(rand_pose, rand_radius=2.5)
    gen = torch.Generator().manual_seed(0)
    kinds = ""
    for i in range(6):
        key = jax.random.PRNGKey(i)
        bj = pj.train_step_batch(key)
        bt = pt.train_step_batch(gen)
        assert ("rand_pose_side" in bj) == ("rand_pose_side" in bt)
        kinds += "r" if "rand_pose_side" in bt else "."
        if "rand_pose_side" not in bt:
            continue
        side = bt["rand_pose_side"]
        assert side == bj["rand_pose_side"] == 8 and "images" not in bt
        assert bt["rays_o"].shape == bt["rays_d"].shape == (64, 3)
        eye = n(bt["rays_o"][0])
        assert np.dot(eye, n(bt["rays_d"]).mean(0)) < 0  # looking at the scene
        assert 2.5 <= np.linalg.norm(eye) <= 3.0 + 1e-5
        # JAX's draws (FramesProvider._rand_pose_batch: fold_in 99, split 3)
        ks = jax.random.split(jax.random.fold_in(key, 99), 3)
        draws = torch.stack([t(jax.random.uniform(k, ())) for k in ks])
        bd = pt._rand_pose_batch(draws=draws)
        for k in ("rays_o", "rays_d"):
            np.testing.assert_allclose(n(bd[k]), np.asarray(bj[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    assert kinds == (want or "......")


def test_make_providers_wire_rand_pose(tmp_path):
    cfg = build_config(["--config", os.path.join(REPO, "configs", "synthetic_demo.txt"),
                        "--events", "0", "--event_only", "0", "--H", "16", "--W", "16",
                        "--syn_frames", "6", "--rand_pose", "2", "--radius", "3.5",
                        "--outdir", str(tmp_path)])
    train, _ = tprov.make_providers(cfg, device="cpu")
    train_j, _ = jprov.make_providers(cfg)
    assert (train.rand_pose, train.rand_radius) == (train_j.rand_pose, train_j.rand_radius) \
        == (2, 3.5)


# ------------------------------------------------------------ the CLIP step

def _clip_case(renderer):
    if renderer == "march":
        kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
                  encoding="blockgrid", use_fused_head=True, density_bias=3.0)
    else:
        kw = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10)
    sj, st = jfield.FieldStatic(**kw), tfield.FieldStatic(**kw)
    if renderer == "fixed":
        # finest level 64 cells (test_torch_frames.py: JAX's FMAs move the
        # weights by ulp * resolution)
        grid = dict(num_levels=4, level_dim=2, log2_hashmap_size=13, desired_resolution=64)
        sj.grid_meta, st.grid_meta = jh.HashGridMeta(**grid), th.HashGridMeta(**grid)
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    pj["hash_table"] = jnp.asarray(np.random.default_rng(1).uniform(
        -0.5, 0.5, pj["hash_table"].shape).astype(np.float32))
    return sj, st, pj


@pytest.mark.parametrize("renderer", ["fixed", "march"])
def test_train_step_clip_matches_jax(renderer, monkeypatch):
    sj, st, pj = _clip_case(renderer)
    je, tf, emb, tf_t = _carried(dim=32)
    march = renderer == "march"
    common = dict(min_near=0.2, density_scale=1.0, C_thres=0.2, event_only=False,
                  use_luma=False, linlog=True, out_dim_color=1, num_steps=32,
                  upsample_steps=0, weight_loss_rgb=1.0, use_march=march, march_samples=32,
                  max_steps=1024, compact_frac=0.5)
    ss_j = jstep.StepStatics(field_static=sj, negative_event_sampling=False, w_no_ev=1.0,
                             clip_embedder=je, **common)
    ss_t = tstep.StepStatics(field_static=st, clip_embedder=emb, **common)
    # one rand pose of the port's provider, side 8, looking at the box
    _, pt = _frames(0, rand_radius=2.5)
    batch = pt._rand_pose_batch(draws=torch.tensor([0.3, 0.6, 0.2]))
    side = batch.pop("rand_pose_side")
    N = side * side
    key = jax.random.PRNGKey(11)
    occ = None
    if march:
        occ = np.asarray(jocc.ball_bitfield(radius=0.6))
        noise = {"jitter_clip": t(jax.random.uniform(key, (N,)))}

        def jax_march(rays_o, rays_d, occ_bitfield, nears, fars, *, jitter, generator=None,
                      **kw):
            assert jitter is noise["jitter_clip"]
            out = jmarch.march_rays(*(jnp.asarray(n(a)) for a in
                                      (rays_o, rays_d, unpack_bitfield(occ_bitfield), nears,
                                       fars)), key, **kw)
            return tuple(t(a) for a in out)

        monkeypatch.setattr(tmarch, "march_rays", jax_march)
    else:
        noise = {"jitter_clip": t(jax.random.uniform(jax.random.split(key)[0], (N, 32)))}
    state_j, opt = jstate.init_train_state(pj, 0.005, 1000)
    bj = {k: jnp.asarray(n(v)) for k, v in batch.items()}
    (loss_j, aux_j), g_j = jax.value_and_grad(jstep.clip_loss_fn, has_aux=True)(
        state_j.params, ss_j, bj, key, tf, side, None if occ is None else jnp.asarray(occ))
    new_j = jstate.apply_updates(state_j, g_j, opt)
    state_t = tstate.TrainState(params_from_jax(params_np(pj)), 0.005, 1000)
    aux_t = tstep.train_step_clip(state_t, dict(batch), ss_t,
                                  None if occ is None else pack_bitfield(t(occ)),
                                  tf_t, side, noise=noise)
    assert set(aux_t) == {"loss", "loss_clip"} and state_t.step == 1
    np.testing.assert_allclose(float(aux_t["loss_clip"]), float(aux_j["loss_clip"]), rtol=1e-4)
    for k, gj in g_j.items():
        gj, gt = np.asarray(gj), n(state_t.params[k].grad)
        scale = np.abs(gj).max()
        assert scale > 0, k
        # test_torch_frames_mode.py's step tolerances
        tol = 3e-2 if k in ("hash_table", "sigma_w0") else 1e-3
        np.testing.assert_allclose(gt, gj, rtol=0, atol=tol * scale, err_msg=k)
        assert np.linalg.norm(gt - gj) <= 5e-3 * np.linalg.norm(gj), k
        clear = np.abs(gj) > 2 * tol * scale
        np.testing.assert_allclose(n(state_t.params[k])[clear], np.asarray(new_j.params[k])[clear],
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_clip_guided_training_reduces_clip_loss():
    """tests/test_modes.py:92 on the port: 15 CLIP steps lower loss_clip."""
    guidance = tclip.CLIPGuidance("a bright sphere", tclip.StubEmbedder(dim=32))
    st = tfield.FieldStatic(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10)
    state = tstate.TrainState(tfield.init_field_params(st, 0), 1e-2, 100)
    ss = tstep.StepStatics(field_static=st, min_near=0.2, density_scale=1.0, C_thres=0.2,
                           event_only=True, use_luma=False, linlog=True, out_dim_color=1,
                           num_steps=16, clip_embedder=guidance.embedder)
    prov = tprov.FramesProvider(np.zeros((1, 8, 8, 1), np.float32),
                                np.stack([jsyn.circle_pose(0.0)]),
                                jsyn.default_intrinsics(8, 8), num_rays=256, rand_pose=0)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(15):
        b = prov.train_step_batch(gen)
        side = b.pop("rand_pose_side")
        aux = tstep.train_step_clip(state, b, ss, None, guidance.text_feat, side, generator=gen)
        losses.append(float(aux["loss_clip"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), (losses[:3], losses[-3:])


# ---------------------------------------------------------------- the trainer

def _cfg(tmp, *extra):
    return build_config([
        "--config", os.path.join(REPO, "configs", "synthetic_demo.txt"), "--events", "0",
        "--event_only", "0", "--H", "16", "--W", "16", "--syn_frames", "6",
        "--num_levels", "2", "--num_rays", "64", "--num_steps", "8", "--march_samples", "8",
        "--log_every", "1", "--outdir", str(tmp), *extra])


def test_rand_pose_without_clip_text_raises(tmp_path):
    """A rand-pose batch without --clip_text: a ValueError naming both flags
    (JAX asserts at trainer.py:250)."""
    cfg = _cfg(tmp_path, "--rand_pose", "0")
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    train, _ = tprov.make_providers(cfg, device="cpu")
    with pytest.raises(ValueError, match="--rand_pose.*--clip_text"):
        tr.train_step(train)


@pytest.mark.parametrize("path", [(), ("--ff", "-O")])
def test_trainer_dispatches_rand_pose_batches_to_the_clip_step(tmp_path, path):
    """--rand_pose 1 --clip_text: step 1 a frames step (the error map
    updated), step 2 the CLIP step (no error-map update), on both
    renderers; each with a finite loss."""
    cfg = _cfg(tmp_path, *path, "--rand_pose", "1", "--clip_text", "a ball", "--error_map")
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    assert tr.clip_guidance is not None and tr.ss.clip_embedder is tr.clip_guidance.embedder
    train, _ = tprov.make_providers(cfg, device="cpu")
    train.steps_per_epoch = 2
    seen = []
    real = train.update_error_map
    train.update_error_map = lambda loss: (seen.append(loss.shape), real(loss))
    tr.train(train, max_epoch=1)
    (s1, a1), (s2, a2) = tr.history
    assert set(a1) == {"loss", "loss_frames"} and set(a2) == {"loss", "loss_clip"}
    assert np.isfinite([a1["loss"], a2["loss"]]).all() and 0.0 < a2["loss_clip"] < 2.0
    assert seen == [(64,)]  # the frames step's rays only
