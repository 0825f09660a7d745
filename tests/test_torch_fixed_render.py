"""Parity of the port's compositing and fixed-step renderer with enerf_tpu
and with the reference's frozen run() outputs (run_renderer_*.npz), on the
same rays, the same analytic field and the same noise."""

import os
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from test_golden import _AnalyticStatic, _analytic_fns
from torch_parity import n, t

from enerf_tpu.ops import composite as jcomp
from enerf_tpu.render import renderer as jrend
from enerf_torch.ops import composite as tcomp
from enerf_torch.render import renderer as trend

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _torch_fns(wg, wd):
    """The analytic field of test_golden.py, in torch."""
    def density_fn(params, static, x):
        r2 = (x ** 2).sum(-1)
        sigma = params["s"] * 3.0 * torch.exp(-4.0 * r2) * (1.5 + torch.sin(5.0 * x[..., 0]))
        return sigma, x  # geo_feat carries positions to the colour fn

    def color_fn(params, static, d, geo_feat):
        return torch.sigmoid(geo_feat @ wg + d @ wd)

    return density_fn, color_fn


def test_composite_rays_matches_jax():
    rng = np.random.default_rng(0)
    N, T, C = 64, 48, 3
    sig = rng.uniform(0, 8, (N, T)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, T, C)).astype(np.float32)
    z = np.sort(rng.uniform(0.2, 3.0, (N, T)), -1).astype(np.float32)
    dl = np.diff(z, append=z[:, -1:] + 0.05).astype(np.float32)
    nears, fars = z[:, 0].copy(), z[:, -1].copy()
    fars[:4] = nears[:4]  # rays that missed the box: an empty span
    bg = rng.uniform(0, 1, (N, C)).astype(np.float32)
    out_j = jcomp.composite_rays(*(jnp.asarray(a) for a in (sig, rgb, dl, z, nears, fars, bg)),
                                 density_scale=1.3)
    out_t = tcomp.composite_rays(*(t(a) for a in (sig, rgb, dl, z, nears, fars, bg)),
                                 density_scale=1.3)
    assert n(out_t["weights_sum"]).min() > 0.1
    for k in ("image", "depth", "weights_sum", "weights"):
        assert np.isfinite(n(out_t[k])).all(), k
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_matches_jax(det):
    rng = np.random.default_rng(1)
    N, T, S = 40, 33, 16
    bins = np.sort(rng.uniform(0, 2, (N, T)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (N, T - 1)).astype(np.float32)
    w[:5] = 0.0  # all-zero weights: the 1e-5 floor makes the pdf uniform
    key = jax.random.PRNGKey(2)
    got_j = np.asarray(jrend.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), S, det=det))
    u = None if det else t(jax.random.uniform(key, (N, S)))  # JAX's own draws
    got_t = n(trend.sample_pdf(t(bins), t(w), S, det=det, u=u))
    assert (np.diff(got_t, axis=-1) >= 0).all() if det else True
    np.testing.assert_allclose(got_t, got_j, rtol=1e-5, atol=1e-6)


def _golden_inputs(tag):
    g = np.load(os.path.join(GOLDEN, f"run_renderer_{tag}.npz"))
    kw = dict(num_steps=int(g["num_steps"]), upsample_steps=int(g["upsample_steps"]),
              bg_color=float(g["bg"]), min_near=float(g["min_near"]),
              density_scale=float(g["density_scale"]))
    return g, kw


@pytest.mark.parametrize("tag", ["noups", "ups"])
def test_render_rays_matches_reference_golden(tag):
    """The reference's pure-torch run() (renderer.py:150-278) on the analytic
    field: test_golden.py's tolerances."""
    g, kw = _golden_inputs(tag)
    fns = _torch_fns(t(g["wg"]), t(g["wd"]))
    static = types.SimpleNamespace(bound=float(g["bound"]), bg_radius=-1.0)

    def render(s):
        return trend.render_rays({"s": s}, static, t(g["rays_o"]), t(g["rays_d"]),
                                 perturb=False, train=False, field_fns=fns, **kw)

    out = render(torch.tensor(1.0))
    np.testing.assert_allclose(n(out["image"]), g["image"], atol=2e-5)
    np.testing.assert_allclose(n(out["depth"]), g["depth"], atol=2e-5)
    s = torch.tensor(1.0, requires_grad=True)
    o = render(s)
    (o["image"].sum() + o["depth"].sum()).backward()
    assert abs(float(g["grad_s"])) > 0.1
    np.testing.assert_allclose(float(s.grad), float(g["grad_s"]), rtol=2e-4)


@pytest.mark.parametrize("tag", ["noups", "ups"])
def test_render_rays_training_noise_matches_jax(tag):
    """Training renders (perturb, stochastic upsampling) with JAX's own
    jitter and PDF draws handed in: image, depth, weights_sum and the
    parameter gradient."""
    g, kw = _golden_inputs(tag)
    static_j = _AnalyticStatic(float(g["bound"]))
    fns_j = _analytic_fns(jnp.asarray(g["wg"]), jnp.asarray(g["wd"]))
    rng = jax.random.PRNGKey(9)
    N = g["rays_o"].shape[0]

    def render_j(s):
        return jrend.render_rays({"s": s}, static_j, jnp.asarray(g["rays_o"]),
                                 jnp.asarray(g["rays_d"]), perturb=True, rng=rng, train=True,
                                 field_fns=fns_j, **kw)

    k_pert, k_pdf = jax.random.split(rng)
    jitter = t(jax.random.uniform(k_pert, (N, kw["num_steps"])))
    u = t(jax.random.uniform(k_pdf, (N, max(kw["upsample_steps"], 1))))
    static_t = types.SimpleNamespace(bound=float(g["bound"]), bg_radius=-1.0)
    fns_t = _torch_fns(t(g["wg"]), t(g["wd"]))
    s = torch.tensor(1.0, requires_grad=True)
    out_t = trend.render_rays({"s": s}, static_t, t(g["rays_o"]), t(g["rays_d"]),
                              perturb=True, jitter=jitter, u=u, train=True, field_fns=fns_t,
                              **kw)
    out_j = render_j(jnp.float32(1.0))
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k]), atol=2e-5, err_msg=k)
    (out_t["image"].sum() + out_t["depth"].sum()).backward()
    grad_j = jax.grad(lambda s: jnp.sum(render_j(s)["image"]) + jnp.sum(render_j(s)["depth"]))(
        jnp.float32(1.0))
    np.testing.assert_allclose(float(s.grad), float(grad_j), rtol=2e-4)


def test_staged_rendering_equals_one_shot():
    g, kw = _golden_inputs("ups")
    static = types.SimpleNamespace(bound=float(g["bound"]), bg_radius=-1.0)
    fns = _torch_fns(t(g["wg"]), t(g["wd"]))
    args = ({"s": torch.tensor(1.0)}, static, t(g["rays_o"]), t(g["rays_d"]))
    one = trend.render_rays(*args, perturb=False, train=False, field_fns=fns, **kw)
    N = g["rays_o"].shape[0]
    for batch in (5, N, 100):  # a ragged last chunk, one chunk, fewer rays than a chunk
        staged = trend.render_rays_staged(*args, max_ray_batch=batch, perturb=False,
                                          train=False, field_fns=fns, **kw)
        for k in ("image", "depth", "weights_sum"):
            np.testing.assert_allclose(n(staged[k]), n(one[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} batch {batch}")
    # per-ray noise is cut with the rays
    jitter = torch.rand(N, kw["num_steps"], generator=torch.Generator().manual_seed(0))
    u = torch.rand(N, kw["upsample_steps"], generator=torch.Generator().manual_seed(1))
    one = trend.render_rays(*args, perturb=True, jitter=jitter, u=u, field_fns=fns, **kw)
    staged = trend.render_rays_staged(*args, max_ray_batch=7, perturb=True, jitter=jitter,
                                      u=u, field_fns=fns, **kw)
    np.testing.assert_allclose(n(staged["image"]), n(one["image"]), rtol=1e-6, atol=1e-7)
    # and JAX's staged rendering of the same rays agrees
    out_j = jrend.render_rays_staged(
        {"s": jnp.float32(1.0)}, _AnalyticStatic(float(g["bound"])), jnp.asarray(g["rays_o"]),
        jnp.asarray(g["rays_d"]), max_ray_batch=7, perturb=False, train=False,
        field_fns=_analytic_fns(jnp.asarray(g["wg"]), jnp.asarray(g["wd"])), **kw)
    one = trend.render_rays(*args, perturb=False, train=False, field_fns=fns, **kw)
    np.testing.assert_allclose(n(one["image"]), np.asarray(out_j["image"]), atol=2e-5)
