"""Parity of the port's field and fused head (kernel K1's plain path) with
enerf_tpu's field_forward_fused: the three checks of test_fused_mlp.py plus
the bf16 path.  K1 itself is checked on the card by test_torch_kernels.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import n, params_np, t, unit_dirs

from enerf_tpu.models import field as jfield
from enerf_torch.convert import params_from_jax
from enerf_torch.models import field as tfield
from enerf_torch.ops import fused_mlp


def setup(bf16=False, out_dim_color=3):
    kw = dict(bound=1.0, out_dim_color=out_dim_color, num_levels=4,
              log2_hashmap_size=10, encoding="blockgrid", use_fused_head=True)
    sj = jfield.FieldStatic(compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw)
    st = tfield.FieldStatic(compute_dtype=torch.bfloat16 if bf16 else torch.float32, **kw)
    pj = jfield.init_field_params(jax.random.PRNGKey(0), sj)
    # a table of realistic (trained) scale, so the encoding matters
    rng = np.random.default_rng(0)
    pj["hash_table"] = jnp.asarray(
        rng.uniform(-0.5, 0.5, pj["hash_table"].shape).astype(np.float32))
    x = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    d = unit_dirs(rng, 700)
    return sj, st, pj, params_from_jax(params_np(pj)), x, d


def test_fused_forward_matches_jax():
    sj, st, pj, pt, x, d = setup()
    s_j, c_j = jfield.field_forward_fused(pj, sj, jnp.asarray(x), jnp.asarray(d))
    launches = fused_mlp.fused_field_head.launches
    s_t, c_t = tfield.field_forward_fused(pt, st, t(x), t(d))
    assert fused_mlp.fused_field_head.launches == launches  # CPU: plain path
    # f32 end to end: test_fused_mlp.py's forward tolerance
    np.testing.assert_allclose(n(s_t), np.asarray(s_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(c_t), np.asarray(c_j), rtol=1e-5, atol=1e-6)
    # the unfused port path computes the same function
    s_u, c_u = tfield.field_forward(pt, st, t(x), t(d))
    np.testing.assert_allclose(n(s_u), n(s_t), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(c_u), n(c_t), rtol=1e-5, atol=1e-6)


def test_fused_gradients_match_jax():
    sj, st, pj, pt, x, d = setup()

    def loss_j(p):
        s, c = jfield.field_forward_fused(p, sj, jnp.asarray(x), jnp.asarray(d))
        return jnp.mean(s) + jnp.sum(c ** 2)

    g_j = jax.grad(loss_j)(pj)
    pt = {k: v.requires_grad_(True) for k, v in pt.items()}
    s, c = tfield.field_forward_fused(pt, st, t(x), t(d))
    (s.mean() + (c ** 2).sum()).backward()
    for k in g_j:
        # test_fused_mlp.py's gradient tolerance
        np.testing.assert_allclose(n(pt[k].grad), np.asarray(g_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=f"grad mismatch for {k}")


def test_fused_trunc_exp_grad_clamped():
    """Sigma logits above 15 must give trunc_exp's clamped, finite grads."""
    sj, st, pj, pt, x, d = setup()
    pt = dict(pt)
    pt["sigma_w1"] = pt["sigma_w1"].clone()
    pt["sigma_w1"][:, 0] *= 4000.0
    pt = {k: v.requires_grad_(True) for k, v in pt.items()}
    s, _ = tfield.field_forward_fused(pt, st, t(x), t(d))
    assert (n(s) > np.exp(15.0)).any()  # the clamp is exercised
    s.sum().backward()
    for k, v in pt.items():
        assert np.isfinite(n(v.grad)).all(), f"non-finite grad in {k}"


def test_fused_forward_bf16_matches_jax():
    sj, st, pj, pt, x, d = setup(bf16=True, out_dim_color=1)
    s_j, c_j = jfield.field_forward_fused(pj, sj, jnp.asarray(x), jnp.asarray(d))
    s_t, c_t = tfield.field_forward_fused(pt, st, t(x), t(d))
    # Both round to bf16 at the same points, but f32 sums taken in another
    # order can land on the other side of a bf16 rounding (one bf16 ulp is
    # 2^-8 relative) and that flip propagates: sigma = exp(logit) moves by
    # <= 3% relative, the sigmoid output by <= 1e-2 absolute.
    np.testing.assert_allclose(n(s_t), np.asarray(s_j), rtol=3e-2, atol=1e-6)
    np.testing.assert_allclose(n(c_t), np.asarray(c_j), rtol=0, atol=1e-2)


def test_fused_head_checks_operands():
    enc = torch.zeros(4, 32)
    ws = [torch.zeros(32, 64), torch.zeros(64, 16), torch.zeros(31, 64),
          torch.zeros(64, 64), torch.zeros(64, 1)]
    with pytest.raises(TypeError):
        fused_mlp.fused_field_head(enc.double(), torch.zeros(4, 16).double(),
                                   *[w.double() for w in ws])
    with pytest.raises(ValueError):
        fused_mlp.fused_field_head(enc, torch.zeros(4, 15), *ws)
