"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so on a machine without it they run with the JAX suite's conftest
left out:

    python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -q
"""

import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch.ops import fused_mlp, group_gather, scatter_accum
from enerf_torch.ops.blockgrid import BlockGridMeta


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_twin_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    B = 70_000  # not a multiple of the 128-thread block

    def rnd(*shape, scale=1.0):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1).mul(scale).to(dt)

    args = (rnd(B, 32), rnd(B, 16), rnd(32, 64, scale=0.18), rnd(64, 16, scale=0.125),
            rnd(31, 64, scale=0.18), rnd(64, 64, scale=0.125), rnd(64, 1, scale=0.125))
    before = fused_mlp.fused_field_head.launches
    s_k, c_k = fused_mlp.fused_field_head(*args)
    torch.cuda.synchronize()
    assert fused_mlp.fused_field_head.launches == before + 1
    s_p, c_p = fused_mlp.head_reference(*args)
    if dt == torch.float32:
        # same f32 math, other summation order
        torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(c_k, c_p, rtol=1e-4, atol=1e-6)
    else:
        # bf16 rounding flips from the summation order (see the bf16 test)
        torch.testing.assert_close(s_k, s_p, rtol=3e-2, atol=1e-6)
        torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-2)


def _head_args(B, C, D, dtype, seed=0, E=32):
    """K1's operands on the card (G 15, hidden 64; the main path's E is 32)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1).mul(scale).to(dtype)

    return [rnd(B, E), rnd(B, D), rnd(E, 64, scale=0.18), rnd(64, 16, scale=0.125),
            rnd(D + 15, 64, scale=0.18), rnd(64, 64, scale=0.125), rnd(64, C, scale=0.125)]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [0, 1, 15, 70_000, 131_072])
@pytest.mark.parametrize("C", [1, 3])
def test_bf16_head_ragged_batches_on_card(B, C):
    """The tensor-core kernel masks a batch that is not a multiple of its
    16-sample tiles (or of a block's tiles); B = 0 launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    args = _head_args(B, C, 16, torch.bfloat16, seed=B + C)
    before = fused_mlp.fused_field_head.launches
    s_k, c_k = fused_mlp.fused_field_head(*args)
    torch.cuda.synchronize()
    assert fused_mlp.fused_field_head.launches == before + (B > 0)
    assert s_k.shape == (B,) and c_k.shape == (B, C)
    s_p, c_p = fused_mlp.head_reference(*args)
    torch.testing.assert_close(s_k, s_p, rtol=3e-2, atol=1e-6)
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("E", [32, 48])
def test_bf16_head_padded_widths_and_infinite_sigma_on_card(E):
    """D = 9 (SH degree 3) is zero-padded to 16 and E = 48 to 64 by the
    wrapper; an infinite sigma_raw must not reach the colour net (its column
    is zeroed before the geo features become an operand)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    args = _head_args(1000, 3, 9, torch.bfloat16, seed=5, E=E)
    args[3] = args[3].clone()
    args[3][:, 0] = 3e38
    s_k, c_k = fused_mlp.fused_field_head(*args)
    torch.cuda.synchronize()
    s_p, c_p = fused_mlp.head_reference(*args)
    assert torch.isinf(s_k).any() and torch.isinf(s_p).any()
    assert torch.isfinite(c_k).all()
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [4, 3])
def test_table_grad_kernel_matches_twin_on_card(block):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(1)
    meta = BlockGridMeta(num_levels=16, level_dim=2, block=block)
    B = 70_000  # samples; x 16 levels, not a multiple of the 256-thread block
    x = torch.rand(B, 3, device="cuda", generator=g)
    g_out = torch.randn(B, 32, device="cuda", generator=g)
    pairs = scatter_accum.pair_inputs(x, g_out, meta)
    before = scatter_accum.block_table_grad.launches
    got = scatter_accum.block_table_grad(*pairs, meta.total_rows, meta)
    torch.cuda.synchronize()
    assert scatter_accum.block_table_grad.launches == before + 1
    rid, lo, frac, gg = pairs
    ref64 = scatter_accum.block_table_grad_reference(*pairs, meta.total_rows, meta,
                                                     dtype=torch.float64)
    mag = scatter_accum.block_table_grad_reference(rid, lo, frac, gg.abs(), meta.total_rows,
                                                   meta, dtype=torch.float64)
    # atomics sum in any order: per cell within 1e-5 of the sum of the
    # addends' magnitudes (plus 1e-7), against float64; the f32 twin too
    bound = 1e-5 * mag + 1e-7
    assert ((got.double() - ref64).abs() <= bound).all()
    assert (got[mag == 0] == 0).all()  # cells with no addend stay exactly zero
    twin = scatter_accum.block_table_grad_reference(*pairs, meta.total_rows, meta)
    assert ((twin.double() - ref64).abs() <= bound).all()


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,groups,windows", [(1024, 128, 5000, 4), (97824, 250, 70_001, 8),
                                                   (64, 1, 33, 16), (80, 3, 1, 1),
                                                   # more groups than the persistent grid's
                                                   # blocks x stages; the largest ring
                                                   (2048, 64, 200_003, 4),
                                                   (97824, 250, 70_001, 16),
                                                   # 16 slices of the walk, spans of 2 chunks
                                                   (32768, 1000, 5000, 8)])
def test_group_gather_kernel_matches_twin_on_card(rows, d, groups, windows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(2)
    table = torch.randn(rows, d, device="cuda", generator=g)
    gidx = torch.randint(0, rows // 8, (groups,), device="cuda", generator=g,
                         dtype=torch.int32)
    before = group_gather.group_gather.launches
    got = group_gather.group_gather(gidx, table, windows)
    torch.cuda.synchronize()
    assert group_gather.group_gather.launches == before + 1
    # a copy: bit-exact
    assert torch.equal(got, group_gather.group_gather_reference(gidx, table))
