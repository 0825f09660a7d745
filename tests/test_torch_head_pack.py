"""The bf16 fused head's operand layout (ops/fused_mlp.pack_head) on the CPU.

Kernel K1's bf16 variant runs on the tensor cores, which the CPU cannot
run, so everything it assumes about its operands is made in Python and held
here: the zero padding of K and N, the geo matrix whose row 0 faces the
sigma column, the colour output padded to 8, and the order of the mma's B
fragments (against the PTX ISA's m16n8k16 tables).  A lane-by-lane
emulation of the kernel's warp program (ldmatrix, mma, the accumulator to
operand hand-over, the stores) computes the head from the packed weights
and is held to the plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n

from enerf_tpu.ops import fused_mlp as jfm
from enerf_torch.ops import fused_mlp as fm

E, G = 32, 15  # the main path's encoding and geo widths


def head_operands(B, C, D, dtype, seed=0, E=E):
    """enc [B, E], denc [B, D] in [-1, 1] and weights drawn like
    init_field_params (U(+-1/sqrt(fan_in)), [in, out] layout)."""
    rng = np.random.default_rng(seed)

    def u(shape, bound):
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))

    ws = [u((i, o), 1 / math.sqrt(i))
          for i, o in ((E, 64), (64, 1 + G), (D + G, 64), (64, 64), (64, C))]
    return [x.to(dtype) for x in [u((B, E), 1.0), u((B, D), 1.0)] + ws]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 15, 700])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("D", [16, 9])
def test_packed_head_equals_head_math(dtype, B, C, D):
    enc, denc, *ws = head_operands(B, C, D, getattr(torch, dtype), seed=B + C + D)
    pack = fm.pack_head(*ws)
    assert (pack.ke, pack.kd, pack.c) == (2, 1, C)
    assert pack.frags.numel() == (8 * (pack.ke + pack.kd) + 52) * 128  # the kernel's count
    s_p, c_p = fm.head_from_packed(enc, denc, pack)
    s_m, c_m = fm._head_math(enc, denc, *ws)
    # zero padding adds exact zeros to the same f32 sums: bit-exact
    assert torch.equal(s_p, s_m) and torch.equal(c_p, c_m)


@pytest.mark.parametrize("E,D,ke,kd", [(48, 9, 4, 1), (8, 25, 1, 2)])
def test_inputs_pad_to_an_instantiated_width(E, D, ke, kd):
    # the kernel is built for 16, 32 and 64 input columns
    enc, denc, *ws = head_operands(100, 3, D, torch.bfloat16, seed=3, E=E)
    pack = fm.pack_head(*ws)
    assert (pack.ke, pack.kd) == (ke, kd)
    s_p, c_p = fm.head_from_packed(enc, denc, pack)
    s_m, c_m = fm._head_math(enc, denc, *ws)
    assert torch.equal(s_p, s_m) and torch.equal(c_p, c_m)


def test_packed_head_matches_jax():
    enc, denc, *ws = head_operands(700, 3, 16, torch.float32, seed=1)
    s_p, c_p = fm.head_from_packed(enc, denc, fm.pack_head(*ws))
    s_j, c_j = jfm._head_math(*[jnp.asarray(n(x)) for x in [enc, denc] + ws])
    # f32: test_fused_mlp.py's forward tolerance
    np.testing.assert_allclose(n(s_p), np.asarray(s_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(c_p), np.asarray(c_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_infinite_sigma_leaves_geo_and_rgb_finite(dtype):
    enc, denc, ws0, ws1, wc0, wc1, wc2 = head_operands(64, 3, 16, getattr(torch, dtype))
    ws1 = ws1.clone()
    ws1[:, 0] = 3e38  # sigma_raw overflows to +inf wherever h is not all zero
    pack = fm.pack_head(ws0, ws1, wc0, wc1, wc2)
    s_p, c_p = fm.head_from_packed(enc, denc, pack)
    s_m, c_m = fm._head_math(enc, denc, ws0, ws1, wc0, wc1, wc2)
    assert torch.isinf(s_p).any() and torch.equal(s_p, s_m)
    assert torch.isfinite(c_p).all() and torch.equal(c_p, c_m)


@pytest.mark.parametrize("N,pair", [(32, 2), (8, 1)])
def test_fragment_order_is_the_mma_b_layout(N, pair):
    # PTX ISA, mma.m16n8k16 .bf16, B fragment: lane = 4 * groupID + tig
    # holds b_i at row k = 2 tig + (i & 1) + 8 (i >= 2), column n = groupID;
    # the kernel loads the operands of n-tiles 2p and 2p + 1 together
    K = 48
    w = torch.arange(K * N).reshape(K, N)
    f = fm.fragment_order(w).reshape(K // 16, N // (8 * pair), 32, pair, 4)
    for ks in range(K // 16):
        for nt in range(N // 8):
            for lane in range(32):
                g, tig = divmod(lane, 4)
                for i in range(4):
                    k = 16 * ks + 2 * tig + (i & 1) + 8 * (i >= 2)
                    assert f[ks, nt // pair, lane, nt % pair, i] == w[k, 8 * nt + g]
    assert torch.equal(fm.from_fragment_order(fm.fragment_order(w), K, N), w)


@pytest.mark.parametrize("C,D", [(1, 16), (3, 9)])
def test_pack_index_equals_direct_layout(C, D):
    ws = head_operands(1, C, D, torch.float32)[2:]
    direct = torch.cat([fm.fragment_order(w) for w in fm.padded_layers(*ws)])
    assert torch.equal(fm.pack_head(*ws).frags, direct)
    w0, w1, w2d, wgeo, w3, w4 = fm.padded_layers(*ws)
    assert (wgeo[0] == 0).all() and (wgeo[1 + G:] == 0).all()  # the sigma row, padding
    assert torch.equal(wgeo[1:1 + G], ws[2][D:]) and (w2d[D:] == 0).all()
    assert (w1[:, 1 + G:] == 0).all() and (w4[:, C:] == 0).all()


def test_bf16_kernel_refuses_wide_geo_and_inputs():
    enc, denc, ws0, _, _, wc1, wc2 = head_operands(4, 1, 16, torch.bfloat16)
    ws1 = torch.zeros(64, 17, dtype=torch.bfloat16)
    wc0 = torch.zeros(16 + 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="geo"):
        fm.fused_field_head(enc, denc, ws0, ws1, wc0, wc1, wc2)
    wide = head_operands(4, 1, 16, torch.bfloat16, E=80)
    with pytest.raises(ValueError, match="wide"):
        fm.fused_field_head(*wide)
    # the f32 kernel takes any geo width
    f32 = [x.float() for x in (enc, denc, ws0, ws1, wc0, wc1, wc2)]
    assert fm.fused_field_head(*f32)[1].shape == (4, 1)


# ------------------------------------------------ the kernel's warp program
# Lane-by-lane, after csrc/fused_field_head.cu:head_bf16_kernel.  Register
# pairs are [..., 2] (low half first); every rounding to bf16 is explicit.

LANE = torch.arange(32)
GID, TIG = LANE // 4, LANE % 4


def bf16(x):
    return x.to(torch.bfloat16).float()


def ldmatrix_x4(tile):
    """The kernel's load_a: lane l addresses row (l & 7) + 8 ((l >> 3) & 1),
    column 8 (l >> 4) of matrix m = l >> 3; ldmatrix gives each lane, from
    matrix m, row lane / 4, columns 2 (lane % 4) + {0, 1}, as register m."""
    regs = torch.empty(32, 4, 2)
    for m in range(4):
        rows, cols = GID + 8 * (m & 1), 8 * (m >> 1) + 2 * TIG
        regs[:, m, 0], regs[:, m, 1] = tile[rows, cols], tile[rows, cols + 1]
    return regs


def mma(acc, a, b):
    """acc [32, 4] += A (from a [32, 4, 2]) @ B (from b [32, 4]), by the PTX
    ISA's m16n8k16 tables: a_r holds (g + 8 (r & 1), 2 t + 8 (r >> 1) + {0, 1}),
    c holds (g, 2 t + {0, 1}) then (g + 8, 2 t + {0, 1})."""
    A, Bm, Cm = torch.zeros(16, 16), torch.zeros(16, 8), torch.zeros(16, 8)
    for r in range(4):
        rows, cols = GID + 8 * (r & 1), 2 * TIG + 8 * (r >> 1)
        A[rows, cols], A[rows, cols + 1] = a[:, r, 0], a[:, r, 1]
    for i in range(4):
        Bm[2 * TIG + (i & 1) + 8 * (i >> 1), GID] = b[:, i]
    for j in range(4):
        Cm[GID + 8 * (j >> 1), 2 * TIG + (j & 1)] = acc[:, j]
    Dm = (Cm.double() + A.double() @ Bm.double()).float()
    return torch.stack([Dm[GID + 8 * (j >> 1), 2 * TIG + (j & 1)] for j in range(4)], 1)


def pair(lo, hi):
    return torch.stack([bf16(lo), bf16(hi)], -1)


def relu_to_a(acc):
    """The kernel's relu_to_a: 8 n-tiles of accumulators -> 4 k-steps of A."""
    r = acc.clamp(min=0)
    return [torch.stack([pair(r[2 * kk][:, 0], r[2 * kk][:, 1]),
                         pair(r[2 * kk][:, 2], r[2 * kk][:, 3]),
                         pair(r[2 * kk + 1][:, 0], r[2 * kk + 1][:, 1]),
                         pair(r[2 * kk + 1][:, 2], r[2 * kk + 1][:, 3])], 1) for kk in range(4)]


def b_operand(frags, first, n_tiles, ks, nt):
    """The [32, 4] B operand the kernel's lanes load for n-tile nt of k-step
    ks of the layer whose fragments start at `first`: the operands of
    n-tiles 2p and 2p + 1 are one 16-byte load per lane (a lone n-tile, 8)."""
    pair = 2 if n_tiles % 2 == 0 else 1
    start = (first + ks * n_tiles + nt - nt % pair) * 128
    return frags[start:start + 128 * pair].reshape(32, pair, 4)[:, nt % pair]


def emulate_k1_bf16(enc, denc, pack):
    """(sigma [B], rgb [B, C]) as the kernel's warps compute them."""
    B = enc.shape[0]
    ke, kd, C = pack.ke, pack.kd, pack.c
    frags = pack.frags.float()

    def frag(first, n_tiles, ks, nt):
        return b_operand(frags, first, n_tiles, ks, nt)

    F1, F2d = 8 * ke, 8 * ke + 8
    F2g = F2d + 8 * kd
    F3, F4 = F2g + 8, F2g + 40
    tiles = -(-B // 16)
    x_enc = torch.zeros(16 * tiles, 16 * ke)  # rows past B are zero-filled
    x_dir = torch.zeros(16 * tiles, 16 * kd)
    x_enc[:B, :enc.shape[1]], x_dir[:B, :denc.shape[1]] = enc.float(), denc.float()
    sigma, rgb = torch.full((B,), float("nan")), torch.full((B, C), float("nan"))
    for tile in range(tiles):
        rows = slice(16 * tile, 16 * tile + 16)
        acc = torch.zeros(8, 32, 4)
        for ks in range(ke):
            a = ldmatrix_x4(x_enc[rows, 16 * ks:16 * ks + 16])
            for nt in range(8):
                acc[nt] = mma(acc[nt], a, frag(0, 8, ks, nt))
        h = relu_to_a(acc)
        sg = torch.zeros(2, 32, 4)
        for kk in range(4):
            for nt in range(2):
                sg[nt] = mma(sg[nt], h[kk], frag(F1, 2, kk, nt))
        col0 = TIG == 0
        zero = torch.zeros(32)
        geo = torch.stack([pair(torch.where(col0, zero, sg[0][:, 0]), sg[0][:, 1]),
                           pair(torch.where(col0, zero, sg[0][:, 2]), sg[0][:, 3]),
                           pair(sg[1][:, 0], sg[1][:, 1]), pair(sg[1][:, 2], sg[1][:, 3])], 1)
        acc = torch.zeros(8, 32, 4)
        for ks in range(kd):
            a = ldmatrix_x4(x_dir[rows, 16 * ks:16 * ks + 16])
            for nt in range(8):
                acc[nt] = mma(acc[nt], a, frag(F2d, 8, ks, nt))
        for nt in range(8):
            acc[nt] = mma(acc[nt], geo, frag(F2g, 8, 0, nt))
        c = relu_to_a(acc)
        acc = torch.zeros(8, 32, 4)
        for kk in range(4):
            for nt in range(8):
                acc[nt] = mma(acc[nt], c[kk], frag(F3, 8, kk, nt))
        c = relu_to_a(acc)
        o = torch.zeros(32, 4)
        for kk in range(4):
            o = mma(o, c[kk], frag(F4, 1, kk, 0))
        for lane in range(32):
            g, tig = divmod(lane, 4)
            for half, r in enumerate((16 * tile + g, 16 * tile + g + 8)):
                if r >= B:
                    continue
                if tig == 0:
                    sigma[r] = torch.exp(sg[0][lane, 2 * half])
                for j in range(2):
                    if 2 * tig + j < C:
                        rgb[r, 2 * tig + j] = torch.sigmoid(o[lane, 2 * half + j])
    return sigma, rgb


@pytest.mark.parametrize("B,C,D", [(40, 1, 16), (19, 3, 9)])
def test_warp_program_computes_the_head(B, C, D):
    enc, denc, *ws = head_operands(B, C, D, torch.bfloat16, seed=7)
    s_k, c_k = emulate_k1_bf16(enc, denc, fm.pack_head(*ws))
    s_p, c_p = fm.head_reference(enc, denc, *ws)
    assert torch.isfinite(s_k).all() and torch.isfinite(c_k).all()
    # K1's bf16 tolerance (chip_smoke.py): another summation order can flip a
    # bf16 rounding, and the flip propagates
    torch.testing.assert_close(s_k, s_p, rtol=3e-2, atol=1e-6)
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-2)


def test_launch_packed_checks_operands():
    enc, denc, *ws = head_operands(4, 1, 16, torch.bfloat16)
    pack = fm.pack_head(*ws)
    with pytest.raises(ValueError, match="CUDA"):
        fm.launch_packed(enc, denc, pack)  # the kernel needs CUDA tensors
