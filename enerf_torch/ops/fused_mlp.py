"""Fused field head: kernel K1 (csrc/fused_field_head.cu) and its plain twin.

Counterpart of enerf_tpu/ops/fused_mlp.py.  `fused_field_head` computes the
whole sigma + colour head of the --ff backbone.  The implementation is
chosen by the device of the input alone: on a CPU tensor it runs the plain
PyTorch version `_head_math`; on a CUDA tensor it launches the hand-written
kernel (and raises if the launch fails).  The backward pass recomputes with
`_head_math` and autograd, with trunc_exp's clamped gradient, the same
design as the JAX custom VJP (which recomputes with plain XLA matmuls).

The bf16 kernel runs the five products on the tensor cores (mma.sync
m16n8k16).  Its operand layout is made here, in `pack_head`: the weights
zero-padded to the mma's K (16) and N (8), the geo rows of the colour net's
first layer as a 16-row matrix whose row 0 (the sigma column) is zero, the
colour output padded to 8 columns, and every B fragment in the order the
kernel's lanes read it.  `head_from_packed` computes the head from that
layout with plain PyTorch, so the CPU tests can hold the layout to
`_head_math`.
"""

import ctypes
from collections import namedtuple
from functools import lru_cache

import torch
import torch.nn.functional as F

from enerf_torch.ops.trunc_exp import trunc_exp

DTYPES = (torch.float32, torch.bfloat16)
HIDDEN = 64     # the kernel's instantiated hidden widths
SIGMA_GEO = 16  # sigma + geo columns of the bf16 kernel: two n-tiles, so G <= 15
C_PAD = 8       # the colour output of the bf16 kernel: one n-tile
K_STEPS = (1, 2, 4)  # the bf16 kernel's instantiated enc / denc widths, in 16-column k-steps


def _mm(a, w):
    """jnp.dot(a, w, preferred_element_type=f32): the product of the
    (possibly bf16) inputs, accumulated and returned in f32, unrounded."""
    return a.float() @ w.float()


def _head_math(enc, denc, ws0, ws1, wc0, wc1, wc2):
    """The head's forward math: (sigma_raw [B] f32, rgb [B, C] f32).
    Activations are rounded to the input dtype after each ReLU and the geo
    features before the colour net, as in enerf_tpu's _head_math."""
    dt = enc.dtype
    h = torch.relu(_mm(enc, ws0)).to(dt)
    sg = _mm(h, ws1)
    sigma_raw = sg[:, 0]
    geo = sg[:, 1:].to(dt)
    c = torch.relu(_mm(torch.cat([denc, geo], dim=-1), wc0)).to(dt)
    c = torch.relu(_mm(c, wc1)).to(dt)
    return sigma_raw, torch.sigmoid(_mm(c, wc2))


def head_reference(enc, denc, ws0, ws1, wc0, wc1, wc2):
    """The plain version of the whole kernel: (sigma [B], rgb [B, C])."""
    sigma_raw, rgb = _head_math(enc, denc, ws0, ws1, wc0, wc1, wc2)
    return torch.exp(sigma_raw), rgb


# ------------------------------------------------ the bf16 kernel's operands

HeadPack = namedtuple("HeadPack", "frags ke kd c")
HeadPack.__doc__ = """Weights in the bf16 kernel's layout: `frags` the B
fragments of the six products, in order, [8 (ke + kd) + 52 fragments x 128];
enc padded to 16 ke columns, denc to 16 kd, C colour outputs."""


def k_steps(n):
    """The k-steps of an input n wide: ceil(n / 16), rounded up to an
    instantiated count (the input is zero-padded to 16 times that)."""
    return next(k for k in K_STEPS if 16 * k >= n)


def padded_layers(ws0, ws1, wc0, wc1, wc2, fill=0):
    """The bf16 kernel's six products as [K, N] matrices ([in, out]), K a
    multiple of 16 and N of 8, every added entry `fill` (E16 = 16 k_steps(E)):
      [E16, 64]  enc @ ws0
      [64, 16]   h @ ws1: sigma and the G geo columns, then padding
      [D16, 64]  denc @ wc0[:D]
      [16, 64]   geo16 @ wgeo: row 0 faces the sigma column and is padding,
                 rows 1..G are wc0[D:], the rest padding
      [64, 64]   c @ wc1
      [64, 8]    c @ wc2, C padded to 8."""
    E, S1, C = ws0.shape[0], ws1.shape[1], wc2.shape[1]
    D = wc0.shape[0] - (S1 - 1)

    def pad(w, k, n):
        out = w.new_full((k, n), fill)
        out[:w.shape[0], :w.shape[1]] = w
        return out

    wgeo = wc0.new_full((SIGMA_GEO, HIDDEN), fill)
    wgeo[1:S1] = wc0[D:]
    return [pad(ws0, 16 * k_steps(E), HIDDEN), pad(ws1, HIDDEN, SIGMA_GEO),
            pad(wc0[:D], 16 * k_steps(D), HIDDEN), wgeo, wc1, pad(wc2, HIDDEN, C_PAD)]


def _layer_shapes(ke, kd):
    return [(16 * ke, HIDDEN), (HIDDEN, SIGMA_GEO), (16 * kd, HIDDEN), (SIGMA_GEO, HIDDEN),
            (HIDDEN, HIDDEN), (HIDDEN, C_PAD)]


def _pair(N):
    """n-tiles whose B operands a lane loads together: 2 (16 bytes) when N
    holds an even number of 8-column n-tiles, else 1."""
    return 2 if N % 16 == 0 else 1


def fragment_order(w):
    """[K, N] -> flat, the B operands of mma.m16n8k16 in the kernel's order:
    k-step ks, then pairs of n-tiles (P = _pair(N) n-tiles each), then lane
    l = 4 g + t, then the pair's n-tile p, then 4 values j, where lane l
    holds w[16 ks + 8 (j // 2) + 2 t + j % 2, 8 (P np + p) + g]."""
    K, N = w.shape
    P = _pair(N)
    return (w.reshape(K // 16, 2, 4, 2, N // (8 * P), P, 8)
            .permute(0, 4, 6, 2, 5, 1, 3).reshape(-1))


def from_fragment_order(f, K, N):
    """The inverse of fragment_order: flat fragments -> [K, N]."""
    P = _pair(N)
    return (f.reshape(K // 16, N // (8 * P), 8, 4, P, 2, 2)
            .permute(0, 5, 3, 6, 1, 4, 2).reshape(K, N))


@lru_cache(maxsize=None)
def _pack_index(E, D, G, C, device):
    """For each packed value, its index into cat(flat ws0..wc2, [0])."""
    shapes = [(E, HIDDEN), (HIDDEN, 1 + G), (D + G, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, C)]
    sizes = [k * n for k, n in shapes]
    flat = torch.arange(sum(sizes))
    ws = [p.view(s) for p, s in zip(flat.split(sizes), shapes)]
    layers = padded_layers(*ws, fill=sum(sizes))  # padding reads the appended zero
    return torch.cat([fragment_order(w) for w in layers]).to(device)


@lru_cache(maxsize=None)
def _zero(device, dtype):
    return torch.zeros(1, device=device, dtype=dtype)


def pack_head(ws0, ws1, wc0, wc1, wc2):
    """The weights in the bf16 kernel's layout (a HeadPack): one cat and one
    gather through a cached index map."""
    E, G, C = ws0.shape[0], ws1.shape[1] - 1, wc2.shape[1]
    D = wc0.shape[0] - G
    flat = torch.cat([w.reshape(-1) for w in (ws0, ws1, wc0, wc1, wc2)]
                     + [_zero(ws0.device, ws0.dtype)])
    frags = flat.index_select(0, _pack_index(E, D, G, C, ws0.device))
    return HeadPack(frags, k_steps(E), k_steps(D), C)


def _pad_cols(x, width):
    return x if x.shape[1] == width else F.pad(x, (0, width - x.shape[1]))


def head_from_packed(enc, denc, pack):
    """The head computed from the kernel's operand layout with plain
    PyTorch: (sigma_raw [B] f32, rgb [B, C] f32), rounded where _head_math
    rounds.  The sigma column is zeroed before geo16 is an operand (a zero
    weight row would turn an infinite sigma_raw into NaN)."""
    sizes = [k * n for k, n in _layer_shapes(pack.ke, pack.kd)]
    w0, w1, w2d, wgeo, w3, w4 = [
        from_fragment_order(f, k, n)
        for f, (k, n) in zip(pack.frags.split(sizes), _layer_shapes(pack.ke, pack.kd))]
    dt = enc.dtype
    h = torch.relu(_mm(_pad_cols(enc, w0.shape[0]), w0)).to(dt)
    sg = _mm(h, w1)
    geo16 = torch.cat([torch.zeros_like(sg[:, :1]), sg[:, 1:]], dim=-1).to(dt)
    cin = torch.cat([_pad_cols(denc, w2d.shape[0]), geo16], dim=-1)
    c = torch.relu(_mm(cin, torch.cat([w2d, wgeo]))).to(dt)
    c = torch.relu(_mm(c, w3)).to(dt)
    # the kernel stores the first C of the 8 columns; each column is its own
    # sum, so the product keeps only those (and the plain version's shape)
    return sg[:, 0], torch.sigmoid(_mm(c, w4[:, :pack.c]))


# ------------------------------------------------------------------ wrapper

def _check(enc, denc, ws0, ws1, wc0, wc1, wc2):
    ts = (enc, denc, ws0, ws1, wc0, wc1, wc2)
    if enc.dtype not in DTYPES:
        raise TypeError(f"fused_field_head takes float32 or bfloat16, got {enc.dtype}")
    if any(t.dtype != enc.dtype or t.device != enc.device or t.dim() != 2 for t in ts):
        raise ValueError("fused_field_head: all operands must be 2-D, of one "
                         "dtype and on one device")
    B, E = enc.shape
    D, HS, S1, HC = denc.shape[1], ws0.shape[1], ws1.shape[1], wc0.shape[1]
    G, C = S1 - 1, wc2.shape[1]
    if (denc.shape[0] != B or ws0.shape[0] != E or ws1.shape[0] != HS
            or wc0.shape[0] != D + G or wc1.shape != (HC, HC) or wc2.shape[0] != HC):
        raise ValueError("fused_field_head: inconsistent operand shapes "
                         f"{[tuple(t.shape) for t in ts]}")
    if HS != HIDDEN or HC != HIDDEN:
        raise ValueError(f"fused_field_head kernel has hidden width {HIDDEN}, "
                         f"got sigma {HS} / colour {HC}")
    if C not in (1, 3):
        raise ValueError(f"fused_field_head: colour width must be 1 or 3, got {C}")
    if enc.dtype == torch.bfloat16 and S1 > SIGMA_GEO:
        raise ValueError(f"fused_field_head's bf16 kernel takes at most {SIGMA_GEO - 1} geo "
                         f"features, got {G}")
    if enc.dtype == torch.bfloat16 and max(E, D) > 16 * K_STEPS[-1]:
        raise ValueError(f"fused_field_head's bf16 kernel takes inputs at most "
                         f"{16 * K_STEPS[-1]} wide, got enc {E} and denc {D}")
    return B, E, D, G, HS, HC, C


def _lib(name, n_ptr, n_int):
    from enerf_torch.ops.cuda_build import load_library
    fn = getattr(load_library("fused_field_head"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(fn, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_field_head kernel launch failed: cudaError {err}")
    fused_field_head.launches += 1


def launch_packed(enc, denc, pack):
    """Launch K1's bf16 kernel on CUDA tensors with weights from pack_head ->
    (sigma [B], rgb [B, C]) f32.  B = 0 launches nothing."""
    if not enc.is_cuda:
        raise ValueError("launch_packed needs CUDA tensors")
    B = enc.shape[0]
    n_frag = 8 * (pack.ke + pack.kd) + 52
    if (any(t.dtype != torch.bfloat16 or t.device != enc.device for t in (denc, pack.frags))
            or enc.dtype != torch.bfloat16 or enc.dim() != 2 or denc.dim() != 2
            or denc.shape[0] != B or enc.shape[1] > 16 * pack.ke
            or denc.shape[1] > 16 * pack.kd or pack.frags.shape != (n_frag * 128,)):
        raise ValueError("launch_packed: bf16 enc [B, <= 16 ke], denc [B, <= 16 kd] and "
                         "pack_head's fragments on one device")
    enc = _pad_cols(enc, 16 * pack.ke).contiguous()
    denc = _pad_cols(denc, 16 * pack.kd).contiguous()
    if any(t.data_ptr() % 16 for t in (enc, denc, pack.frags)):
        raise ValueError("fused_field_head: the bf16 kernel needs 16-byte aligned operands")
    sigma = torch.empty(B, dtype=torch.float32, device=enc.device)
    rgb = torch.empty(B, pack.c, dtype=torch.float32, device=enc.device)
    if B:
        _launch(_lib("fused_field_head_bf16_launch", 5, 4), enc.device, enc.data_ptr(),
                denc.data_ptr(), pack.frags.data_ptr(), sigma.data_ptr(), rgb.data_ptr(),
                B, pack.ke, pack.kd, pack.c)
    return sigma, rgb


def launch_kernel(enc, denc, ws0, ws1, wc0, wc1, wc2):
    """Launch K1 on CUDA tensors -> (sigma [B], rgb [B, C]) f32: the tensor-
    core kernel for bf16, the CUDA-core kernel for f32."""
    B, E, D, G, HS, HC, C = _check(enc, denc, ws0, ws1, wc0, wc1, wc2)
    if not enc.is_cuda:
        raise ValueError("launch_kernel needs CUDA tensors")
    if enc.dtype == torch.bfloat16:
        return launch_packed(enc, denc, pack_head(ws0, ws1, wc0, wc1, wc2))
    ops = [t.contiguous() for t in (enc, denc, ws0, ws1, wc0, wc1, wc2)]
    sigma = torch.empty(B, dtype=torch.float32, device=enc.device)
    rgb = torch.empty(B, C, dtype=torch.float32, device=enc.device)
    if B:
        _launch(_lib("fused_field_head_f32_launch", 9, 7), enc.device,
                *[t.data_ptr() for t in ops], sigma.data_ptr(), rgb.data_ptr(),
                B, E, D, G, HS, HC, C)
    return sigma, rgb


class _FusedFieldHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, denc, ws0, ws1, wc0, wc1, wc2):
        ctx.save_for_backward(enc, denc, ws0, ws1, wc0, wc1, wc2)
        if enc.is_cuda:
            return launch_kernel(enc, denc, ws0, ws1, wc0, wc1, wc2)
        _check(enc, denc, ws0, ws1, wc0, wc1, wc2)
        return head_reference(enc, denc, ws0, ws1, wc0, wc1, wc2)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            sigma_raw, rgb = _head_math(*xs)
            sigma = trunc_exp(sigma_raw)
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad((sigma, rgb), wrt, (g_sigma, g_rgb),
                                             allow_unused=True))
        return tuple(next(grads) if n else None for n in need)


def fused_field_head(enc, denc, ws0, ws1, wc0, wc1, wc2):
    """(enc [B, E], denc [B, D], bias-free weights in [in, out] layout) ->
    (sigma [B], rgb [B, C]) f32.  Kernel on CUDA tensors, plain on CPU."""
    return _FusedFieldHead.apply(enc, denc, ws0, ws1, wc0, wc1, wc2)


fused_field_head.launches = 0  # kernel launches (CUDA path only)
