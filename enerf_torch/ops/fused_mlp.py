"""Fused field head: kernel K1 (csrc/fused_field_head.cu) and its plain twin.

Counterpart of enerf_tpu/ops/fused_mlp.py.  `fused_field_head` computes the
whole sigma + colour head of the --ff backbone.  The implementation is
chosen by the device of the input alone: on a CPU tensor it runs the plain
PyTorch version `_head_math`; on a CUDA tensor it launches the hand-written
kernel (and raises if the launch fails).  The backward pass recomputes with
`_head_math` and autograd, with trunc_exp's clamped gradient, the same
design as the JAX custom VJP (which recomputes with plain XLA matmuls).
"""

import ctypes

import torch

from enerf_torch.ops.trunc_exp import trunc_exp

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HIDDEN = 64  # the kernel's instantiated hidden widths


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


def _check(enc, denc, ws0, ws1, wc0, wc1, wc2):
    ts = (enc, denc, ws0, ws1, wc0, wc1, wc2)
    if enc.dtype not in _DTYPE_CODE:
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
    return B, E, D, G, HS, HC, C


def _lib():
    from enerf_torch.ops.cuda_build import load_library
    lib = load_library("fused_field_head")
    fn = lib.fused_field_head_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_kernel(enc, denc, ws0, ws1, wc0, wc1, wc2):
    """Launch K1 on CUDA tensors -> (sigma [B], rgb [B, C]) f32."""
    B, E, D, G, HS, HC, C = _check(enc, denc, ws0, ws1, wc0, wc1, wc2)
    if not enc.is_cuda:
        raise ValueError("launch_kernel needs CUDA tensors")
    ops = [t.contiguous() for t in (enc, denc, ws0, ws1, wc0, wc1, wc2)]
    sigma = torch.empty(B, dtype=torch.float32, device=enc.device)
    rgb = torch.empty(B, C, dtype=torch.float32, device=enc.device)
    fn = _lib()
    with torch.cuda.device(enc.device):
        stream = torch.cuda.current_stream(enc.device).cuda_stream
        err = fn(_DTYPE_CODE[enc.dtype], *[t.data_ptr() for t in ops],
                 sigma.data_ptr(), rgb.data_ptr(), B, E, D, G, HS, HC, C, stream)
    if err != 0:
        raise RuntimeError(f"fused_field_head kernel launch failed: cudaError {err}")
    fused_field_head.launches += 1
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
