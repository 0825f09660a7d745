"""Truncated-gradient exponential density activation.

Counterpart of enerf_tpu/ops/trunc_exp.py (reference activation.py:5-18):
forward is exact exp; backward clamps the *input* to [-15, 15] before
exponentiating so huge densities do not produce inf gradients.
"""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)
