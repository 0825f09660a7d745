"""Train state: params + Adam + LR schedule + EMA.

Counterpart of enerf_tpu/train/state.py (reference main_nerf.py:211-212):
Adam(betas=(0.9, 0.99), eps=1e-15) with lr(n) = lr0 * 0.1**min(n/iters, 1)
at the count n of updates before this one (optax's schedule count), and an
EMA shadow with the torch_ema warmup decay min(0.95, (1+n)/(10+n)).

One update rule for the per-step path and for a training window replayed
as a CUDA graph (train/chunk.py): the count of updates lives in a device
tensor (`count`, float64), and the learning rate, Adam's bias corrections
and the EMA decay are computed from it on the device, by `_foreach` ops
that read no host value.  A replayed graph therefore advances the
schedule, the bias corrections and the decay as eager steps do.  The
moments are allocated with the state (zeros), so their addresses never
change.  `step` is the same count as a host int, for the trainer's loop
and the checkpoints; a replayed window's caller advances it by K.
"""

import torch

BETA1, BETA2, EPS = 0.9, 0.99, 1e-15


class TrainState:
    """Leaf parameters (requires_grad), their Adam moments and EMA shadow."""

    def __init__(self, params, lr0, iters, ema_decay=0.95):
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.ema_params = {k: v.detach().clone() for k, v in params.items()}
        self.exp_avg = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(v) for k, v in self.params.items()}
        device = next(iter(self.params.values())).device
        self.count = torch.zeros((), dtype=torch.float64, device=device)
        self.step = 0
        self.lr0, self.iters, self.ema_decay = float(lr0), float(iters), ema_decay

    def lr(self):
        """The next update's learning rate, a float64 device scalar."""
        return self.lr0 * torch.pow(0.1, torch.clamp(self.count / self.iters, max=1.0))

    def set_count(self, count):
        """Put the schedule, the bias corrections and the EMA warmup at
        `count` updates done (a resumed checkpoint)."""
        self.count.fill_(float(count))

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def apply_updates(self):
        """One Adam step from the accumulated .grad (params without one are
        left alone, as torch.optim.Adam leaves them), then the EMA update of
        every param; the counts advance by one."""
        names = [k for k, p in self.params.items() if p.grad is not None]
        ps = [self.params[k] for k in names]
        gs = [p.grad for p in ps]
        ms = [self.exp_avg[k] for k in names]
        vs = [self.exp_avg_sq[k] for k in names]
        n = self.count
        t = n + 1.0
        step_size = (self.lr() / (1.0 - torch.pow(BETA1, t))).float()
        bc2_sqrt = torch.sqrt(1.0 - torch.pow(BETA2, t)).float()
        if ps:
            torch._foreach_lerp_(ms, gs, 1.0 - BETA1)
            torch._foreach_mul_(vs, BETA2)
            torch._foreach_addcmul_(vs, gs, gs, 1.0 - BETA2)
            denom = torch._foreach_sqrt(vs)
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, EPS)
            upd = torch._foreach_div(ms, denom)
            torch._foreach_mul_(upd, -step_size)
            torch._foreach_add_(ps, upd)
        d = torch.clamp((1.0 + n) / (10.0 + n), max=self.ema_decay).float()
        es = list(self.ema_params.values())
        torch._foreach_mul_(es, d)
        torch._foreach_add_(es, torch._foreach_mul(
            [p.detach() for p in self.params.values()], 1.0 - d))
        self.count.add_(1.0)
        self.step += 1
