"""Train state: params + Adam + LR schedule + EMA.

Counterpart of enerf_tpu/train/state.py (reference main_nerf.py:211-212):
Adam(betas=(0.9, 0.99), eps=1e-15) with lr(step) = lr0 * 0.1**min(step/iters, 1)
evaluated at the step before the update (LambdaLR stepped once per update,
like optax's schedule count), and an EMA shadow with the torch_ema warmup
decay min(0.95, (1+n)/(10+n)) at the pre-increment step n.
"""

import torch


class TrainState:
    """Leaf parameters (requires_grad), their optimizer and EMA shadow."""

    def __init__(self, params, lr0, iters, ema_decay=0.95):
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.ema_params = {k: v.detach().clone() for k, v in params.items()}
        self.step = 0
        self.ema_decay = ema_decay
        self.opt = torch.optim.Adam(list(self.params.values()), lr=lr0,
                                    betas=(0.9, 0.99), eps=1e-15)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda s: 0.1 ** min(s / iters, 1.0))

    def set_schedule_count(self, count):
        """Put the LR schedule at `count` updates (a resumed checkpoint)."""
        self.sched.last_epoch = count
        lrs = [base * f(count) for base, f in zip(self.sched.base_lrs, self.sched.lr_lambdas)]
        for group, lr in zip(self.opt.param_groups, lrs):
            group["lr"] = lr
        self.sched._last_lr = lrs

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def apply_updates(self):
        """One Adam step from the accumulated .grad, then the EMA update."""
        self.opt.step()
        self.sched.step()
        n = float(self.step)
        d = min(self.ema_decay, (1.0 + n) / (10.0 + n))
        for k, p in self.params.items():
            self.ema_params[k].mul_(d).add_(p, alpha=1.0 - d)
        self.step += 1
