"""Optimizers and epoch-indexed LR schedules (counterpart of
``nerfmatch_tpu/utils/optim.py``) on ``torch.optim``.

sgd / adam / adamw / rmsprop / radam, and ranger as RAdam inside a
Lookahead wrapper (k=6, alpha=0.5).  Weight decay is coupled L2 (added to
the gradient before the update, as ``optax.add_decayed_weights`` chained
first) for every optimizer but adamw, whose decay is decoupled.  Schedules
are the JAX package's pure functions ``f(epoch) -> lr``; the trainer sets
the learning rate once per epoch with :func:`set_lr`.
"""

from __future__ import annotations

import math

import torch


class Lookahead(torch.optim.Optimizer):
    """Lookahead around an inner optimizer: every ``sync_period`` steps the
    slow weights move ``slow_step_size`` of the way to the fast ones and the
    fast weights are reset to them.  Shares the inner param groups, so
    :func:`set_lr` reaches the inner optimizer."""

    def __init__(self, inner, sync_period: int = 6,
                 slow_step_size: float = 0.5):
        self.inner = inner
        self.sync_period = sync_period
        self.slow_step_size = slow_step_size
        self.param_groups = inner.param_groups
        self.defaults = inner.defaults
        self.state = inner.state
        self._slow = [[p.detach().clone() for p in g["params"]]
                      for g in self.param_groups]
        self._step = 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = self.inner.step(closure)
        self._step += 1
        if self._step % self.sync_period == 0:
            for group, slow in zip(self.param_groups, self._slow):
                for p, s in zip(group["params"], slow):
                    s.add_(p - s, alpha=self.slow_step_size)
                    p.copy_(s)
        return loss

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none)

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "slow": self._slow,
                "step": self._step}

    def load_state_dict(self, state):
        self.inner.load_state_dict(state["inner"])
        self._slow = [[s.to(p.device) for s, p in zip(slow, g["params"])]
                      for slow, g in zip(state["slow"], self.param_groups)]
        self._step = state["step"]


def init_optimizer(config, params, lr: float | None = None):
    """torch optimizer over ``params`` (an iterable or param groups)."""
    name = config.optimizer
    eps = float(getattr(config, "eps", 1e-8))
    wd = float(getattr(config, "weight_decay", 0.0))
    lr = float(lr if lr is not None else config.lr)
    if name == "sgd":
        # optax.sgd's momentum is torch's (trace = g + m * trace).
        return torch.optim.SGD(params, lr=lr, weight_decay=wd,
                               momentum=float(getattr(config, "momentum", 0.9)))
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, eps=eps, weight_decay=wd)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, eps=eps, weight_decay=wd)
    if name == "rmsprop":
        # optax.rmsprop: decay 0.9, eps inside the sqrt.
        return _OptaxRMSprop(params, lr=lr, eps=eps, weight_decay=wd)
    if name in ("radam", "ranger"):
        opt = torch.optim.RAdam(params, lr=lr, eps=eps, weight_decay=wd)
        return Lookahead(opt) if name == "ranger" else opt
    raise ValueError(f"optimizer not recognized: {name}")


class _OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` (decay 0.9, ``g / sqrt(nu + eps)``, nu starting at
    0), with coupled L2 weight decay."""

    def __init__(self, params, lr, eps=1e-8, decay=0.9, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, eps=eps, decay=decay,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(group["decay"]).addcmul_(g, g, value=1 - group["decay"])
                p.addcdiv_(g, torch.sqrt(nu + group["eps"]),
                           value=-group["lr"])


def get_lr(opt) -> float:
    return float(opt.param_groups[0]["lr"])


def set_lr(opt, lr: float):
    for g in opt.param_groups:
        g["lr"] = float(lr)
    return opt


def make_lr_schedule(config, base_lr: float | None = None):
    """``f(epoch) -> lr`` for the configured scheduler (or None)."""
    name = getattr(config, "lr_scheduler", None)
    if name is None:
        return None
    base_lr = float(base_lr if base_lr is not None else config.lr)
    max_epochs = int(getattr(config, "max_epochs", 1))

    if name == "steplr":
        if getattr(config, "decay_per_step", None) and config.decay_per_step > 0:
            step = int(config.decay_per_step)
            milestones = list(range(step, max_epochs, step))
        else:
            milestones = list(config.decay_step)
        gamma = float(config.decay_gamma)

        def sched(epoch):
            return base_lr * gamma ** sum(1 for m in milestones if epoch >= m)

    elif name == "cosine":
        eta_min = 1e-8

        def sched(epoch):
            return eta_min + (base_lr - eta_min) * (
                1 + math.cos(math.pi * epoch / max_epochs)) / 2

    elif name == "poly":
        exp = float(getattr(config, "poly_exp", 1.0))

        def sched(epoch):
            return base_lr * (1 - epoch / max_epochs) ** exp

    elif name == "chained":
        milestones = [max_epochs // 2, max_epochs * 3 // 4, max_epochs * 9 // 10]

        def sched(epoch):
            warm = min(0.01 + (1 - 0.01) * epoch / 100, 1.0)
            decay = 0.33 ** sum(1 for m in milestones if epoch >= m)
            return base_lr * warm * decay

    else:
        raise ValueError(f"scheduler not recognized: {name}")

    warmup = int(getattr(config, "warmup_epochs", 0) or 0)
    if warmup > 0 and config.optimizer not in ("radam", "ranger"):
        mult = float(getattr(config, "warmup_multiplier", 1.0))
        inner = sched

        def sched(epoch):  # noqa: F811 -- gradual warmup wrapper
            if epoch <= warmup:
                return base_lr * ((mult - 1.0) * epoch / warmup + 1.0)
            return mult * inner(epoch - warmup) / 1.0

    return sched
