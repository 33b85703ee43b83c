"""Learning-rate schedulers (counterpart of paddle_tpu/optimizer/lr.py).

Plain Python on floats, as in the JAX package.  Ported: the base class,
``LinearWarmup`` and ``CosineAnnealingDecay``; the other schedulers are
queued (ROADMAP.md A.3.3).
"""

from __future__ import annotations

import math

__all__ = ["LRScheduler", "LinearWarmup", "CosineAnnealingDecay"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def get_lr(self) -> float:
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self._compute()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def _compute(self) -> float:
        raise NotImplementedError

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state.get("last_epoch", self.last_epoch)
        self.last_lr = state.get("last_lr", self.last_lr)


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a float or a scheduler stepped from 0)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1,
                 verbose=False):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def _compute(self):
        if self.last_epoch < self.warmup_steps:
            return (self.start_lr
                    + (self.end_lr - self.start_lr) * self.last_epoch / self.warmup_steps)
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.step(self.last_epoch - self.warmup_steps)
            return self.lr_after.get_lr()
        return float(self.lr_after)

    def state_dict(self):
        state = super().state_dict()
        if isinstance(self.lr_after, LRScheduler):
            state["lr_after"] = self.lr_after.state_dict()
        return state

    def set_state_dict(self, state):
        super().set_state_dict(state)
        if "lr_after" in state and isinstance(self.lr_after, LRScheduler):
            self.lr_after.set_state_dict(state["lr_after"])


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)
