"""Learning-rate schedulers (counterpart of paddle_tpu/optimizer/lr.py).

Plain Python on floats, as in the JAX package, stepped on the host
between training steps: the optimizer writes the current rate into its
device tensor (``Optimizer._sync_lr``, before each step or replay), so a
recorded step reads every rate a scheduler gives.  ``ReduceOnPlateau``
steps on a metric (``step(metrics)``; a tensor is read with ``.item()``).
"""

from __future__ import annotations

import math

__all__ = [
    "LRScheduler",
    "NoamDecay",
    "ExponentialDecay",
    "NaturalExpDecay",
    "InverseTimeDecay",
    "PolynomialDecay",
    "LinearWarmup",
    "PiecewiseDecay",
    "CosineAnnealingDecay",
    "CosineAnnealingWarmRestarts",
    "StepDecay",
    "MultiStepDecay",
    "LambdaDecay",
    "ReduceOnPlateau",
    "MultiplicativeDecay",
    "OneCycleLR",
    "CyclicLR",
    "LinearLR",
    "ConstantLR",
]


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

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model**-0.5) * min(step**-0.5, step * self.warmup_steps**-1.5)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        return self.base_lr * self.gamma**self.last_epoch


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0, cycle=False,
                 last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / self.decay_steps) if step > 0 else 1
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * (1 - step / decay_steps) ** self.power + self.end_lr


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a float or a scheduler stepped from 0)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1,
                 verbose=False):
        self.lr_after = learning_rate  # float or LRScheduler
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


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def _compute(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        return (
            self.eta_min
            + (self.base_lr - self.eta_min)
            * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
        )


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1, verbose=False):
        self.T_0, self.T_mult, self.eta_min = T_0, T_mult, eta_min
        self.T_cur = last_epoch
        self.T_i = T_0
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        t = self.last_epoch
        T_i, T_0 = self.T_0, self.T_0
        while t >= T_i:
            t -= T_i
            T_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / T_i)) / 2


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1, verbose=False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1, verbose=False):
        self.milestones, self.gamma = list(milestones), gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma**n


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur

    def state_dict(self):
        # _cur is RUNNING multiplicative state, not derivable from
        # last_epoch alone — without it a restored scheduler restarts the
        # product from base_lr
        state = super().state_dict()
        state["_cur"] = self._cur
        return state

    def set_state_dict(self, state):
        super().set_state_dict(state)
        self._cur = state.get("_cur", self._cur)


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10, threshold=1e-4,
                 threshold_mode="rel", cooldown=0, min_lr=0, epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.epsilon = cooldown, min_lr, epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._lr = float(learning_rate)
        super().__init__(learning_rate, -1, verbose)

    def _compute(self):
        return self._lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            self.last_epoch += 1
            self.last_lr = self._lr
            return
        cur = float(metrics) if not hasattr(metrics, "item") else float(metrics.item())
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new_lr = max(self._lr * self.factor, self.min_lr)
            if self._lr - new_lr > self.epsilon:
                self._lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        self.last_epoch += 1
        self.last_lr = self._lr

    def _better(self, a, b):
        if self.mode == "min":
            th = b * (1 - self.threshold) if self.threshold_mode == "rel" else b - self.threshold
            return a < th
        th = b * (1 + self.threshold) if self.threshold_mode == "rel" else b + self.threshold
        return a > th

    def state_dict(self):
        # the plateau detector is all mutable state: the running best
        # metric, bad-epoch and cooldown counters, and the decayed lr itself
        state = super().state_dict()
        state.update(best=self.best, num_bad=self.num_bad,
                     cooldown_counter=self.cooldown_counter, _lr=self._lr)
        return state

    def set_state_dict(self, state):
        super().set_state_dict(state)
        self.best = state.get("best", self.best)
        self.num_bad = state.get("num_bad", self.num_bad)
        self.cooldown_counter = state.get("cooldown_counter", self.cooldown_counter)
        self._lr = state.get("_lr", self._lr)


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, anneal_strategy="cos",
                 three_phase=False, last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _anneal_fn(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def _compute(self):
        step = min(self.last_epoch, self.total_steps)
        up_steps = int(self.phase_pct * self.total_steps)
        if step <= up_steps:
            return self._anneal_fn(self.initial_lr, self.max_lr, step / max(up_steps, 1))
        return self._anneal_fn(self.max_lr, self.end_lr,
                               (step - up_steps) / max(self.total_steps - up_steps, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up, step_size_down=None,
                 mode="triangular", exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.base_lr_ = base_learning_rate
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def _compute(self):
        total = self.up + self.down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        scale = x / self.up if x <= self.up else (total - x) / self.down
        amp = (self.max_lr - self.base_lr_) * scale
        if self.scale_fn is not None:
            factor = self.scale_fn(cycle if self.scale_mode == "cycle" else self.last_epoch)
        elif self.mode == "triangular2":
            factor = 1 / (2 ** (cycle - 1))
        elif self.mode == "exp_range":
            factor = self.gamma**self.last_epoch
        else:
            factor = 1.0
        return self.base_lr_ + amp * factor


class LinearLR(LRScheduler):
    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3, end_factor=1.0,
                 last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        if self.last_epoch >= self.total_steps:
            return self.base_lr * self.end_factor
        pct = self.last_epoch / self.total_steps
        factor = self.start_factor + (self.end_factor - self.start_factor) * pct
        return self.base_lr * factor


class ConstantLR(LRScheduler):
    def __init__(self, learning_rate, factor=1.0 / 3, total_steps=5, last_epoch=-1, verbose=False):
        self.factor = factor
        self.total_steps = total_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self):
        if self.last_epoch < self.total_steps:
            return self.base_lr * self.factor
        return self.base_lr
