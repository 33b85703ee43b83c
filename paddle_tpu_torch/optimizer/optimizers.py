"""SGD, Adam and AdamW (counterpart of paddle_tpu/optimizer/optimizers.py).

The update math follows the JAX package operation for operation, in f32
for the moments, with the rate read from the optimizer's 0-d f32 tensor
on the device, as the JAX package reads ``_lr_t``; the moments and
``beta{1,2}_pow`` accumulators are updated in place.  No host scalar is
built from the rate, so a captured step reads each later rate.  The
other optimizers are not ported yet (ROADMAP.md A.3.3).
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Adam", "AdamW"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)

    def _single_update(self, p, value, g, lr):
        # the rate in the gradient's dtype, as JAX's lr.astype(g.dtype)
        return value - lr.to(g.dtype) * g


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, parameters=None,
                 weight_decay=None, grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        # f32 masters are always on for bf16/fp16 parameters (Optimizer.step):
        # multi_precision and lazy_mode are accepted for the JAX signature
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update_moments(self, p, g):
        """Advance the f32 moments and beta powers of ``p`` in place; return
        the bias-corrected ``(m_hat, v_hat)``."""
        m = self._acc("moment1", p, dtype=torch.float32)
        v = self._acc("moment2", p, dtype=torch.float32)
        one = lambda: torch.ones((), dtype=torch.float32, device=p.device)  # noqa: E731
        b1p = self._acc("beta1_pow", p, init=one)
        b2p = self._acc("beta2_pow", p, init=one)
        g32 = g.float()
        if self._skip is None:
            m.mul_(self._beta1).add_((1 - self._beta1) * g32)
            v.mul_(self._beta2).add_((1 - self._beta2) * g32.square())
            b1p.mul_(self._beta1)
            b2p.mul_(self._beta2)
        else:  # the same arithmetic, each write a select (a GradScaler's step)
            self._put(m, m * self._beta1 + (1 - self._beta1) * g32)
            self._put(v, v * self._beta2 + (1 - self._beta2) * g32.square())
            self._put(b1p, b1p * self._beta1)
            self._put(b2p, b2p * self._beta2)
        return m / (1 - b1p), v / (1 - b2p)

    def _single_update(self, p, value, g, lr):
        m_hat, v_hat = self._update_moments(p, g)
        return value.float() - lr * m_hat / (v_hat.sqrt() + self._eps)


class AdamW(Adam):
    """Adam with decoupled weight decay: the master is scaled by
    ``1 - lr * decay`` before the update.  ``apply_decay_param_fun(name)``
    turns the decay off for a parameter (its name from ``(name, param)``
    pairs, "" for a bare tensor); ``lr_ratio(param)`` scales its learning
    rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, parameters=None,
                 weight_decay=0.01, lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters, None, grad_clip,
                         lazy_mode, multi_precision, name)
        if weight_decay is None:
            self._wd_coeff = 0.01
        elif isinstance(weight_decay, (int, float)):
            self._wd_coeff = float(weight_decay)
        else:
            raise NotImplementedError(
                f"AdamW weight_decay {type(weight_decay).__name__}: regularizer objects are "
                "not ported yet (ROADMAP.md A.3.3); pass a float")
        self._apply_decay_fn = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decoupled_wd(self):
        return True

    def _single_update(self, p, value, g, lr):
        m_hat, v_hat = self._update_moments(p, g)
        decay = self._wd_coeff
        if self._apply_decay_fn is not None and not self._apply_decay_fn(self._param_name(p)):
            decay = 0.0
        # lr_ratio(p) is a host float fixed at construction: a constant of
        # a captured step
        lr_eff = lr * (self._lr_ratio(p) if self._lr_ratio is not None else 1.0)
        master = value.float() * (1.0 - lr_eff * decay)
        return master - lr_eff * m_hat / (v_hat.sqrt() + self._eps)
