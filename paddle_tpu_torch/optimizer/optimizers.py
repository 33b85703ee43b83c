"""The optimizers (counterpart of paddle_tpu/optimizer/optimizers.py):
SGD, Momentum, Adam, AdamW, Adagrad, Adadelta, RMSProp, Lamb, Adamax,
NAdam, RAdam, ASGD and Rprop.

The update math follows the JAX package operation for operation (its
arithmetic, not ``torch.optim``'s: NAdam has no momentum-decay schedule,
ASGD is plain SGD), in f32 for the moments, with the rate read from the
optimizer's 0-d f32 tensor on the device, as the JAX package reads
``_lr_t``.  Every accumulator is written in place through
``Optimizer._put`` (a select under a GradScaler's skip), and no host
scalar is built from the rate or the step, so a captured step reads each
later rate and step:

- RAdam counts its steps in a per-parameter int64 accumulator ``step``
  and takes its rectification branch (``rho_t > 4``) as a select, where
  the JAX package reads ``_step_count`` on the host (ROADMAP.md §C);
- Rprop's ``step_size`` starts as a device copy of the rate, made when
  the accumulator is (the first step, or ``lower()``'s rolled-back one).

``LBFGS`` (closure-driven, a line search on the host) is not ported.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.regularizer import L2Decay

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "Adadelta", "RMSProp", "Lamb",
           "Adamax", "NAdam", "RAdam", "ASGD", "Rprop", "LBFGS"]


def _zero_d(p, value, dtype=torch.float32):
    return lambda: torch.full((), value, dtype=dtype, device=p.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)

    def _single_update(self, p, value, g, lr):
        # the rate in the gradient's dtype, as JAX's lr.astype(g.dtype)
        return value - lr.to(g.dtype) * g


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None, use_nesterov=False,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _single_update(self, p, value, g, lr):
        vel = self._acc("velocity", p, dtype=g.dtype)  # the gradient's dtype, as in JAX
        # the coefficient in that dtype too: JAX rounds its weakly typed
        # Python scalar to a bf16 operand's dtype before multiplying
        mu = torch.full((), self._momentum, dtype=g.dtype, device=g.device)
        new_v = mu * vel + g
        self._put(vel, new_v)
        step = g + mu * new_v if self._nesterov else new_v
        return value - lr.to(g.dtype) * step


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
        b1p = self._acc("beta1_pow", p, init=_zero_d(p, 1.0))
        b2p = self._acc("beta2_pow", p, init=_zero_d(p, 1.0))
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
        elif isinstance(weight_decay, L2Decay):  # decoupled decay is L2-style
            self._wd_coeff = weight_decay.coeff
        else:
            # L1 cannot be a multiplicative decoupled decay: refuse, as the
            # JAX package does, rather than apply another penalty
            raise TypeError(f"AdamW weight_decay must be a float or L2Decay, got "
                            f"{type(weight_decay).__name__}")
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


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _single_update(self, p, value, g, lr):
        acc = self._acc("moment", p, init=lambda: torch.full(
            p.shape, self._init_acc, dtype=torch.float32, device=p.device))
        g32 = g.float()
        new_acc = acc + g32.square()
        self._put(acc, new_acc)
        return value.float() - lr * g32 / (new_acc.sqrt() + self._eps)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._eps, self._rho = epsilon, rho

    def _single_update(self, p, value, g, lr):
        g32 = g.float()
        avg_sq = self._acc("avg_squared_grad", p, dtype=torch.float32)
        avg_upd = self._acc("avg_squared_update", p, dtype=torch.float32)
        new_avg_sq = self._rho * avg_sq + (1 - self._rho) * g32.square()
        update = (avg_upd + self._eps).sqrt() / (new_avg_sq + self._eps).sqrt() * g32
        new_avg_upd = self._rho * avg_upd + (1 - self._rho) * update.square()
        self._put(avg_sq, new_avg_sq)
        self._put(avg_upd, new_avg_upd)
        return value.float() - lr * update


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._rho, self._eps, self._momentum, self._centered = rho, epsilon, momentum, centered

    def _single_update(self, p, value, g, lr):
        g32 = g.float()
        ms = self._acc("mean_square", p, dtype=torch.float32)
        new_ms = self._rho * ms + (1 - self._rho) * g32.square()
        self._put(ms, new_ms)
        if self._centered:
            mg = self._acc("mean_grad", p, dtype=torch.float32)
            new_mg = self._rho * mg + (1 - self._rho) * g32
            self._put(mg, new_mg)
            denom = (new_ms - new_mg.square() + self._eps).sqrt()
        else:
            denom = (new_ms + self._eps).sqrt()
        update = lr * g32 / denom
        if self._momentum > 0:
            mom = self._acc("momentum", p, dtype=torch.float32)
            update = self._momentum * mom + update
            self._put(mom, update)
        return value.float() - update


class Lamb(Optimizer):
    """Layer-wise adaptive moments.  ``exclude_from_weight_decay_fn(name)``
    turns the decay off for a parameter; it gets the name from
    ``(name, param)`` pairs ("" for a bare tensor), where the JAX package
    hands it the parameter and reads ``p.name``."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _single_update(self, p, value, g, lr):
        g32 = g.float()
        m = self._acc("moment1", p, dtype=torch.float32)
        v = self._acc("moment2", p, dtype=torch.float32)
        b1p = self._acc("beta1_pow", p, init=_zero_d(p, 1.0))
        b2p = self._acc("beta2_pow", p, init=_zero_d(p, 1.0))
        new_m = self._beta1 * m + (1 - self._beta1) * g32
        new_v = self._beta2 * v + (1 - self._beta2) * g32.square()
        new_b1p, new_b2p = b1p * self._beta1, b2p * self._beta2
        for t, new in ((m, new_m), (v, new_v), (b1p, new_b1p), (b2p, new_b2p)):
            self._put(t, new)
        m_hat = new_m / (1 - new_b1p)
        v_hat = new_v / (1 - new_b2p)
        master = value.float()
        r = m_hat / (v_hat.sqrt() + self._eps)
        excluded = self._exclude_fn is not None and self._exclude_fn(self._param_name(p))
        update = r + (0.0 if excluded else self._wd) * master
        w_norm, u_norm = master.norm(), update.norm()
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm, 1.0)
        return master - lr * trust * update


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _single_update(self, p, value, g, lr):
        g32 = g.float()
        m = self._acc("moment", p, dtype=torch.float32)
        u = self._acc("inf_norm", p, dtype=torch.float32)
        b1p = self._acc("beta1_pow", p, init=_zero_d(p, 1.0))
        new_m = self._beta1 * m + (1 - self._beta1) * g32
        new_u = torch.maximum(self._beta2 * u, g32.abs())
        new_b1p = b1p * self._beta1
        for t, new in ((m, new_m), (u, new_u), (b1p, new_b1p)):
            self._put(t, new)
        return value.float() - lr / (1 - new_b1p) * new_m / (new_u + self._eps)


class NAdam(Adam):
    """Adam with a Nesterov step on the bias-corrected moment (the JAX
    package's arithmetic: no momentum-decay schedule)."""

    def _single_update(self, p, value, g, lr):
        m_hat, v_hat = self._update_moments(p, g)
        nesterov_m = self._beta1 * m_hat + (1 - self._beta1) * g.float()
        return value.float() - lr * nesterov_m / (v_hat.sqrt() + self._eps)


class RAdam(Adam):
    """Rectified Adam.  The step t comes from a device counter (the
    ``step`` accumulator) and the ``rho_t > 4`` branch is a select, so a
    recorded step rectifies as the eager steps do; the rectification
    itself is taken in f64, as the JAX package takes it in Python."""

    def _single_update(self, p, value, g, lr):
        m_hat, v_hat = self._update_moments(p, g)
        step = self._acc("step", p, init=_zero_d(p, 0, torch.int64))
        t = step + 1
        self._put(step, t)
        t = t.double()
        rho_inf = 2.0 / (1 - self._beta2) - 1
        beta2_t = torch.pow(self._beta2, t)
        rho_t = rho_inf - 2 * t * beta2_t / (1 - beta2_t)
        r = ((rho_t - 4) * (rho_t - 2) * rho_inf
             / ((rho_inf - 4) * (rho_inf - 2) * rho_t)).sqrt().float()
        master = value.float()
        rectified = master - lr * r * m_hat / (v_hat.sqrt() + self._eps)
        return torch.where(rho_t > 4, rectified, master - lr * m_hat)


class ASGD(Optimizer):
    """The JAX package's ASGD: a plain SGD step in f32 (no averaging)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)

    def _single_update(self, p, value, g, lr):
        return value.float() - lr * g.float()


class Rprop(Optimizer):
    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas

    def _single_update(self, p, value, g, lr):
        g32 = g.float()
        prev_g = self._acc("prev_grad", p, dtype=torch.float32)
        # the rate copied on the device when the accumulator is made
        step_size = self._acc("step_size", p,
                              init=lambda: lr.to(torch.float32).expand(p.shape).clone())
        sign = torch.sign(g32 * prev_g)
        factor = torch.where(sign > 0, self._eta_plus,
                             torch.where(sign < 0, self._eta_minus, 1.0))
        new_step = torch.clamp(step_size * factor, self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, 0.0, g32)
        self._put(step_size, new_step)
        self._put(prev_g, g_eff)
        return value.float() - torch.sign(g_eff) * new_step


class LBFGS:
    """Not ported: closure-driven, with a line search on the host, so it
    cannot run inside a recorded step."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "optimizer.LBFGS is not ported yet (ROADMAP.md A.3.3): it is closure-driven and "
            "runs its line search on the host")
