"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

The clip classes are the ``grad_clip`` an optimizer takes: each maps a
list of ``(param, grad)`` pairs to the same list with every clipped grad
replaced.  A parameter with ``need_clip = False`` (``ParamAttr``) is
neither counted nor changed by any of the three.

- ``ClipGradByValue(max, min=-max)``: each element clamped;
- ``ClipGradByNorm(clip_norm)``: each grad scaled by ``clip_norm / norm``
  where its own norm exceeds ``clip_norm``;
- ``ClipGradByGlobalNorm(clip_norm)``: every grad scaled by
  ``clip_norm / max(global_norm, clip_norm)``.

Norms are taken in f32 whatever the grads' dtype; each result keeps its
grad's dtype.  The scales stay on the device, so a recorded step clips
without a host read.  ``clip_grad_norm_`` and ``clip_grad_value_`` act on
``.grad`` in place.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)

    def _clip(self, params_grads):
        raise NotImplementedError


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _one(self, g):
        norm = g.float().square().sum().sqrt()
        scale = torch.where(norm > self.clip_norm,
                            self.clip_norm / torch.clamp(norm, min=1e-12), 1.0)
        return (g.float() * scale).to(g.dtype)

    def _clip(self, params_grads):
        return [(p, self._one(g) if _clipped(p, g) else g) for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group", auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        sq = [g.float().square().sum() for p, g in params_grads if _clipped(p, g)]
        if not sq:
            return params_grads
        global_norm = torch.stack(sq).sum().sqrt()
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype) if _clipped(p, g) else g)
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place so their total
    ``norm_type`` norm is at most ``max_norm``; returns the total norm
    before scaling (f32, 0-d)."""
    params = [parameters] if isinstance(parameters, torch.Tensor) else list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.float().abs().max() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum().pow(1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"clip_grad_norm_: the total norm {float(total)} is not finite")
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.copy_(g.float() * scale)
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp the ``.grad`` of ``parameters`` to ``[-clip_value, clip_value]``,
    in place."""
    params = [parameters] if isinstance(parameters, torch.Tensor) else list(parameters)
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad.clamp_(-clip_value, clip_value)
