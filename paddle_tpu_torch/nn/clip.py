"""Gradient clipping by global norm (counterpart of paddle_tpu/nn/clip.py).

``ClipGradByGlobalNorm`` is the ``grad_clip`` an optimizer takes: it maps a
list of ``(param, grad)`` pairs to the same list with every clipped grad
scaled by ``clip_norm / max(global_norm, clip_norm)``.  A parameter with
``need_clip = False`` is neither counted nor scaled.  The norm is taken in
f32 whatever the grads' dtype; each scaled grad keeps its dtype.  The
other clip classes are not ported yet (ROADMAP.md A.3.3).
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "clip_grad_norm_"]


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)

    def _clip(self, params_grads):
        raise NotImplementedError


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


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
