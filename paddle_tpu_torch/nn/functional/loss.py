"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py)."""

from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                  name=None):
    """Cross entropy over ``axis`` with hard (class index) labels.

    Labels equal to ``ignore_index`` contribute 0 and do not count;
    ``reduction="mean"`` divides by ``max(count of the others, 1)``, or with
    ``weight`` by the sum of their class weights.  ``label_smoothing`` mixes
    the one-hot target with the uniform one.  Soft labels are not ported."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: reduction {reduction!r} is not mean, sum or none")
    if soft_label or (label.dim() == input.dim() and label.shape == input.shape):
        raise NotImplementedError(
            "cross_entropy: soft labels are not ported yet (ROADMAP.md queue A item 2)")
    axis = axis % input.dim()
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp(input, min=1e-30))
    n_classes = input.shape[axis]
    idx = label.long()
    if idx.dim() == input.dim():
        idx = idx.squeeze(axis)
    mask = idx != ignore_index
    safe = idx.clamp(0, n_classes - 1).unsqueeze(axis)
    if label_smoothing > 0:
        soft = torch.full_like(logp, label_smoothing / n_classes)
        soft.scatter_add_(axis, safe, torch.full_like(safe, 1.0 - label_smoothing,
                                                      dtype=logp.dtype))
        loss = -(soft * logp).sum(dim=axis)
    else:
        loss = -logp.gather(axis, safe).squeeze(axis)
    loss = torch.where(mask, loss, torch.zeros((), dtype=loss.dtype, device=loss.device))
    if weight is not None:
        wsel = torch.where(mask, weight[idx.clamp(0, n_classes - 1)].to(loss.dtype), 0.0)
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / torch.clamp(wsel.sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(mask.sum().to(loss.dtype), min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
