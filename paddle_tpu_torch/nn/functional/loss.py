"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.static.program import apply

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                  name=None):
    """Cross entropy over ``axis``.

    Hard (class index) labels: labels equal to ``ignore_index`` contribute
    0 and do not count; ``reduction="mean"`` divides by ``max(count of the
    others, 1)``, or with ``weight`` by the sum of their class weights.
    ``label_smoothing`` mixes the one-hot target with the uniform one.

    Soft labels (``soft_label=True``, or a label of the input's shape): a
    distribution over ``axis``, smoothed the same way; the loss is
    ``-sum(label * log_softmax)`` and ``mean`` is over every row, as in the
    JAX package (``weight`` and ``ignore_index`` do not apply)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: reduction {reduction!r} is not mean, sum or none")
    # one "cross_entropy" op, as in the JAX package, so AMP's cast hook sees it
    if soft_label or (label.dim() == input.dim() and label.shape == input.shape):
        return apply("cross_entropy", _soft_cross_entropy, input, label, reduction=reduction,
                     axis=axis, use_softmax=use_softmax, label_smoothing=label_smoothing)
    return apply("cross_entropy", _cross_entropy, input, label, weight,
                 ignore_index=ignore_index, reduction=reduction, axis=axis,
                 use_softmax=use_softmax, label_smoothing=label_smoothing)


def _log_probs(input, axis, use_softmax):
    if use_softmax:
        return torch.log_softmax(input, dim=axis)
    return torch.log(torch.clamp(input, min=1e-30))


def _soft_cross_entropy(input, label, *, reduction, axis, use_softmax, label_smoothing):
    axis = axis % input.dim()
    logp = _log_probs(input, axis, use_softmax)
    soft = label
    if label_smoothing > 0:
        soft = soft * (1 - label_smoothing) + label_smoothing / input.shape[axis]
    loss = -(soft * logp).sum(dim=axis)
    if reduction == "mean":
        return loss.mean()
    return loss.sum() if reduction == "sum" else loss


def _cross_entropy(input, label, weight, *, ignore_index, reduction, axis, use_softmax,
                   label_smoothing):
    axis = axis % input.dim()
    logp = _log_probs(input, axis, use_softmax)
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


def _softmax_with_cross_entropy(logits, label, *, soft_label, ignore_index, return_softmax,
                                axis):
    axis = axis % logits.dim()
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        idx = label.long()
        if idx.dim() == logits.dim():
            idx = idx.squeeze(axis)
        idx = idx.unsqueeze(axis)
        picked = logp.gather(axis, idx.clamp(0, logits.shape[axis] - 1))
        loss = torch.where(idx != ignore_index, -picked,
                           torch.zeros((), dtype=logp.dtype, device=logp.device))
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    """Per-row loss with ``axis`` kept (size 1): ``-log_softmax`` at the
    hard label (0 at ``ignore_index``), or ``-sum(label * log_softmax)``
    with ``soft_label``; with ``return_softmax`` also the softmax."""
    return apply("softmax_with_cross_entropy", _softmax_with_cross_entropy, logits, label,
                 soft_label=bool(soft_label), ignore_index=ignore_index,
                 return_softmax=bool(return_softmax), axis=axis)
