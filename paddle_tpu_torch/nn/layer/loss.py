"""Loss layers (counterpart of paddle_tpu/nn/layer/loss.py): those whose
functionals the port has.  The rest are ROADMAP.md A.7."""

from __future__ import annotations

from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(nn.Module):
    """``F.cross_entropy`` with its arguments fixed at construction; hard
    labels may be any integer dtype (int32 as Paddle feeds them)."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False,
                 axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
        super().__init__()
        self.weight, self.ignore_index, self.reduction = weight, ignore_index, reduction
        self.soft_label, self.axis = soft_label, axis
        self.use_softmax, self.label_smoothing = use_softmax, label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index, self.reduction,
                               self.soft_label, self.axis, self.use_softmax,
                               self.label_smoothing)
