"""Weight-decay regularizers (counterpart of paddle_tpu/regularizer.py).

``L1Decay`` / ``L2Decay`` instances are taken where the JAX package takes
them: as an optimizer's ``weight_decay=`` (applied to every trainable
parameter without its own regularizer) and per parameter
(``ParamAttr(regularizer=...)``, or ``param.regularizer = ...``), which
takes priority.  A coefficient of 0 turns the term off.  The penalty's
gradient is added to the grad inside the optimizer's update (L2:
``coeff * w``; L1: ``coeff * sign(w)``), on the device.
"""

from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    """Base class; subclasses define the penalty gradient."""

    coeff: float = 0.0

    def _grad_term(self, value):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(WeightDecayRegularizer):
    """L1 penalty: loss += coeff * sum|w|; grad term coeff * sign(w)."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def _grad_term(self, value):
        return self.coeff * torch.sign(value)


class L2Decay(WeightDecayRegularizer):
    """L2 penalty: loss += 0.5 * coeff * sum(w^2); grad term coeff * w."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def _grad_term(self, value):
        return self.coeff * value
