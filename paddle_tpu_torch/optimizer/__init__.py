"""paddle_tpu_torch.optimizer — counterpart of paddle_tpu.optimizer."""

from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,  # noqa: F401
                         Lamb, Momentum, NAdam, RAdam, RMSProp, Rprop)
