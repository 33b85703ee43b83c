"""paddle_tpu_torch.optimizer — counterpart of paddle_tpu.optimizer."""

from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import SGD, Adam, AdamW  # noqa: F401
