"""paddle_tpu_torch.framework (counterpart of paddle_tpu/framework/): the
op-type registry that the IR verifier and the deploy format resolve op
types through (``op_registry``), and ``paddle.save`` / ``paddle.load`` of
state dicts (``io_utils``)."""

from . import io_utils, op_registry  # noqa: F401
from .io_utils import load, save  # noqa: F401
