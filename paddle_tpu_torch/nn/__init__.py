from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm, clip_grad_norm_  # noqa: F401
from .layer import Embedding, Linear, RMSNorm  # noqa: F401
