from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm, clip_grad_norm_  # noqa: F401
from .layer import (Dropout, Embedding, LayerNorm, Linear, MultiHeadAttention,  # noqa: F401
                    RMSNorm, TransformerEncoder, TransformerEncoderLayer)
