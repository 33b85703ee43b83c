from .common import Dropout, Embedding, Linear  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401
from .transformer import (MultiHeadAttention, TransformerEncoder,  # noqa: F401
                          TransformerEncoderLayer)
