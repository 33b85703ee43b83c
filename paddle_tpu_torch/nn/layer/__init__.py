from .common import AlphaDropout, Dropout, Dropout2D, Dropout3D, Embedding, Linear  # noqa: F401
from .layers import ParamAttr  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401
from .transformer import (MultiHeadAttention, TransformerEncoder,  # noqa: F401
                          TransformerEncoderLayer)
