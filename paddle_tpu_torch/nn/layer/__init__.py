from .activation import GELU, ReLU, Silu, Tanh  # noqa: F401
from .common import AlphaDropout, Dropout, Dropout2D, Dropout3D, Embedding, Linear  # noqa: F401
from .container import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from .conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .layers import ParamAttr  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm,  # noqa: F401
                   RMSNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,  # noqa: F401
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, TransformerEncoder,  # noqa: F401
                          TransformerEncoderLayer)
