from .activation import gelu, relu, silu, tanh  # noqa: F401
from .attention import flash_attention, scaled_dot_product_attention  # noqa: F401
from .common import (alpha_dropout, dropout, dropout2d, dropout3d, embedding,  # noqa: F401
                     feature_alpha_dropout, linear)
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import layer_norm, rms_norm  # noqa: F401
