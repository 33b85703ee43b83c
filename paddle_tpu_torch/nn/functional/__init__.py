from .activation import gelu, relu, silu, tanh  # noqa: F401
from .attention import flash_attention, scaled_dot_product_attention  # noqa: F401
from .common import (alpha_dropout, dropout, dropout2d, dropout3d, embedding,  # noqa: F401
                     feature_alpha_dropout, linear)
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import batch_norm, layer_norm, rms_norm  # noqa: F401
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_avg_pool3d, adaptive_max_pool1d, adaptive_max_pool2d,
                      adaptive_max_pool3d, avg_pool1d, avg_pool2d, avg_pool3d, max_pool1d,
                      max_pool2d, max_pool3d)
