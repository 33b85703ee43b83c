from .activation import gelu, relu, silu, tanh  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, embedding, linear  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm, rms_norm  # noqa: F401
