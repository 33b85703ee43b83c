from . import functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,  # noqa: F401
                   clip_grad_norm_, clip_grad_value_)
from .layer import (AlphaDropout, Dropout, Dropout2D, Dropout3D, Embedding,  # noqa: F401
                    LayerNorm, Linear, MultiHeadAttention, ParamAttr, RMSNorm,
                    TransformerEncoder, TransformerEncoderLayer)
from .lora import (DEFAULT_TARGET_NAMES, LLAMA_TARGETS, AdapterPack,  # noqa: F401
                   LoRALinear, adapter_prefill_scope, apply_lora, lora_delta, lora_state_dict,
                   parse_adapter_state_dict)
