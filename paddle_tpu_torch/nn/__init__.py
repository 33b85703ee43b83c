from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm, clip_grad_norm_  # noqa: F401
from .layer import (Dropout, Embedding, LayerNorm, Linear, MultiHeadAttention,  # noqa: F401
                    RMSNorm, TransformerEncoder, TransformerEncoderLayer)
from .lora import (DEFAULT_TARGET_NAMES, LLAMA_TARGETS, AdapterPack,  # noqa: F401
                   LoRALinear, adapter_prefill_scope, apply_lora, lora_delta, lora_state_dict,
                   parse_adapter_state_dict)
