from . import functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,  # noqa: F401
                   clip_grad_norm_, clip_grad_value_)
from .layer import (GELU, AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                    AdaptiveAvgPool3D, AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                    AlphaDropout, AvgPool1D, AvgPool2D, AvgPool3D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, BatchNorm3D, Conv1D, Conv2D, Conv3D, CrossEntropyLoss,
                    Dropout, Dropout2D, Dropout3D, Embedding, LayerDict, LayerList, LayerNorm,
                    Linear, MaxPool1D, MaxPool2D, MaxPool3D, MultiHeadAttention, ParameterList,
                    ParamAttr, ReLU, RMSNorm, Sequential, Silu, Tanh, TransformerEncoder,
                    TransformerEncoderLayer)
from .lora import (DEFAULT_TARGET_NAMES, LLAMA_TARGETS, AdapterPack,  # noqa: F401
                   LoRALinear, adapter_prefill_scope, apply_lora, lora_delta, lora_state_dict,
                   parse_adapter_state_dict)
