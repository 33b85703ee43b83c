from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,  # noqa: F401
                    LlamaModel, llama_7b, llama_tiny)
