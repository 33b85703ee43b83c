from .bert import (BertConfig, BertForMaskedLM, BertForSequenceClassification,  # noqa: F401
                   BertModel, ErnieConfig, ErnieForSequenceClassification, ErnieModel,
                   bert_tiny)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_tiny  # noqa: F401
from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,  # noqa: F401
                    LlamaModel, llama_7b, llama_tiny)
