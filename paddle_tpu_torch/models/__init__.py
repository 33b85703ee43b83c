from .bert import (BertConfig, BertForMaskedLM, BertForSequenceClassification,  # noqa: F401
                   BertModel, ErnieConfig, ErnieForSequenceClassification, ErnieModel,
                   bert_tiny)
from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,  # noqa: F401
                    LlamaModel, llama_7b, llama_tiny)
