"""BERT / ERNIE encoder family (counterpart of paddle_tpu/models/bert.py).

Built on the port's ``nn.TransformerEncoder`` as the JAX package builds it
on its own; ERNIE 1.0/3.0 base shares the BERT encoder, so the ``Ernie*``
names are aliases.  The state-dict keys are the JAX package's
(``bert.encoder.layers.0.self_attn.q_proj.bias`` ...), so
``convert.load_jax_state_dict`` carries its weights across unchanged.

Eager, every op is plain PyTorch (LayerNorm, GELU, the masked attention),
as the JAX package's eager BERT is plain jnp.  Captured as a static
``Program`` and run by ``static.Executor``, ``PallasFusionPass`` puts the
residual adds + LayerNorms on the fused LayerNorm kernel and each FFN's
``linear1`` + GELU on the matmul-epilogue kernel.

Models are built in f32 on ``device`` (``None``: the CUDA card); cast with
``.to(torch.bfloat16)`` for bf16.  ``generator`` seeds the random initial
weights (Xavier-normal, as in the JAX package).  In training mode the
dropouts draw from the device RNG state, eagerly (``jit.TrainStep``, f32
or under ``amp.auto_cast``) and inside a captured Program
(``Optimizer.minimize``); call ``.eval()`` for inference.  The default
position and token-type ids are made from ``input_ids`` (``expand_as``,
``zeros_like``), so a captured program bakes no batch size into a const
and ``jit.save`` can leave the batch ``None``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch._core.device import resolve_device
from paddle_tpu_torch.nn import (Dropout, Embedding, LayerNorm, Linear, TransformerEncoder,
                                 TransformerEncoderLayer)
from paddle_tpu_torch.nn import functional as F

__all__ = [
    "BertConfig",
    "BertEmbeddings",
    "BertPooler",
    "BertModel",
    "BertForSequenceClassification",
    "BertForMaskedLM",
    "ErnieConfig",
    "ErnieModel",
    "ErnieForSequenceClassification",
    "bert_tiny",
]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


ErnieConfig = BertConfig  # same encoder family


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.word_embeddings = Embedding(config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size, config.hidden_size,
                                               **kw)
        self.layer_norm = LayerNorm(config.hidden_size, epsilon=config.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        # on the weights' device: under capture input_ids is a Variable
        device = self.word_embeddings.weight.device
        if position_ids is None:
            position_ids = torch.arange(s, dtype=torch.int32, device=device).unsqueeze(0) \
                .expand_as(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids, dtype=torch.int32)
        emb = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, generator=None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size, device=device,
                            generator=generator)

    def forward(self, hidden_states):
        return F.tanh(self.dense(hidden_states[:, 0]))


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embeddings = BertEmbeddings(config, device=device, generator=generator)
        layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads, config.intermediate_size,
            dropout=config.hidden_dropout_prob, activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob, device=device,
            generator=generator)
        self.encoder = TransformerEncoder(layer, config.num_hidden_layers)
        self.pooler = BertPooler(config, device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None):
        if attention_mask is None:
            attention_mask = (input_ids != self.config.pad_token_id).to(torch.int32)
        # additive mask [B, 1, 1, S(k)], broadcast over the attention logits
        ext = ((1 - attention_mask.float()) * -1e4).unsqueeze(1).unsqueeze(1)
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        h = self.encoder(h, ext)
        return h, self.pooler(h)


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig, num_classes: int = 2, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.bert = BertModel(config, device=device, generator=generator)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes, device=device,
                                 generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels), logits
        return logits


class BertForMaskedLM(nn.Module):
    def __init__(self, config: BertConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.bert = BertModel(config, device=device, generator=generator)
        self.transform = Linear(config.hidden_size, config.hidden_size, device=device,
                                generator=generator)
        self.layer_norm = LayerNorm(config.hidden_size, epsilon=config.layer_norm_eps,
                                    device=device)
        self.decoder = Linear(config.hidden_size, config.vocab_size, device=device,
                              generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, labels=None):
        h, _ = self.bert(input_ids, token_type_ids, attention_mask=attention_mask)
        h = self.layer_norm(F.gelu(self.transform(h)))
        logits = self.decoder(h)
        if labels is not None:
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                                   labels.reshape(-1), ignore_index=-100)
            return loss, logits
        return logits


ErnieModel = BertModel
ErnieForSequenceClassification = BertForSequenceClassification


def bert_tiny(**kw) -> BertConfig:
    cfg = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=256, max_position_embeddings=128)
    cfg.update(kw)
    return BertConfig(**cfg)
