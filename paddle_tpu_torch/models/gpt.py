"""GPT decoder family (counterpart of paddle_tpu/models/gpt.py).

Learned positions, pre-LN blocks, causal ``MultiHeadAttention`` with no
mask, an exact (erf) GELU MLP and a head tied to the token embedding
(GPT-2's layout).  ``GPTConfig()`` is GPT-2 small (hidden 768, 12 layers,
12 heads, 1024 positions, the vocabulary padded to 50304).

Built in f32, as the JAX package builds it, on ``device`` (``None``: the
CUDA card, which raises without one; the tests pass ``device="cpu"``).
``generator`` seeds the random initial weights (Xavier-normal, as in the
JAX package).  The state-dict keys are the JAX model's
(``gpt.wte.weight``, ``gpt.h.0.attn.q_proj.weight`` ...), so
``convert.load_jax_state_dict`` carries its weights across.

In training the model runs ``config.dropout`` (0.1 by default) after the
embeddings, on each attention output and after each ``fc_out``, with
masks drawn from the device RNG state (``_core/random.py``), so it trains
in a recorded ``TrainStep`` with fresh masks each replay.  The attention
is ``F.scaled_dot_product_attention``: the flash kernels on the card
(f32: the general route; bf16 under ``amp.auto_cast``: the sm90 route at
head_dim 64), their plain versions on the CPU.  The LayerNorms are plain
arithmetic, as in the JAX package.

Not ported: the LayerStack layout (``fuse_layer_stack``,
``FLAGS_scan_layers``; ROADMAP.md A.3.4) and ``shard_gpt`` /
``pipeline_gpt`` (A.6).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch._core import flags as _flags
from paddle_tpu_torch._core.device import resolve_device
from paddle_tpu_torch.nn import Dropout, Embedding, LayerNorm, Linear, MultiHeadAttention
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.static.program import apply

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM", "gpt_tiny"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1
    fuse_layer_stack: bool = False  # the LayerStack layout: not ported (A.3.4)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.ln_1 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps, device=device)
        self.attn = MultiHeadAttention(cfg.hidden_size, cfg.num_attention_heads, cfg.dropout,
                                       **kw)
        self.ln_2 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps, device=device)
        self.fc_in = Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc_out = Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.dropout)

    def forward(self, h):
        h = h + self.attn(self.ln_1(h), is_causal=True)
        return h + self.drop(self.fc_out(F.gelu(self.fc_in(self.ln_2(h)))))


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        if cfg.fuse_layer_stack or _flags.flag("FLAGS_scan_layers"):
            raise NotImplementedError(
                "GPTConfig.fuse_layer_stack / FLAGS_scan_layers (the LayerStack layout) is not "
                "ported yet (ROADMAP.md A.3.4); the port builds the unrolled block list")
        self.config = cfg
        kw = {"device": device, "generator": generator}
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.dropout)
        self.h = nn.ModuleList([GPTBlock(cfg, **kw) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps, device=device)

    def forward(self, input_ids):
        b, s = input_ids.shape
        if s > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{self.config.max_position_embeddings} (jax would silently "
                f"clamp the position lookup)"
            )
        # on the weights' device: under capture input_ids is a Variable
        pos = torch.arange(s, dtype=torch.int32, device=self.wte.weight.device) \
            .unsqueeze(0).expand(b, s)
        h = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.h:
            h = blk(h)
        return self.ln_f(h)


class GPTForCausalLM(nn.Module):
    """The GPT causal LM (module docstring).  ``forward(ids)`` gives the
    logits ``[B, S, V]``; with ``labels``, ``(loss, logits)``, the loss the
    f32 cross entropy of each position's logits against the next label."""

    def __init__(self, cfg: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.gpt = GPTModel(cfg, device=device, generator=generator)
        self.config = cfg

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def forward(self, input_ids, labels=None):
        h = self.gpt(input_ids)
        # the weight-tied head, one "matmul" op as the JAX package's
        # paddle.matmul(transpose_y=True), so AMP's cast hook sees it
        logits = apply("matmul", torch.matmul, h, self.gpt.wte.weight.t())
        if labels is None:
            return logits
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, self.config.vocab_size).float(),
                               labels[:, 1:].reshape(-1))
        return loss, logits


def gpt_tiny(**kw) -> GPTConfig:
    cfg = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=256, max_position_embeddings=128, dropout=0.0)
    cfg.update(kw)
    return GPTConfig(**cfg)
