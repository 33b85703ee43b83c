"""LLaMA-family decoder (counterpart of paddle_tpu/models/llama.py).

Ported: the config and its presets, the rope tables, the unrolled
``layers`` stack (``LayerList`` layout), the full forward with its
training loss (``forward(ids, labels=)``) and the two
serving paths the engine runs — the cached prefill
(``_model_forward_cached``) and the paged decode step
(``_decode_layers_paged``).  Parameter names match the JAX model's
``state_dict`` keys, so ``paddle_tpu_torch.convert.load_jax_state_dict``
carries weights across.

The kernels of these paths sit behind ``RMSNorm`` (fused RMSNorm),
``LlamaMLP`` (SwiGLU) and ``F.scaled_dot_product_attention`` (flash
attention: the forward kernel in prefill and training, the two backward
kernels when a loss from ``forward(ids, labels=)`` is differentiated).
The serving engine can swap in the searched serving chains
(``ops.decode_chain``): an accepted ``chain_cfg`` makes each decode
layer's write-write-attend one kernel, and ``prefill_chain_scope`` makes
each eligible chunked-prefill attention core the prefill-chain kernel.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch import ops
from paddle_tpu_torch._core.device import resolve_device
from paddle_tpu_torch.ops import decode_chain as dc
from paddle_tpu_torch.nn import Embedding, Linear, RMSNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import paged_attention as pa

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "LlamaDecoderLayer",
           "llama_tiny", "llama_7b", "prefill_chain_scope"]

# The accepted prefill-chain config (PrefillChainSpec) of the chunked
# prefill the engine is inside, or None.  A module global, not engine
# state: LlamaAttention.forward is the one place that knows whether this
# call is the eligible prefill core.
_PREFILL_CHAIN_CFG = None


@contextlib.contextmanager
def prefill_chain_scope(cfg):
    """Scope an accepted prefill-chain config over a chunked prefill: inside
    it every eligible attention core (batch 1, a chunk of more than one
    token, no mask, a length the config's ``block_q`` divides) runs the
    prefill-chain kernel; everything else keeps flash attention.
    ``cfg=None`` is a no-op scope."""
    global _PREFILL_CHAIN_CFG
    prev, _PREFILL_CHAIN_CFG = _PREFILL_CHAIN_CFG, cfg
    try:
        yield
    finally:
        _PREFILL_CHAIN_CFG = prev


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # the JAX package's parallel and memory hints, accepted so that its
    # configs carry across; only their defaults are ported (LlamaModel
    # raises on any other value)
    tensor_parallel_degree: int = 1
    sequence_parallel: bool = False
    use_recompute: bool = False
    recompute_granularity: str = "full"
    fuse_layer_stack: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _rope_tables(head_dim: int, max_len: int, theta: float, device=None):
    """cos/sin tables ``[max_len, head_dim / 2]``, always f32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def _rope_rotate(x, c_t, s_t):
    """Interleaved-pair rotation of ``x [B, S, N, H]`` by ``[S, H/2]``
    tables, in f32, cast back to x's dtype."""
    c_t = c_t[None, :, None, :]
    s_t = s_t[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([x1 * c_t - x2 * s_t, x2 * c_t + x1 * s_t], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rotary_pos_emb(q, k, cos, sin, position_offset: int = 0):
    """Rotate q and k ``[B, S, N, H]`` at positions ``position_offset ..
    position_offset + S``."""
    s = q.shape[1]
    c_t = cos[position_offset:position_offset + s]
    s_t = sin[position_offset:position_offset + s]
    return _rope_rotate(q, c_t, s_t), _rope_rotate(k, c_t, s_t)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        kw = {"bias_attr": False, "device": device, "dtype": config.torch_dtype,
              "generator": generator}
        self.q_proj = Linear(self.hidden_size, self.num_heads * self.head_dim, **kw)
        self.k_proj = Linear(self.hidden_size, self.num_kv_heads * self.head_dim, **kw)
        self.v_proj = Linear(self.hidden_size, self.num_kv_heads * self.head_dim, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, self.hidden_size, **kw)

    def forward(self, hidden_states, rope_cos, rope_sin, attn_mask=None, kv_cache=None,
                position_offset=0):
        b, s, _ = hidden_states.shape
        q = self.q_proj(hidden_states).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden_states).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden_states).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k = apply_rotary_pos_emb(q, k, rope_cos, rope_sin, position_offset)
        new_cache = None
        if kv_cache is not None:
            k = torch.cat([kv_cache[0], k], dim=1)
            v = torch.cat([kv_cache[1], v], dim=1)
            new_cache = (k, v)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        chain = _PREFILL_CHAIN_CFG
        bq = int(chain.get("block_q", 0)) if chain else 0
        if chain is not None and attn_mask is None and s > 1 and b == 1 and bq >= 2 \
                and s % bq == 0:
            # the chunked-prefill core under prefill_chain_scope: the
            # accepted config tiles this chunk exactly
            out = dc.fused_prefill_attention(q, k, v, block_q=bq)
        else:
            # an empty-cache prefill is causal; a cached single-token step
            # attends to everything it has; a multi-token chunk on a cache
            # is bottom-right causal
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                 is_causal=(kv_cache is None) or s > 1)
        out = self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        if new_cache is not None:
            return out, new_cache
        return out


class LlamaMLP(nn.Module):
    """SwiGLU MLP: gate and up fused into one projection, then the kernel."""

    def __init__(self, config: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        kw = {"bias_attr": False, "device": device, "dtype": config.torch_dtype,
              "generator": generator}
        self.gate_up_proj = Linear(config.hidden_size, 2 * config.intermediate_size, **kw)
        self.down_proj = Linear(config.intermediate_size, config.hidden_size, **kw)
        self.intermediate_size = config.intermediate_size

    def forward(self, x):
        return self.down_proj(ops.swiglu(self.gate_up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        self.self_attn = LlamaAttention(config, device=device, generator=generator)
        self.mlp = LlamaMLP(config, device=device, generator=generator)
        kw = {"device": device, "dtype": config.torch_dtype}
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)

    def forward(self, hidden_states, rope_cos, rope_sin, attn_mask=None, kv_cache=None,
                position_offset=0):
        residual = hidden_states
        h = self.input_layernorm(hidden_states)
        new_cache = None
        if kv_cache is not None:
            h, new_cache = self.self_attn(h, rope_cos, rope_sin, attn_mask,
                                          kv_cache=kv_cache, position_offset=position_offset)
        else:
            h = self.self_attn(h, rope_cos, rope_sin, attn_mask)
        # the residual add folded into the post-attention norm (one launch)
        x, h = self.post_attention_layernorm.add_norm(h, residual)
        out = h + self.mlp(x)
        if new_cache is not None:
            return out, new_cache
        return out


# config field -> (its only ported value, the ROADMAP item that ports the rest)
_UNPORTED = {"tensor_parallel_degree": (1, "A.6"), "sequence_parallel": (False, "A.6"),
             "use_recompute": (False, "A.3.4"), "recompute_granularity": ("full", "A.3.4"),
             "fuse_layer_stack": (False, "A.3.4")}


def _check_ported(config: LlamaConfig):
    for name, (default, item) in _UNPORTED.items():
        if getattr(config, name) != default:
            raise NotImplementedError(
                f"LlamaConfig.{name}={getattr(config, name)!r} is not ported yet "
                f"(ROADMAP.md {item}); the port builds {name}={default!r}")


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        _check_ported(config)
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size, device=device,
                                      dtype=config.torch_dtype, generator=generator)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device=device, generator=generator)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device=device,
                            dtype=config.torch_dtype)
        head_dim = config.hidden_size // config.num_attention_heads
        cos, sin = _rope_tables(head_dim, config.max_position_embeddings, config.rope_theta,
                                device=device)
        # f32 even for a bf16 model, and not part of the state dict
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids, attn_mask=None):
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            h = layer(h, self.rope_cos, self.rope_sin, attn_mask)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """The LLaMA causal LM.  ``device=None`` means the CUDA card and raises
    without one; the tests pass ``device="cpu"``.  ``generator`` seeds the
    random initial weights (Xavier-normal, as in the JAX package)."""

    def __init__(self, config: LlamaConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.model = LlamaModel(config, device=device, generator=generator)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size, bias_attr=False,
                               device=device, dtype=config.torch_dtype, generator=generator))

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def forward(self, input_ids, labels=None, attn_mask=None):
        """Logits ``[B, S, V]``; with ``labels``, ``(loss, logits)`` where the
        loss is the f32 cross entropy of every position (-100 ignored)."""
        logits = self._logits(self.model(input_ids, attn_mask))
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.float().reshape(-1, self.config.vocab_size),
                               labels.reshape(-1), ignore_index=-100)
        return loss, logits

    def _logits(self, h):
        if self.lm_head is not None:
            return self.lm_head(h)
        return torch.matmul(h, self.model.embed_tokens.weight.t())


def _model_forward_cached(model: LlamaModel, input_ids, caches, position_offset=0):
    """Thread per-layer naive KV caches ``[(k, v)]``, each ``[B, L, Nkv, H]``
    (prefill or decode).  Returns the final-normed hidden states and the
    grown caches."""
    h = model.embed_tokens(input_ids)
    new_caches = []
    for layer, c in zip(model.layers, caches):
        h, nc = layer(h, model.rope_cos, model.rope_sin, None, kv_cache=c,
                      position_offset=position_offset)
        new_caches.append(nc)
    return model.norm(h), new_caches


def _decode_layer_paged(layer, h, cos, sin, kc, vc, tables, lens, chain_cfg=None):
    """One decoder layer on one new token against the paged KV pools.

    h ``[B, 1, D]``; kc/vc pools ``[num_blocks, Nkv, bs, H]`` or QuantPools
    (written in place); tables ``[B, max_blocks]``; lens ``[B]`` lengths
    including this token.  ``chain_cfg``: an accepted decode-chain config
    (ops/decode_chain.py); the write, write, attend below then runs as one
    kernel.  Only the serving engine passes it, after the measured-win
    gate.  Returns ``(h', kc, vc)``."""
    attn = layer.self_attn
    residual = h
    x = layer.input_layernorm(h)
    b = x.shape[0]
    n, nkv, hd = attn.num_heads, attn.num_kv_heads, attn.head_dim
    qv = attn.q_proj(x).reshape(b, n, hd)
    kv_ = attn.k_proj(x).reshape(b, nkv, hd)
    vv = attn.v_proj(x).reshape(b, nkv, hd)
    pos = lens - 1
    qv = pa.rope_rotate_by_position(qv, cos, sin, pos)
    kv_ = pa.rope_rotate_by_position(kv_, cos, sin, pos)
    if chain_cfg is not None:
        o, kc, vc = dc.fused_decode_step(kc, vc, qv, kv_, vv, tables, lens, config=chain_cfg)
    else:
        kc = pa.paged_write(kc, kv_, tables, pos)
        vc = pa.paged_write(vc, vv, tables, pos)
        o = pa.paged_decode_attention(qv, kc, vc, tables, lens)
    x, h = layer.post_attention_layernorm.add_norm(attn.o_proj(o.reshape(b, 1, n * hd)),
                                                   residual)
    return h + layer.mlp(x), kc, vc


def _decode_layers_paged(layers, h, cos, sin, kpools, vpools, tables, lens, chain_cfg=None):
    """Every decoder layer's paged decode step over per-layer pool lists,
    each through the accepted decode-chain config when one is given.
    Returns ``(h, kpools, vpools)``."""
    new_k, new_v = [], []
    for layer, kc, vc in zip(layers, kpools, vpools):
        h, kc, vc = _decode_layer_paged(layer, h, cos, sin, kc, vc, tables, lens, chain_cfg)
        new_k.append(kc)
        new_v.append(vc)
    return h, new_k, new_v


def llama_tiny(**kw) -> LlamaConfig:
    cfg = dict(vocab_size=1024, hidden_size=256, intermediate_size=688, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=512)
    cfg.update(kw)
    return LlamaConfig(**cfg)


def llama_7b(**kw) -> LlamaConfig:
    cfg = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
               num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
               max_position_embeddings=4096)
    cfg.update(kw)
    return LlamaConfig(**cfg)
