"""LLaMA-family decoder (counterpart of paddle_tpu/models/llama.py).

Ported: the config and its presets, the rope tables, the unrolled
``layers`` stack (``LayerList`` layout), the full forward with its
training loss (``forward(ids, labels=)``) and the
serving paths the engine runs — the cached prefill
(``_model_forward_cached``), the paged decode step and the T-token
paged chunk of the speculative verify (``_decode_layers_paged``,
``chunk=True``), both with the per-row adapter deltas of a multi-tenant
LoRA pack (``adapters=``, ``nn/lora.py``) — and the model-level
``LlamaForCausalLM.generate`` (naive and paged caches, greedy and
top-k / top-p sampling, beam search, speculative decoding; the paged
macro-step recorded as a CUDA graph per call where it replays).  Parameter
names match the JAX model's ``state_dict`` keys, so
``paddle_tpu_torch.convert.load_jax_state_dict`` carries weights across.

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
import math
import warnings
from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch import ops
from paddle_tpu_torch._core import flags as _flags
from paddle_tpu_torch._core import graphs
from paddle_tpu_torch._core.device import resolve_device
from paddle_tpu_torch.ops import decode_chain as dc
from paddle_tpu_torch.nn import Embedding, Linear, RMSNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.lora import lora_delta
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.static.program import apply

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "LlamaDecoderLayer",
           "llama_tiny", "llama_7b", "prefill_chain_scope", "filter_logits"]

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
    if _flags.flag("FLAGS_scan_layers"):
        raise NotImplementedError(
            "FLAGS_scan_layers (the LayerStack layout) is not ported yet "
            "(ROADMAP.md A.3.4); the port builds the unrolled layer list")


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

    _eager_decode = False  # _generate_eager: the paged chunks unrecorded

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
        # one "matmul" op, as the JAX package's paddle.matmul(transpose_y=True),
        # so AMP's cast hook sees it
        return apply("matmul", torch.matmul, h, self.model.embed_tokens.weight.t())

    # ------------------------------------------------------------ generation
    def _last_logits(self, h):
        return self._logits(h[:, -1:, :])[:, -1, :]

    @torch.no_grad()
    def _speculative_decode(self, input_ids, max_new_tokens, draft_model, K):
        """Draft-and-verify greedy decoding on naive caches: the draft
        proposes K tokens one at a time, the target verifies them in ONE
        forward of K + 1 tokens over its cache (bottom-right causal), and
        the longest agreeing prefix plus the target's own next token is
        kept, so the output is the target's greedy stream.  Rejected tail
        entries are trimmed from both caches by slicing.
        ``self._spec_stats`` counts forwards, proposals and acceptances."""
        cfg = self.config
        if draft_model.config.vocab_size != cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        b, s0 = input_ids.shape
        self._spec_stats = {"target_forwards": 0, "draft_forwards": 0,
                            "accepted": 0, "proposed": 0}
        dev = self.device

        def ids(tokens):
            return torch.tensor([tokens], dtype=torch.long, device=dev)

        def trim(caches, n):
            return [(k[:, :n], v[:, :n]) for k, v in caches]

        prompt = input_ids[0].tolist()
        h, t_caches = _model_forward_cached(self.model, input_ids,
                                            _empty_caches(cfg, b, dev), 0)
        self._spec_stats["target_forwards"] += 1
        out = [int(torch.argmax(self._last_logits(h)[0]))]
        _, d_caches = _model_forward_cached(draft_model.model, input_ids,
                                            _empty_caches(draft_model.config, b, dev), 0)
        self._spec_stats["draft_forwards"] += 1
        d_len = s0  # draft cache length (position p holds full[p])

        while len(out) < max_new_tokens:
            full = prompt + out
            base = len(full) - 1  # both caches must cover full[:base]
            if d_len < base:  # draft catch-up over what the last round left
                _, d_caches = _model_forward_cached(draft_model.model, ids(full[d_len:base]),
                                                    d_caches, d_len)
                self._spec_stats["draft_forwards"] += 1
                d_len = base
            k_prop = min(K, max_new_tokens - len(out))
            proposals, d_tok = [], out[-1]
            for _ in range(k_prop):
                dh, d_caches = _model_forward_cached(draft_model.model, ids([d_tok]),
                                                     d_caches, d_len)
                self._spec_stats["draft_forwards"] += 1
                d_len += 1
                d_tok = int(torch.argmax(draft_model._last_logits(dh)[0]))
                proposals.append(d_tok)
            h, t_caches = _model_forward_cached(self.model, ids([out[-1]] + proposals),
                                                t_caches, base)
            self._spec_stats["target_forwards"] += 1
            preds = torch.argmax(self._logits(h)[0], dim=-1).tolist()  # after chunk[i]
            accepted = 0
            while accepted < k_prop and preds[accepted] == proposals[accepted]:
                accepted += 1
            self._spec_stats["proposed"] += k_prop
            self._spec_stats["accepted"] += accepted
            new = proposals[:accepted] + [preds[accepted]]
            out.extend(new[: max_new_tokens - len(out)])
            keep = base + accepted + 1  # the trusted cache: prompt + out[:-1]
            t_caches = trim(t_caches, keep)
            d_len = min(d_len, keep)
            d_caches = trim(d_caches, d_len)
        return torch.tensor([out[:max_new_tokens]], dtype=torch.long, device=dev)

    @torch.no_grad()
    def _beam_search(self, input_ids, max_new_tokens, num_beams, length_penalty=0.0):
        """Beam search on naive caches.  The frontier is a fixed ``B * K``
        batch: expanded once after the prefill, then each step scores
        ``[B, K * V]`` in f32 log-softmax, keeps the top K, and reorders
        the caches by source beam (``index_select`` on the batch axis)."""
        cfg = self.config
        b, s0 = input_ids.shape
        K, V, dev = int(num_beams), cfg.vocab_size, self.device
        h, caches = _model_forward_cached(self.model, input_ids, _empty_caches(cfg, b, dev), 0)
        logp = torch.log_softmax(self._last_logits(h).float(), dim=-1)
        scores, first = torch.topk(logp, K)            # [B, K]: the K best first tokens
        beams = first[:, :, None]                      # [B, K, 1]
        caches = [(k.repeat_interleave(K, dim=0), v.repeat_interleave(K, dim=0))
                  for k, v in caches]
        rows = torch.arange(b, device=dev)[:, None] * K
        for step in range(1, max_new_tokens):
            tok = beams[:, :, -1].reshape(b * K, 1)
            h, caches = _model_forward_cached(self.model, tok, caches, s0 + step - 1)
            lp = torch.log_softmax(self._last_logits(h).float(), dim=-1)
            total = (scores.reshape(b * K, 1) + lp).reshape(b, K * V)
            scores, flat = torch.topk(total, K)        # [B, K]
            beam_idx = flat // V                       # the source beam of each winner
            beams = torch.cat([torch.take_along_dim(beams, beam_idx[:, :, None], dim=1),
                               (flat % V)[:, :, None]], dim=2)
            gather = (rows + beam_idx).reshape(-1)
            caches = [(k.index_select(0, gather), v.index_select(0, gather))
                      for k, v in caches]
        if length_penalty:
            # no EOS ends a beam here, so every beam has max_new_tokens
            # tokens and a shared divisor cannot reorder them
            warnings.warn("length_penalty has no effect without EOS-terminated beams "
                          "(all beams share length max_new_tokens)", stacklevel=3)
            scores = scores / (float(max_new_tokens) ** float(length_penalty))
        self._beam_scores = scores
        best = torch.argmax(scores, dim=1)             # [B]
        return torch.take_along_dim(beams, best[:, None, None], dim=1)[:, 0, :]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=16, cache: str = "paged",
                 block_size: int = 16, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 seed=None, decode_strategy=None, num_beams: int = 1,
                 length_penalty: float = 0.0, draft_model=None,
                 num_speculative_tokens: int = 4, decode_chunk=None, generator=None):
        """Incremental decoding of ``input_ids [B, S]`` (no padding):
        ``[B, max_new_tokens]`` new token ids.  Greedy by default;
        ``do_sample=True`` filters ``logits / temperature`` by ``top_k``,
        then ``top_p``, and draws by Gumbel-max through the counter-based
        sampler (``serving.sampling``): row i's key comes from ``seed`` and
        i, its counter is the token's index, so a stream depends on the
        seed alone (not on ``cache`` or ``decode_chunk``).  ``seed=None``
        draws the key from ``generator`` (torch's default CPU generator
        when None); greedy draws nothing.  ``num_beams > 1`` is beam
        search, ``draft_model`` greedy speculative decoding with
        ``num_speculative_tokens`` proposals a round; both run on naive
        caches.

        ``cache="naive"``: per-layer caches grown by concatenation.
        ``cache="paged"``: the prefill's K/V poured into per-sequence
        blocks of ``block_size``, then a macro-step of D tokens
        (``decode_chunk``, else ``FLAGS_decode_chunk``) over the paged
        decode layers.  On the card the D-token chunk is recorded as a
        CUDA graph at its first chunk in this call and replayed, when the
        call runs it more than once; a single D chunk and the tail
        (``max_new_tokens - 1`` mod D tokens) run through the eager body.
        ``self._decode_recordings`` keeps the recording's seconds, graph
        bytes and replays."""
        if decode_strategy is not None:
            if decode_strategy not in ("sampling", "greedy_search", "beam_search"):
                raise ValueError(
                    f"decode_strategy must be 'sampling', 'greedy_search' or "
                    f"'beam_search', got {decode_strategy!r}")
            do_sample = decode_strategy == "sampling"
        input_ids = torch.as_tensor(input_ids, device=self.device).long()
        if num_beams > 1:
            if do_sample:
                raise ValueError(
                    "num_beams > 1 is deterministic beam search; drop "
                    "do_sample/decode_strategy='sampling' (beam-sampling "
                    "is not implemented)")
            if draft_model is not None:
                raise ValueError(
                    "draft_model (speculative decoding) is greedy-only; drop num_beams")
            return self._beam_search(input_ids, max_new_tokens, num_beams=num_beams,
                                     length_penalty=length_penalty)
        if draft_model is not None:
            if do_sample:
                raise ValueError(
                    "speculative decoding is greedy-only here (sampling "
                    "needs rejection-sampling acceptance; drop do_sample)")
            if input_ids.shape[0] != 1:
                raise ValueError(
                    "speculative decoding supports batch size 1 at the "
                    "model-level API (per-row acceptance lengths diverge)")
            return self._speculative_decode(input_ids, max_new_tokens, draft_model,
                                            int(num_speculative_tokens))
        if do_sample and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        # checked before the prefill; FLAGS_decode_chunk clamps to 1 instead
        if decode_chunk is not None and int(decode_chunk) < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        cfg, dev = self.config, self.device
        b, s0 = input_ids.shape
        select = _Selector(cfg.vocab_size, b, dev, do_sample, temperature, top_k, top_p,
                           seed, generator)

        h, caches = _model_forward_cached(self.model, input_ids, _empty_caches(cfg, b, dev), 0)
        next_tok = select(self._last_logits(h), torch.zeros(b, dtype=torch.long, device=dev))
        out = [next_tok[:, None]]
        if cache == "naive":
            for step in range(1, max_new_tokens):
                h, caches = _model_forward_cached(self.model, out[-1], caches, s0 + step - 1)
                counter = torch.full((b,), step, dtype=torch.long, device=dev)
                out.append(select(self._last_logits(h), counter)[:, None])
            return torch.cat(out, dim=1)
        if cache != "paged":
            raise ValueError(f"cache must be 'naive' or 'paged', got {cache!r}")

        D = (int(decode_chunk) if decode_chunk is not None
             else max(1, int(_flags.flag("FLAGS_decode_chunk"))))
        sizes = [min(D, max_new_tokens - step) for step in range(1, max_new_tokens, D)]
        decoder = _PagedDecoder(self, caches, next_tok, s0, max_new_tokens, block_size, select,
                                sizes)
        out += [decoder.chunk(d) for d in sizes]
        self._decode_recordings = decoder.recordings()
        return torch.cat(out, dim=1)

    def _generate_eager(self, input_ids, **kw):
        """``generate()`` with the paged macro-step run through its eager
        body in place of the recordings: the yardstick the tests and the
        card checks hold the recording against, not a decoding option."""
        self._eager_decode = True
        try:
            return self.generate(input_ids, **kw)
        finally:
            self._eager_decode = False


def _empty_caches(config: LlamaConfig, batch, device):
    """Per-layer empty naive KV caches ``[(k, v)]``, each ``[B, 0, Nkv, H]``
    in the model's dtype (one constructor for generate, beam search and
    speculative decoding)."""
    nkv = config.num_key_value_heads
    head_dim = config.hidden_size // config.num_attention_heads
    return [(torch.zeros((batch, 0, nkv, head_dim), dtype=config.torch_dtype, device=device),) * 2
            for _ in range(config.num_hidden_layers)]


def filter_logits(logits, temperature=1.0, top_k=0, top_p=1.0):
    """``logits [B, V] / temperature`` in f32, with entries outside the top
    ``top_k`` (ties at the k-th value kept) and then outside the smallest
    descending prefix whose softmax mass reaches ``top_p`` (always at least
    one entry) set to -inf: the JAX package's ``generate`` filter."""
    lg = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(lg, min(int(top_k), lg.shape[-1]), dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, -math.inf, lg)
    if top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, srt, math.inf).amin(dim=-1, keepdim=True)
        lg = torch.where(lg < cutoff, -math.inf, lg)
    return lg


class _Selector:
    """``generate``'s next-token rule: ``(logits [B, V], counters [B])`` ->
    ids ``[B]``.  Greedy is the argmax; sampling is Gumbel-max over
    ``filter_logits`` with the uniforms of ``serving.sampling`` at (row
    key, counter).  Built before the prefill: a sampled call takes its
    seed (or one draw of ``generator``) here, a greedy one draws nothing."""

    def __init__(self, vocab_size, batch, device, do_sample, temperature, top_k, top_p, seed,
                 generator):
        self.do_sample = do_sample
        if not do_sample:
            return
        from paddle_tpu_torch.serving import _request_seed, sampling

        if seed is None:
            seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        self._sample = sampling.sample
        self.keys = torch.tensor([_request_seed(int(seed), row) for row in range(batch)],
                                 dtype=torch.long, device=device)
        self.vhash = sampling.vocab_hash(vocab_size, device)
        self.temps = torch.ones(batch, dtype=torch.float32, device=device)
        self.filter = (temperature, top_k, top_p)

    def __call__(self, logits, counters):
        if not self.do_sample:
            return torch.argmax(logits, dim=-1)
        lg = filter_logits(logits, *self.filter)
        return self._sample(lg, self.temps, self.keys, counters, self.vhash)


class _PagedDecoder:
    """``generate``'s paged decoding state: the prefill's caches poured into
    per-sequence pools (sequence i owns blocks ``[i * W, (i + 1) * W)``, a
    trivial allocator), and fixed buffers for the last token, the lengths
    and the token counter, which each chunk reads and advances in place.
    ``chunk(d)`` decodes d tokens for every row: a size this call runs
    more than once (``sizes``, the call's chunk sizes in order) goes
    through a recording of the d-token body, made at its first chunk,
    whose warm-up is that chunk; any other size, and every chunk of an
    eager run, through the body itself."""

    def __init__(self, model, caches, next_tok, s0, max_new_tokens, block_size, select, sizes):
        self.model, self.select = model, select
        self.eager = model._eager_decode
        self.recorded = {d for d in sizes if sizes.count(d) > 1}
        b = next_tok.shape[0]
        dev = next_tok.device
        w = -(-(s0 + max_new_tokens) // block_size)  # blocks a sequence
        self.tables = torch.arange(b * w, device=dev).reshape(b, w)
        self.kpools, self.vpools = [], []
        for k, v in caches:
            kp, vp = pa.alloc_paged_cache(b * w, k.shape[2], block_size, k.shape[3],
                                          dtype=k.dtype, device=dev)
            self.kpools.append(pa.paged_pour_prefill(kp, k, self.tables))
            self.vpools.append(pa.paged_pour_prefill(vp, v, self.tables))
        self.tok = next_tok[:, None].clone()
        self.lens = torch.full((b,), s0, dtype=torch.long, device=dev)
        self.counter = torch.ones(b, dtype=torch.long, device=dev)
        self._captured: dict = {}  # d -> graphs.Captured
        self._replays: dict = {}

    def _body(self, d):
        model, mm = self.model, self.model.model

        @torch.no_grad()
        def body():
            tok, lens, counter = self.tok, self.lens, self.counter
            out = []
            for _ in range(d):
                lens = lens + 1  # the new token occupies position lens - 1
                h, kp, vp = _decode_layers_paged(mm.layers, mm.embed_tokens(tok), mm.rope_cos,
                                                 mm.rope_sin, self.kpools, self.vpools,
                                                 self.tables, lens)
                if any(a is not b for a, b in zip(kp + vp, self.kpools + self.vpools)):
                    raise RuntimeError("a pool write returned a new pool: a recorded chunk "
                                       "must write the pools in place")
                nxt = self.select(model._last_logits(mm.norm(h)), counter)
                counter = counter + 1
                tok = nxt[:, None]
                out.append(nxt)
            self.tok.copy_(tok)
            self.lens.copy_(lens)
            self.counter.copy_(counter)
            return torch.stack(out, dim=1)

        return body

    def chunk(self, d):
        if self.eager or d not in self.recorded:
            return self._body(d)()
        cap = self._captured.get(d)
        if cap is None:
            cap = self._captured[d] = graphs.capture(self._body(d), self.tok.device)
            self._replays[d] = 0
            if cap.warm_outputs is not None:  # the card: the warm-up was this chunk
                return cap.warm_outputs
        self._replays[d] += 1
        return cap.replay().clone()  # the next replay overwrites the graph's output

    def recordings(self):
        return {d: {"capture_s": c.capture_s, "graph_bytes": c.graph_bytes,
                    "replays": self._replays[d]} for d, c in self._captured.items()}


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


def _proj_lora(proj, x, ad, name, slots, scaling):
    """A target projection's output, plus its gathered per-row adapter
    delta when the pack covers it (``nn.lora.lora_delta``)."""
    out = proj(x)
    if ad is not None and name in ad:
        out = out + lora_delta(x, *ad[name], slots, scaling)
    return out


def _mlp_paged(mlp, x, ad, slots, scaling):
    """``mlp(x)``, with the adapter deltas on gate_up and down when the
    pack covers them (``LlamaMLP.forward``'s ops otherwise)."""
    if ad is None or ("mlp.gate_up_proj" not in ad and "mlp.down_proj" not in ad):
        return mlp(x)
    act = ops.swiglu(_proj_lora(mlp.gate_up_proj, x, ad, "mlp.gate_up_proj", slots, scaling))
    return _proj_lora(mlp.down_proj, act, ad, "mlp.down_proj", slots, scaling)


def _decode_layer_paged(layer, h, cos, sin, kc, vc, tables, lens, chain_cfg=None, ad=None,
                        slots=None, scaling=None):
    """One decoder layer on one new token against the paged KV pools.

    h ``[B, 1, D]``; kc/vc pools ``[num_blocks, Nkv, bs, H]`` or QuantPools
    (written in place); tables ``[B, max_blocks]``; lens ``[B]`` lengths
    including this token.  ``chain_cfg``: an accepted decode-chain config
    (ops/decode_chain.py); the write, write, attend below then runs as one
    kernel.  Only the serving engine passes it, after the measured-win
    gate.  ``ad`` / ``slots`` / ``scaling``: multi-tenant LoRA, ``ad``
    mapping target paths to this layer's slot-stacked ``(A [S, in, r], B
    [S, r, out])``, ``slots [B]`` each row's slot and ``scaling [B]`` its
    alpha / rank; the projections get their deltas before the chain (slot
    0 rows add zeros).  Returns ``(h', kc, vc)``."""
    attn = layer.self_attn
    residual = h
    x = layer.input_layernorm(h)
    b = x.shape[0]
    n, nkv, hd = attn.num_heads, attn.num_kv_heads, attn.head_dim
    qv = _proj_lora(attn.q_proj, x, ad, "self_attn.q_proj", slots, scaling).reshape(b, n, hd)
    kv_ = _proj_lora(attn.k_proj, x, ad, "self_attn.k_proj", slots, scaling).reshape(b, nkv, hd)
    vv = _proj_lora(attn.v_proj, x, ad, "self_attn.v_proj", slots, scaling).reshape(b, nkv, hd)
    pos = lens - 1
    qv = pa.rope_rotate_by_position(qv, cos, sin, pos)
    kv_ = pa.rope_rotate_by_position(kv_, cos, sin, pos)
    if chain_cfg is not None:
        o, kc, vc = dc.fused_decode_step(kc, vc, qv, kv_, vv, tables, lens, config=chain_cfg)
    else:
        kc = pa.paged_write(kc, kv_, tables, pos)
        vc = pa.paged_write(vc, vv, tables, pos)
        o = pa.paged_decode_attention(qv, kc, vc, tables, lens)
    o = _proj_lora(attn.o_proj, o.reshape(b, 1, n * hd), ad, "self_attn.o_proj", slots, scaling)
    x, h = layer.post_attention_layernorm.add_norm(o, residual)
    return h + _mlp_paged(layer.mlp, x, ad, slots, scaling), kc, vc


def _decode_layer_paged_chunk(layer, h, cos, sin, kc, vc, tables, lens, ad=None, slots=None,
                              scaling=None):
    """One decoder layer on a T-token chunk against the paged KV pools (the
    speculative verify).  h ``[B, T, D]``; lens ``[B]`` lengths including
    all T chunk tokens: chunk token j sits at position ``lens - T + j``.
    The chunk's K/V are written in place (int8 pools through the chunk
    write's running-max scales), then every token attends the cache up to
    its own position.  ``ad`` / ``slots`` / ``scaling`` as in
    ``_decode_layer_paged``.  Returns ``(h', kc, vc)``."""
    attn = layer.self_attn
    residual = h
    x = layer.input_layernorm(h)
    b, t = x.shape[0], x.shape[1]
    n, nkv, hd = attn.num_heads, attn.num_kv_heads, attn.head_dim
    qv = _proj_lora(attn.q_proj, x, ad, "self_attn.q_proj", slots, scaling).reshape(b, t, n, hd)
    kv_ = _proj_lora(attn.k_proj, x, ad, "self_attn.k_proj", slots,
                     scaling).reshape(b, t, nkv, hd)
    vv = _proj_lora(attn.v_proj, x, ad, "self_attn.v_proj", slots,
                    scaling).reshape(b, t, nkv, hd)
    pos = lens[:, None] - t + torch.arange(t, dtype=lens.dtype, device=lens.device)[None, :]
    qv = pa.rope_rotate_chunk(qv, cos, sin, pos)
    kv_ = pa.rope_rotate_chunk(kv_, cos, sin, pos)
    kc = pa.paged_write_chunk(kc, kv_, tables, pos)
    vc = pa.paged_write_chunk(vc, vv, tables, pos)
    o = pa.paged_chunk_attention(qv, kc, vc, tables, lens)
    o = _proj_lora(attn.o_proj, o.reshape(b, t, n * hd), ad, "self_attn.o_proj", slots, scaling)
    x, h = layer.post_attention_layernorm.add_norm(o, residual)
    return h + _mlp_paged(layer.mlp, x, ad, slots, scaling), kc, vc


def _decode_layers_paged(layers, h, cos, sin, kpools, vpools, tables, lens, chain_cfg=None,
                         chunk=False, adapters=None, slots=None, scaling=None):
    """Every decoder layer's paged decode step over per-layer pool lists,
    each through the accepted decode-chain config when one is given.
    ``chunk=True`` runs the T-token layer (``_decode_layer_paged_chunk``);
    the decode chain covers the single-token step only, so a
    ``chain_cfg`` with it raises ``ValueError``.  ``adapters`` maps target
    paths to the pack's ``(A [L, S, in, r], B [L, S, r, out])``; each layer
    reads its slice, with ``slots [B]`` and ``scaling [B]`` a row.
    Returns ``(h, kpools, vpools)``."""
    if chunk and chain_cfg is not None:
        raise ValueError("decode-chain fusion covers the single-token step only; "
                         "chunked/verify paths must not pass chain_cfg")
    new_k, new_v = [], []
    for li, (layer, kc, vc) in enumerate(zip(layers, kpools, vpools)):
        ad = (None if adapters is None else
              {t: (a[li], b[li]) for t, (a, b) in adapters.items()})
        if chunk:
            h, kc, vc = _decode_layer_paged_chunk(layer, h, cos, sin, kc, vc, tables, lens,
                                                  ad, slots, scaling)
        else:
            h, kc, vc = _decode_layer_paged(layer, h, cos, sin, kc, vc, tables, lens,
                                            chain_cfg, ad, slots, scaling)
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
