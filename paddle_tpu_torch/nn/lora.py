"""LoRA: low-rank adapters for fine-tuning and multi-tenant serving
(counterpart of paddle_tpu/nn/lora.py).

Two faces, one math (``h += (x @ A) @ B * alpha / rank``):

- **Training** (``LoRALinear``, ``apply_lora``): target ``Linear`` layers
  are replaced in place by ``LoRALinear``s that adopt the base ``weight``
  and ``bias`` Parameter objects, so every state-dict key stays as it was
  and only ``lora_A`` / ``lora_B`` are added; the base is frozen
  (``requires_grad_(False)``), so a ``TrainStep`` over the model trains
  the adapters alone.  ``merge()`` / ``unmerge()`` fold the adapter into
  the base weight in place; ``lora_state_dict`` is the adapter-only state
  dict a serving engine registers.

- **Serving** (``AdapterPack``): the A/B matrices of up to
  ``FLAGS_lora_max_adapters`` adapters stacked on a slot axis, per decoder
  layer.  The decode step gathers each batch row's A/B by a slot index
  (``lora_delta``), so a macro-step of different tenants decodes as one
  step.  Slot 0 is the zero adapter (A = B = scaling = 0): base-model rows
  ride the same step as an exact identity.  The JAX package's decode step
  takes the pack as arguments, so a hot swap changes values and never
  shapes.  Here the captured decode step (a CUDA graph) reads the pack at
  fixed addresses, so ``set_slot`` / ``clear_slot`` write its tensors in
  place and never rebind one: the next replay decodes with the new
  adapter, and nothing is recorded again.

The adapter delta is a rank-r batched product, plain torch here as it is
plain jnp in the JAX package; no kernel of the port lies on it.  The
LayerStack layout (``nn.LayerStack``) is not ported (ROADMAP.md A.3.4),
and tensor-parallel packs (``place_over_mesh``) are A.6.
"""

from __future__ import annotations

import contextlib
import re

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch._core import flags as _flags
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.common import Linear

__all__ = ["LoRALinear", "AdapterPack", "apply_lora", "lora_state_dict",
           "parse_adapter_state_dict", "adapter_prefill_scope", "lora_delta",
           "DEFAULT_TARGET_NAMES", "LLAMA_TARGETS"]

# Leaf layer names apply_lora targets by default: the attention q/k/v/out
# and MLP projections of the LLaMA and GPT models.
DEFAULT_TARGET_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "out_proj",
    "gate_up_proj", "down_proj", "fc_in", "fc_out",
)

# The per-decoder-layer projections the serving AdapterPack covers: the
# injection points of models/llama._decode_layer_paged.
LLAMA_TARGETS = (
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
    "self_attn.o_proj", "mlp.gate_up_proj", "mlp.down_proj",
)

_STACK_ITEM = "ROADMAP.md A.3.4 (the LayerStack layout)"
_DIST_ITEM = "ROADMAP.md A.6 (distributed)"


class LoRALinear(Linear):
    """``Linear`` plus a rank-``r`` adapter: ``y = xW + b + (x A) B s`` with
    ``s = alpha / rank``.  ``lora_A`` ``[in, r]`` starts from a normal of
    std 0.02 and ``lora_B`` ``[r, out]`` from zeros, so the adapted layer
    starts exactly at the base layer."""

    def __init__(self, in_features, out_features, rank, alpha=None, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None, generator=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         bias_attr=bias_attr, device=device, dtype=dtype, generator=generator)
        self._init_adapter(rank, alpha, generator)

    def _init_adapter(self, rank, alpha, generator):
        rank = int(rank)
        if rank < 1:
            raise ValueError(f"LoRA rank must be >= 1, got {rank}")
        self.rank = rank
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self.scaling = self.alpha / self.rank
        self.merged = False
        kw = {"device": self.weight.device, "dtype": self.weight.dtype}
        self.lora_A = nn.Parameter(torch.empty((self.in_features, rank), **kw))
        self.lora_B = nn.Parameter(torch.zeros((rank, self.out_features), **kw))
        with torch.no_grad():
            self.lora_A.normal_(0.0, 0.02, generator=generator)

    @classmethod
    def from_linear(cls, linear: Linear, rank, alpha=None, generator=None) -> "LoRALinear":
        """Wrap an existing Linear: its ``weight`` and ``bias`` Parameter
        objects are adopted (no copy: an optimizer holding them still
        does), and the adapter is created in the weight's dtype and on its
        device."""
        m = cls.__new__(cls)
        nn.Module.__init__(m)
        m.in_features, m.out_features = linear.in_features, linear.out_features
        m.weight = linear.weight
        m.bias = linear.bias
        m._init_adapter(rank, alpha, generator)
        m.train(linear.training)
        return m

    def forward(self, x):
        out = F.linear(x, self.weight, self.bias)
        if self.merged:
            return out
        return out + F.linear(F.linear(x, self.lora_A), self.lora_B) * self.scaling

    def _delta_weight(self):
        return (self.lora_A @ self.lora_B) * torch.tensor(self.scaling, dtype=self.lora_A.dtype,
                                                          device=self.lora_A.device)

    @torch.no_grad()
    def merge(self):
        """Fold ``A @ B * s`` into the base weight, in place (adapter-free
        serving of the adapted function).  Idempotent."""
        if not self.merged:
            self.weight.add_(self._delta_weight().to(self.weight.dtype))
            self.merged = True
        return self

    @torch.no_grad()
    def unmerge(self):
        """The inverse of ``merge``."""
        if self.merged:
            self.weight.sub_(self._delta_weight().to(self.weight.dtype))
            self.merged = False
        return self

    def extra_repr(self):
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"rank={self.rank}, alpha={self.alpha}")


def apply_lora(model, rank, alpha=None, targets=None, freeze_base=True, generator=None):
    """Replace every target ``Linear`` of ``model`` by a ``LoRALinear`` (in
    place) and, with ``freeze_base``, freeze every parameter that was there
    before (``requires_grad_(False)``): a ``TrainStep`` over the model then
    trains only the adapters, and the optimizer skips the frozen base.
    ``targets``: leaf layer names (default ``DEFAULT_TARGET_NAMES``).
    Returns the model."""
    targets = tuple(targets) if targets is not None else DEFAULT_TARGET_NAMES
    if getattr(getattr(model, "config", None), "fuse_layer_stack", False):
        raise NotImplementedError(f"apply_lora over a LayerStack model is not ported yet "
                                  f"({_STACK_ITEM})")
    if freeze_base:
        for p in model.parameters():
            p.requires_grad_(False)
    replaced = 0
    for _path, sub in list(model.named_modules()):
        for name, child in list(sub.named_children()):
            if name in targets and isinstance(child, Linear) \
                    and not isinstance(child, LoRALinear):
                setattr(sub, name, LoRALinear.from_linear(child, rank, alpha=alpha,
                                                          generator=generator))
                replaced += 1
    if not replaced:
        raise ValueError(f"apply_lora: no Linear layer named any of {targets} found")
    return model


def lora_state_dict(model) -> dict:
    """The adapter-only state dict: every ``*.lora_A`` / ``*.lora_B`` entry
    of ``model.state_dict()``, what a serving engine registers
    (``GenerationEngine.register_adapter``)."""
    out = {k: v for k, v in model.state_dict().items()
           if k.rsplit(".", 1)[-1] in ("lora_A", "lora_B")}
    if not out:
        raise ValueError("lora_state_dict: model has no LoRA parameters (run apply_lora first)")
    return out


_LAYER_KEY = re.compile(r"(?:^|\.)layers\.(\d+)\.(.+)\.lora_([AB])$")


def _host(value) -> torch.Tensor:
    """A state-dict value (a torch tensor on any device, or an array) as a
    host tensor in its own dtype."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def parse_adapter_state_dict(state_dict, num_layers, targets, rank):
    """An adapter state dict as stacked host tensors for an AdapterPack.

    Keys like ``model.layers.{i}.self_attn.q_proj.lora_A`` group into
    ``{target: (A [L, in, r], B [L, r, out])}``.  A target the adapter
    omits is absent (``set_slot`` zeroes it); layers it omits are zeros.
    A key naming a projection outside ``targets``, a layer past
    ``num_layers``, a rank other than ``rank``, or a layer holding only one
    of ``lora_A`` / ``lora_B`` raises ``ValueError``."""
    per = {}
    for key, val in state_dict.items():
        m = _LAYER_KEY.search(key)
        if m is None:
            if key.rsplit(".", 1)[-1] in ("lora_A", "lora_B"):
                raise ValueError(f"adapter key {key!r} does not name a decoder layer "
                                 "(expected ...layers.<i>.<proj>.lora_A/B)")
            continue
        li, target, which = int(m.group(1)), m.group(2), m.group(3)
        if target not in targets:
            raise ValueError(f"adapter key {key!r} targets {target!r}, which this pack's "
                             f"geometry does not cover (targets={targets})")
        if li >= num_layers:
            raise ValueError(f"adapter key {key!r}: layer {li} >= num_layers {num_layers}")
        t = _host(val)
        r = t.shape[-1] if which == "A" else t.shape[0]
        if r != rank:
            raise ValueError(f"adapter rank {r} (key {key!r}) != pack rank {rank}: the pack's "
                             "geometry is fixed at engine construction")
        per.setdefault(target, {})[(li, which)] = t
    out = {}
    for target, entries in per.items():
        # A and B pair up per layer: a layer holding one half (a truncated
        # checkpoint) would otherwise serve a crippled delta
        layers_a = {i for (i, w) in entries if w == "A"}
        layers_b = {i for (i, w) in entries if w == "B"}
        if layers_a != layers_b:
            raise ValueError(f"adapter state dict for {target!r} is lopsided: layers "
                             f"{sorted(layers_a ^ layers_b)} hold only one of lora_A/lora_B; "
                             "every layer must carry both (or neither)")
        a0 = next(v for (_, w), v in entries.items() if w == "A")
        b0 = next(v for (_, w), v in entries.items() if w == "B")
        out[target] = (torch.stack([entries.get((i, "A"), torch.zeros_like(a0))
                                    for i in range(num_layers)]),
                       torch.stack([entries.get((i, "B"), torch.zeros_like(b0))
                                    for i in range(num_layers)]))
    if not out:
        raise ValueError("adapter state dict holds no lora_A/lora_B keys")
    return out


def _resolve_sublayer(layer, path):
    out = layer
    for part in path.split("."):
        out = getattr(out, part)
    return out


class AdapterPack:
    """Slot-stacked adapter storage for the serving decode step.

    Per target projection ``t``: ``ab[t] = (A [L, S, in, r], B [L, S, r,
    out])`` in the projection's dtype, plus ``scaling`` ``[S]`` f32
    (``alpha / rank`` a slot), all allocated once on the model's device.
    Slot 0 is the zero adapter; ``max_adapters`` (default
    ``FLAGS_lora_max_adapters``) slots follow it.  The geometry never
    changes, and ``set_slot`` / ``clear_slot`` write the tensors in place
    (a captured step reads them at fixed addresses)."""

    def __init__(self, model, rank, alpha=None, max_adapters=None, targets=None):
        layers = model.model.layers
        if not isinstance(layers, (nn.ModuleList, list, tuple)):
            raise NotImplementedError(f"an AdapterPack over a LayerStack is not ported yet "
                                      f"({_STACK_ITEM})")
        self.num_layers = len(layers)
        self.rank = int(rank)
        if self.rank < 1:
            raise ValueError(f"AdapterPack rank must be >= 1, got {rank}")
        self.alpha = float(alpha) if alpha is not None else float(rank)
        n_ad = (int(max_adapters) if max_adapters is not None
                else int(_flags.flag("FLAGS_lora_max_adapters")))
        if n_ad < 1:
            raise ValueError(f"max_adapters (FLAGS_lora_max_adapters) must be >= 1, got {n_ad}")
        self.num_slots = n_ad + 1  # slot 0 = the zero adapter
        self.targets = tuple(targets) if targets is not None else LLAMA_TARGETS
        L, S, r = self.num_layers, self.num_slots, self.rank
        self.ab = {}
        for t in self.targets:
            lin = _resolve_sublayer(layers[0], t)
            if not isinstance(lin, Linear):
                raise TypeError(f"AdapterPack target {t!r} is {type(lin).__name__}, "
                                "expected nn.Linear")
            kw = {"dtype": lin.weight.dtype, "device": lin.weight.device}
            self.ab[t] = (torch.zeros((L, S, lin.in_features, r), **kw),
                          torch.zeros((L, S, r, lin.out_features), **kw))
        self.device = model.device
        self.scaling = torch.zeros((S,), dtype=torch.float32, device=self.device)

    def place_over_mesh(self, *args, **kwargs):
        raise NotImplementedError(f"tensor-parallel adapter packs (place_over_mesh) are not "
                                  f"ported yet ({_DIST_ITEM})")

    @property
    def nbytes(self) -> int:
        return (sum(a.numel() * a.element_size() + b.numel() * b.element_size()
                    for a, b in self.ab.values())
                + self.scaling.numel() * self.scaling.element_size())

    def parts(self):
        """``[(name, tensor)]`` leaves of the pack."""
        out = [(f"adapter.{t}.{w}", x) for t, (a, b) in sorted(self.ab.items())
               for w, x in (("A", a), ("B", b))]
        out.append(("adapter.scaling", self.scaling))
        return out

    def _check_slot(self, slot):
        slot = int(slot)
        if not 1 <= slot < self.num_slots:
            raise IndexError(f"slot {slot} out of range [1, {self.num_slots}) (slot 0 is the "
                             "reserved base-model identity)")
        return slot

    @torch.no_grad()
    def set_slot(self, slot, arrays, alpha=None):
        """Install an adapter (``parse_adapter_state_dict``'s output) into
        ``slot``, in place; targets it omits are zeroed.  Every target is
        validated before anything is written, so a refused adapter leaves
        the slot as it was."""
        slot = self._check_slot(slot)
        for t, (A, B) in self.ab.items():
            if t not in arrays:
                continue
            na, nb = arrays[t]
            want_a, want_b = (A.shape[0],) + tuple(A.shape[2:]), (B.shape[0],) + tuple(B.shape[2:])
            if tuple(na.shape) != want_a or tuple(nb.shape) != want_b:
                raise ValueError(f"adapter for {t!r} has shapes A{tuple(na.shape)}/"
                                 f"B{tuple(nb.shape)}, pack slot expects A{want_a}/B{want_b}")
        for t, (A, B) in self.ab.items():
            if t in arrays:
                na, nb = arrays[t]
                A[:, slot].copy_(na)
                B[:, slot].copy_(nb)
            else:
                A[:, slot].zero_()
                B[:, slot].zero_()
        a = float(alpha) if alpha is not None else self.alpha
        self.scaling[slot].fill_(a / self.rank)
        return self

    @torch.no_grad()
    def clear_slot(self, slot):
        """Zero ``slot`` back to the identity adapter, in place."""
        slot = self._check_slot(slot)
        for A, B in self.ab.values():
            A[:, slot].zero_()
            B[:, slot].zero_()
        self.scaling[slot].fill_(0.0)
        return self


def lora_delta(x, A, B, slots, scaling):
    """The decode step's per-row adapter delta.

    x ``[B, T, in]``; A ``[S, in, r]`` and B ``[S, r, out]`` (one layer's
    slot-stacked matrices); slots ``[B]`` int64, each row's slot; scaling
    ``[B]`` f32, each row's ``alpha / rank``.  Gathers each row's A and B
    and returns ``(x @ A_s) @ B_s * s`` in x's dtype; slot 0 gathers zeros,
    an exact additive identity."""
    ag = A.index_select(0, slots)                # [B, in, r]
    bg = B.index_select(0, slots)                # [B, r, out]
    d = torch.bmm(torch.bmm(x.to(A.dtype), ag), bg)
    return (d * scaling[:, None, None].to(d.dtype)).to(x.dtype)


def _prefill_hook(pack, target, slot, li):
    A, B = pack.ab[target]
    a, b, scale = A[li, slot], B[li, slot], pack.scaling[slot]

    def hook(_module, inputs, out):
        d = (inputs[0].to(a.dtype) @ a) @ b
        return out + (d * scale.to(d.dtype)).to(out.dtype)

    return hook


@contextlib.contextmanager
def adapter_prefill_scope(layers, pack: AdapterPack, slot: int):
    """Apply ``slot``'s adapter during an eager prefill forward: a forward
    hook on every pack target of every decoder layer adds ``(x @ A[l,
    slot]) @ B[l, slot] * s`` to its output.  Slot 0 installs no hooks
    (the exact base-model prefill)."""
    if not isinstance(layers, (nn.ModuleList, list, tuple)):
        raise NotImplementedError(f"adapter prefill over a LayerStack is not ported yet "
                                  f"({_STACK_ITEM})")
    handles = []
    if slot == 0:
        yield
        return
    try:
        for li, blk in enumerate(layers):
            for t in pack.targets:
                handles.append(_resolve_sublayer(blk, t).register_forward_hook(
                    _prefill_hook(pack, t, slot, li)))
        yield
    finally:
        for h in handles:
            h.remove()
