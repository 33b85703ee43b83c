"""Carry weights from the JAX package into the port.

``load_jax_state_dict(model, arrays)`` takes ``{key: np.ndarray}`` with the
same keys as the JAX model's ``state_dict()`` (for example
``model.layers.0.mlp.gate_up_proj.weight``) and copies each array into the
port's parameter or buffer of that name, with no transpose: both packages
keep Paddle's ``[in_features, out_features]`` Linear layout and the
``[out, in / groups, *kernel]`` convolution layout (a model after
``apply_lora`` has the JAX model's ``lora_A`` / ``lora_B`` keys too; a
ResNet's BatchNorms carry ``_mean`` / ``_variance``).
``load_jax_adapter(arrays, dtype=, device=)`` carries an adapter-only
state dict (the JAX package's ``lora_state_dict``) across, for
``GenerationEngine.register_adapter``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_state_dict", "load_jax_adapter"]


def _to_torch(value) -> torch.Tensor:
    """An array as a host tensor; a numpy dtype torch cannot take
    (``ml_dtypes.bfloat16`` from JAX) passes through float32, which holds
    every bf16 value exactly."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16" or arr.dtype.kind not in "biuf":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


def load_jax_adapter(arrays: dict, dtype=None, device=None) -> dict:
    """An adapter-only state dict from the JAX package (``{key: array}``
    with ``...lora_A`` / ``...lora_B`` keys, numpy in) as torch tensors in
    ``dtype`` (default: the arrays' own, bf16 arrays as float32) on
    ``device`` (default: the CPU).  Other keys raise ``KeyError``."""
    odd = sorted(k for k in arrays if k.rsplit(".", 1)[-1] not in ("lora_A", "lora_B"))
    if odd:
        raise KeyError(f"not adapter keys (lora_A / lora_B): {odd}")
    out = {}
    for key, value in arrays.items():
        t = _to_torch(value)
        out[key] = t.to(device=device if device is not None else "cpu",
                        dtype=dtype if dtype is not None else t.dtype)
    return out


def load_jax_state_dict(model: torch.nn.Module, arrays: dict) -> torch.nn.Module:
    """Copy ``arrays`` into ``model`` in place.  An unknown or a missing key
    raises ``KeyError``; a shape mismatch raises ``ValueError``.  Arrays
    in a numpy dtype torch cannot take (``ml_dtypes.bfloat16`` from JAX)
    pass through float32, which holds every bf16 value exactly."""
    targets = model.state_dict()
    unknown = sorted(set(arrays) - set(targets))
    missing = sorted(set(targets) - set(arrays))
    if unknown or missing:
        raise KeyError(f"state dict keys differ: unknown {unknown}, missing {missing}")
    with torch.no_grad():
        for key, value in arrays.items():
            t = _to_torch(value)
            target = targets[key]
            if tuple(t.shape) != tuple(target.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} != {tuple(target.shape)}")
            target.copy_(t.to(target.dtype))
    return model
