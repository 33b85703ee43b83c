"""Carry weights from the JAX package into the port.

``load_jax_state_dict(model, arrays)`` takes ``{key: np.ndarray}`` with the
same keys as the JAX model's ``state_dict()`` (for example
``model.layers.0.mlp.gate_up_proj.weight``) and copies each array into the
port's parameter of that name, with no transpose: both packages keep
Paddle's ``[in_features, out_features]`` Linear layout.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_state_dict"]


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
            arr = np.asarray(value)
            if arr.dtype.name == "bfloat16" or arr.dtype.kind not in "biuf":
                arr = arr.astype(np.float32)
            target = targets[key]
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{key}: shape {arr.shape} != {tuple(target.shape)}")
            target.copy_(torch.from_numpy(np.array(arr)).to(target.dtype))
    return model
