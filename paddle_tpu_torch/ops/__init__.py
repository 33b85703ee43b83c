"""paddle_tpu_torch.ops — the kernels written by hand for Hopper.

Counterpart of paddle_tpu/ops, whose kernels are Pallas kernels for the
TPU.  Each op here ships two implementations in its module:

- a kernel written by hand for the H100 (CUDA C++ under ``csrc/``, built
  with nvcc at first use, or Triton where the module says why);
- a plain PyTorch version with the kernel's semantics (f32 inside, one
  cast at the end), which the CPU tests hold against the JAX package.

Dispatch rule (replaces ``paddle_tpu.ops.use_pallas()``): a CUDA tensor
launches the kernel, a CPU tensor takes the plain version.  There is no
flag that turns the kernels off on the card and no fallback: a CUDA
tensor the kernel cannot take raises.

Every wrapper adds one to its launch counter where it launches its
kernel, and nowhere else, so a run can show that a path went through it.
An op with two routes (a TMA/wgmma kernel for the layouts TMA reads and a
general one for the rest: the flash kernels, the prefill chain, the
matmul epilogue, the decode chains) counts every launch under its name and
the Hopper kernel's also under the name with ``_sm90``.
The Triton RMSNorm and SwiGLU kernels that ``csrc/norm_swiglu.cu``
replaced stay as yardsticks for the timing scripts; they count under
``yardstick_counts()``, never under ``launch_counts()``.
The training kernels are ``torch.autograd.Function``s on both devices, so
gradients reach the parameters below a kernel; the serving chains of
``decode_chain`` run under ``no_grad`` only.
"""

from __future__ import annotations

import functools

import torch

H100_SMS = 132  # the card the port targets: its SM count where no card is present

_LAUNCHES = {"fused_rms_norm": 0, "swiglu": 0, "flash_attention_fwd": 0,
             "flash_attention_fwd_sm90": 0, "flash_attention_bwd_dq": 0,
             "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq_sm90": 0,
             "flash_attention_bwd_dkv_sm90": 0, "decode_chain_batch": 0, "decode_chain_rows": 0,
             "decode_chain_batch_sm90": 0, "decode_chain_rows_sm90": 0, "prefill_chain": 0,
             "prefill_chain_sm90": 0, "fused_layer_norm": 0,
             "matmul_epilogue": 0, "matmul_epilogue_sm90": 0, "vpu_chain": 0,
             "sched_chain": 0, "sched_chain_ktiled": 0}
_YARDSTICKS = {"fused_rms_norm_triton": 0, "swiglu_triton": 0}


def launch_counts() -> dict:
    """Kernel launches per op since the last `reset_launch_counts`."""
    return dict(_LAUNCHES)


def yardstick_counts() -> dict:
    """Launches of the replaced kernels kept as yardsticks, since the last
    `reset_launch_counts` (0 on every main path)."""
    return dict(_YARDSTICKS)


def reset_launch_counts():
    for counts in (_LAUNCHES, _YARDSTICKS):
        for name in counts:
            counts[name] = 0


def count_launch(name: str):
    _LAUNCHES[name] += 1


def count_yardstick(name: str):
    _YARDSTICKS[name] += 1


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every tensor lies on the CPU (take the plain version) or is
    a meta tensor (a static Program's shape inference: the plain version
    computes nothing there)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds in ({"cpu"}, {"meta"}):  # meta: shape inference while a Program is captured
        return False
    raise ValueError(f"tensors lie on mixed or unsupported devices: {sorted(kinds)}")


def sm_count(device) -> int:
    """The SM count of a CUDA device; the H100's where there is no card
    (the search's cost model and the launch rules on the CPU).  Cached:
    the RMSNorm wrapper asks at every launch."""
    device = torch.device(device)
    if device.type == "cuda":
        return _cuda_sms(torch.cuda.current_device() if device.index is None else device.index)
    return H100_SMS


@functools.lru_cache(maxsize=None)
def _cuda_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


from .flash_attention import (flash_attention, flash_attention_bwd,  # noqa: E402,F401
                              flash_attention_bwd_reference, flash_attention_fwd,
                              flash_attention_reference)
from .fused_norm import fused_layer_norm, fused_rms_norm  # noqa: E402,F401
from .matmul_epilogue import matmul_bias_act  # noqa: E402,F401
from .swiglu import swiglu  # noqa: E402,F401
