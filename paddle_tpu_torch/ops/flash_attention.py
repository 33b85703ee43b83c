"""Flash attention forward: a CUDA C++ kernel for Hopper beside its plain
version.

Counterpart of paddle_tpu/ops/flash_attention.py.  The kernel
(``csrc/flash_attention_fwd.cu``, whose header says what bounds it and
how it is built) replaces the TPU forward kernel ``_fwd_kernel``.  The
public layout is Paddle's ``[B, S, N, H]``; the kernel reads it through
its strides instead of transposing to ``[B, N, S, H]``.

Semantics kept from the TPU kernel: causal is bottom-right aligned when
Sq != Sk (query row i sees keys j <= i + Sk - Sq); masked scores take
-0.7 * f32max; a row whose sum is 0 divides by 1; ``scale`` defaults to
1/sqrt(H); GQA reads kv-head ``n // (N // Nkv)``.  Unlike the TPU path,
lengths that are not a block multiple are masked inside the kernel
instead of falling back to the O(S^2) reference.  The logsumexp comes out
as f32 ``[B, N, Sq]`` for the backward kernels of the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import count_launch, use_kernel

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_reference"]

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_LIB_NAME = "flash_attention_fwd"
_FN = None


def _fn():
    global _FN
    if _FN is None:
        from ._cuda_build import load

        fn = load(_LIB_NAME).paddle_flash_attention_fwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, N, H]")
    b, _, n, h = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != h:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if n % k.shape[2]:
        raise ValueError(f"flash_attention: {n} q heads are not a multiple of "
                         f"{k.shape[2]} kv heads")


def _reference_with_lse(q, k, v, causal, scale):
    qt = q.transpose(1, 2).float()
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    group = qt.shape[1] // kt.shape[1]
    if group > 1:
        kt = kt.repeat_interleave(group, dim=1)
        vt = vt.repeat_interleave(group, dim=1)
    logits = torch.einsum("bnqh,bnkh->bnqk", qt, kt) * scale
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        allowed = torch.ones((qlen, klen), dtype=torch.bool, device=q.device).tril(klen - qlen)
        logits = logits.masked_fill(~allowed, DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bnkh->bnqh", probs, vt)
    return out.transpose(1, 2).to(q.dtype), lse


def flash_attention_reference(q, k, v, *, causal=False, scale=None):
    """Plain PyTorch oracle with the kernel's semantics ([B, S, N, H]):
    f32 scores and softmax, one cast at the end."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _reference_with_lse(q, k, v, bool(causal), float(scale))[0]


def _flash_cuda(q, k, v, causal, scale):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: the kernel takes bf16, {name} is {t.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs unit stride on H, strides that "
                             "are multiples of 8 elements and a 16-byte aligned base")
    b, sq, n, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if h not in (64, 128):
        raise ValueError(f"flash_attention: head_dim {h} is not 64 or 128")
    out = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0:
        return out, lse
    if sk == 0:
        raise ValueError("flash_attention: no keys")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    b, sq, sk, n, nkv, h,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                    float(scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    count_launch("flash_attention_fwd")
    return out, lse


def flash_attention_fwd(q, k, v, *, causal=False, scale=None):
    """``(out [B, Sq, N, H], lse f32 [B, N, Sq])`` for q ``[B, Sq, N, H]``
    and k/v ``[B, Sk, Nkv, H]``."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if use_kernel(q, k, v):
        return _flash_cuda(q, k, v, bool(causal), float(scale))
    return _reference_with_lse(q, k, v, bool(causal), float(scale))


def flash_attention(q, k, v, *, causal=False, scale=None):
    """Blockwise flash attention, q/k/v in ``[B, S, N, H]``."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
