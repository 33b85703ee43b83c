"""Flash attention: CUDA C++ kernels for Hopper beside their plain
versions, joined by a ``torch.autograd.Function``.

Counterpart of paddle_tpu/ops/flash_attention.py.  Two forward kernels
replace the TPU kernel ``_fwd_kernel``: ``csrc/flash_attention_fwd_sm90.cu``
(TMA loads into an mbarrier ring, wgmma for both products, a producer and
two consumer warpgroups) for bf16 and f16 at head_dim 64 or 128 in a
layout TMA can read, and ``csrc/flash_attention_fwd.cu`` for the rest
(every float dtype, head_dim up to 256, any strides).  ``_fwd_route``
picks between them from dtype, head dim and layout alone, before any
launch; every forward launch counts under ``flash_attention_fwd``, the
TMA kernel's also under ``flash_attention_fwd_sm90``.  The backward has
the same two routes for ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``:
``csrc/flash_attention_bwd_sm90.cu`` (TMA and wgmma, warp-specialised,
delta folded into the dQ kernel) when q, k, v, dO and O all take the
TMA route (``_bwd_route``), else ``csrc/flash_attention_bwd.cu``; every
launch counts under ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv``, the TMA kernels' also under the names with
``_sm90``.  Each source's header says what bounds it and how it is
built.  The public layout is Paddle's ``[B, S, N, H]``; the kernels read
it through its strides instead of transposing to ``[B, N, S, H]``.  Only
head_dim past 256 and dtypes other than bf16, f16 and f32 raise on the
card.

Semantics kept from the TPU kernels: causal is bottom-right aligned when
Sq != Sk (query row i sees keys j <= i + Sk - Sq); masked scores take
-0.7 * f32max; a row whose sum is 0 divides by 1; ``scale`` defaults to
1/sqrt(H); GQA reads kv-head ``n // (N // Nkv)``.  Unlike the TPU path,
lengths that are not a block multiple are masked inside the kernels
instead of falling back to the O(S^2) reference.  The forward writes the
logsumexp as f32 ``[B, N, Sq]``; the backward recomputes the
probabilities from it and takes ``delta = rowsum(O * dO)`` in f32: the
sm90 dQ kernel computes it, on the general route the wrapper does with
torch (as the JAX package does outside its kernels).  The dK/dV kernels
sum over the GQA group themselves, where JAX repeats K/V and sums
afterwards.

``flash_attention`` goes through ``_FlashAttentionFn`` on both devices, so
a loss computed from the card's outputs reaches q, k and v.
"""

from __future__ import annotations

import ctypes
import math

import torch

from paddle_tpu_torch.static.program import apply

from . import count_launch, use_kernel

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_reference", "flash_attention_bwd_reference"]

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_HEAD_DIM = 256  # the kernels' limit (the general kernels' widest instantiation)
# dtype -> the code the C entry points take
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_FNS: dict = {}
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (library, C function) -> argument types: pointers, ints, strides, the
# dtype (code, or 1 for f16 in the sm90 kernel), then scale, causal and
# the stream
_SIGNATURES = {
    ("flash_attention_fwd_sm90", "paddle_flash_attention_fwd_sm90"):
        [_PTR] * 5 + [_INT] * 6 + [_LL] * 12 + [_INT],
    ("flash_attention_fwd", "paddle_flash_attention_fwd"):
        [_PTR] * 5 + [_INT] * 6 + [_LL] * 15 + [_INT],
    ("flash_attention_bwd", "paddle_flash_attention_bwd_dq"):
        [_PTR] * 7 + [_INT] * 6 + [_LL] * 19 + [_INT],
    ("flash_attention_bwd", "paddle_flash_attention_bwd_dkv"):
        [_PTR] * 8 + [_INT] * 6 + [_LL] * 22 + [_INT],
    ("flash_attention_bwd_sm90", "paddle_flash_attention_bwd_dq_sm90"):
        [_PTR] * 8 + [_INT] * 6 + [_LL] * 18 + [_INT],
    ("flash_attention_bwd_sm90", "paddle_flash_attention_bwd_dkv_sm90"):
        [_PTR] * 7 + [_INT] * 6 + [_LL] * 18 + [_INT],
}
STAT_PAD = 64  # the sm90 dQ kernel's stats rows: Sq rounded up to this


def _fn(lib, name):
    """The C entry point ``name`` of ``csrc/<lib>.cu``, built at first use."""
    fn = _FNS.get(name)
    if fn is None:
        from ._cuda_build import load

        fn = getattr(load(lib), name)
        fn.argtypes = _SIGNATURES[(lib, name)] + [ctypes.c_float, _INT, _PTR]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


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


def _bnsh(q, k, v):
    """f32 ``[B, N, S, H]`` views with K/V repeated over the GQA group."""
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    group = qt.shape[1] // kt.shape[1]
    if group > 1:
        kt = kt.repeat_interleave(group, dim=1)
        vt = vt.repeat_interleave(group, dim=1)
    return qt, kt, vt


def _allowed(qlen, klen, device):
    """The bottom-right causal mask: query row i sees keys j <= i + klen - qlen."""
    return torch.ones((qlen, klen), dtype=torch.bool, device=device).tril(klen - qlen)


def _masked_logits(qt, kt, causal, scale):
    logits = torch.einsum("bnqh,bnkh->bnqk", qt, kt) * scale
    if causal:
        allowed = _allowed(logits.shape[-2], logits.shape[-1], qt.device)
        logits = logits.masked_fill(~allowed, DEFAULT_MASK_VALUE)
    return logits


def _reference_with_lse(q, k, v, causal, scale):
    qt, kt, vt = _bnsh(q, k, v)
    logits = _masked_logits(qt, kt, causal, scale)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bnkh->bnqh", probs, vt)
    return out.transpose(1, 2).to(q.dtype), lse


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention_reference(q, k, v, *, causal=False, scale=None):
    """Plain PyTorch oracle with the kernel's semantics ([B, S, N, H]):
    f32 scores and softmax, one cast at the end."""
    _check(q, k, v)
    return _reference_with_lse(q, k, v, bool(causal), _scale(q, scale))[0]


def flash_attention_bwd_reference(q, k, v, out, lse, do, *, causal=False, scale=None):
    """Plain PyTorch version of the backward kernels: the math of the JAX
    package's ``_bwd``, dense in f32, one cast of each gradient at the end.
    Returns ``(dq, dk, dv)`` in the layouts and dtypes of q, k and v.

    A causal row that sees no key (Sq > Sk, rows i < Sq - Sk) takes the
    forward's true derivative, as ``jax.grad`` of the JAX package's plain
    reference gives it: the forward gave it the mean of V, so P = 1 / Sk on
    every key and dS = 0 (no dQ, no dK; dO / Sk to every key's dV).  From
    the lse alone such a row would read P = 1: its lse, mask + log(Sk),
    rounds to the mask value in f32."""
    _check(q, k, v)
    scale = _scale(q, scale)
    b, sk, nkv, h = k.shape
    qt, kt, vt = _bnsh(q, k, v)
    ot, dot = out.transpose(1, 2).float(), do.transpose(1, 2).float()
    p = torch.exp(_masked_logits(qt, kt, bool(causal), scale) - lse.float()[..., None])
    dp = torch.einsum("bnqh,bnkh->bnqk", dot, vt)
    delta = (ot * dot).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    if causal:
        no_key = ~_allowed(q.shape[1], sk, q.device).any(-1)[:, None]  # [Sq, 1]
        p = torch.where(no_key, 1.0 / sk, p)
        ds = torch.where(no_key, 0.0, ds)
    dq = torch.einsum("bnqk,bnkh->bnqh", ds, kt)
    dk = torch.einsum("bnqk,bnqh->bnkh", ds, qt)
    dv = torch.einsum("bnqk,bnqh->bnkh", p, dot)
    # sum the GQA group back onto its kv head
    dk = dk.reshape(b, nkv, -1, sk, h).sum(dim=2)
    dv = dv.reshape(b, nkv, -1, sk, h).sum(dim=2)
    return tuple(g.transpose(1, 2).contiguous().to(t.dtype)
                 for g, t in ((dq, q), (dk, k), (dv, v)))


def _check_kernel_inputs(*named):
    """The kernels take one float dtype for every tensor (bf16, f16, f32)
    and any strides."""
    dtype = named[0][1].dtype
    for name, t in named:
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: the kernels take bf16, f16 or f32, {name} is "
                            f"{t.dtype}")
        if t.dtype != dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, {named[0][0]} {dtype}: "
                            "the kernels take one dtype")


def _check_head_dim(h):
    if not 0 < h <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {h} is past the kernels' limit of "
                         f"{MAX_HEAD_DIM}")


def _fwd_route(dtype, head_dim, strides, data_ptr) -> str:
    """Which forward kernel takes a tensor: ``"sm90"`` (TMA and wgmma,
    ``csrc/flash_attention_fwd_sm90.cu``) for bf16 or f16 at head_dim 64
    or 128 in a layout TMA can read (unit stride on H, every other stride
    a positive multiple of 16 bytes, a 16-byte aligned base), else
    ``"general"`` (``csrc/flash_attention_fwd.cu``: every float dtype,
    head_dim up to 256, any strides).  The forward runs the sm90 kernel
    when q, k and v all take it."""
    if dtype not in (torch.bfloat16, torch.float16) or head_dim not in (64, 128):
        return "general"
    if strides[-1] != 1 or any(s <= 0 or s % 8 for s in strides[:-1]) or data_ptr % 16:
        return "general"
    return "sm90"


def _bwd_route(dtype, head_dim, strides, data_ptr) -> str:
    """Which backward kernels take a tensor: ``"sm90"``
    (``csrc/flash_attention_bwd_sm90.cu``) exactly when ``_fwd_route``
    says so, else ``"general"`` (``csrc/flash_attention_bwd.cu``).  The
    backward runs the sm90 kernels when q, k, v, dO and O all take them."""
    return _fwd_route(dtype, head_dim, strides, data_ptr)


def _bwd_route_of(*tensors) -> str:
    """The backward's route for its q, k, v, dO and O: ``"sm90"`` when every
    one of them takes it."""
    h = tensors[0].shape[-1]
    return ("sm90" if all(_bwd_route(t.dtype, h, t.stride(), t.data_ptr()) == "sm90"
                          for t in tensors) else "general")


def _launch(lib, name, *args):
    """Call a C entry point on the current stream; raise on a refused launch."""
    device = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = _fn(lib, name)(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: {name} launch failed with CUDA error {err}")


def _flash_cuda(q, k, v, causal, scale):
    _check_kernel_inputs(("q", q), ("k", k), ("v", v))
    b, sq, n, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    _check_head_dim(h)
    out = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0 or n == 0:
        return out, lse
    if sk == 0:
        raise ValueError("flash_attention: no keys")
    if all(_fwd_route(t.dtype, h, t.stride(), t.data_ptr()) == "sm90" for t in (q, k, v)):
        _launch("flash_attention_fwd_sm90", "paddle_flash_attention_fwd_sm90",
                q, k, v, out, lse, b, sq, sk, n, nkv, h,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                int(q.dtype == torch.float16), float(scale), int(bool(causal)))
        count_launch("flash_attention_fwd_sm90")
    else:
        _launch("flash_attention_fwd", "paddle_flash_attention_fwd",
                q, k, v, out, lse, b, sq, sk, n, nkv, h, *q.stride(), *k.stride(), *v.stride(),
                *out.stride()[:3], _DTYPES[q.dtype], float(scale), int(bool(causal)))
    count_launch("flash_attention_fwd")
    return out, lse


def _check_bwd(q, k, v, out, lse, do):
    """Check the backward kernels' inputs (both routes)."""
    _check_kernel_inputs(("q", q), ("k", k), ("v", v), ("out", out), ("dO", do))
    _check_head_dim(q.shape[-1])
    b, sq, n, _ = q.shape
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"flash_attention: out {tuple(out.shape)} / dO {tuple(do.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if lse.shape != (b, n, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention: lse must be contiguous f32 {(b, n, sq)}")


def _delta(out, do):
    """The general route's ``delta = rowsum(O * dO)``: contiguous f32
    ``[B, N, Sq]``."""
    return (out.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale):
    b, sq, n, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    dq = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    _launch("flash_attention_bwd", "paddle_flash_attention_bwd_dq",
            q, k, v, do, lse, delta, dq, b, sq, sk, n, nkv, h,
            *q.stride(), *k.stride(), *v.stride(), *do.stride(), *dq.stride()[:3],
            _DTYPES[q.dtype], float(scale), int(bool(causal)))
    count_launch("flash_attention_bwd_dq")
    return dq


def _bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale):
    b, sq, n, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    dk = torch.empty((b, sk, nkv, h), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, nkv, h), dtype=v.dtype, device=v.device)
    _launch("flash_attention_bwd", "paddle_flash_attention_bwd_dkv",
            q, k, v, do, lse, delta, dk, dv, b, sq, sk, n, nkv, h,
            *q.stride(), *k.stride(), *v.stride(), *do.stride(), *dk.stride()[:3],
            *dv.stride()[:3], _DTYPES[q.dtype], float(scale), int(bool(causal)))
    count_launch("flash_attention_bwd_dkv")
    return dk, dv


def _bwd_dq_sm90(q, k, v, out, do, lse, causal, scale):
    """The sm90 dQ kernel: ``(dq, stats)``, stats the f32
    ``[B, N, 2, Sq rounded up to STAT_PAD]`` rows of ``lse * log2(e)`` and
    ``delta`` that it writes for the dK/dV kernel."""
    b, sq, n, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    dq = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    stats = torch.empty((b, n, 2, -(-sq // STAT_PAD) * STAT_PAD), dtype=torch.float32,
                        device=q.device)
    _launch("flash_attention_bwd_sm90", "paddle_flash_attention_bwd_dq_sm90",
            q, k, v, out, do, lse, dq, stats, b, sq, sk, n, nkv, h,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            *do.stride()[:3], *dq.stride()[:3], int(q.dtype == torch.float16), float(scale),
            int(bool(causal)))
    count_launch("flash_attention_bwd_dq_sm90")
    count_launch("flash_attention_bwd_dq")
    return dq, stats


def _bwd_dkv_sm90(q, k, v, do, stats, causal, scale):
    b, sq, n, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    dk = torch.empty((b, sk, nkv, h), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, nkv, h), dtype=v.dtype, device=v.device)
    _launch("flash_attention_bwd_sm90", "paddle_flash_attention_bwd_dkv_sm90",
            q, k, v, do, stats, dk, dv, b, sq, sk, n, nkv, h,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], int(q.dtype == torch.float16), float(scale),
            int(bool(causal)))
    count_launch("flash_attention_bwd_dkv_sm90")
    count_launch("flash_attention_bwd_dkv")
    return dk, dv


def _flash_bwd_cuda(q, k, v, out, lse, do, causal, scale):
    _check_bwd(q, k, v, out, lse, do)
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if _bwd_route_of(q, k, v, do, out) == "sm90":
        dq, stats = _bwd_dq_sm90(q, k, v, out, do, lse, causal, scale)
        dk, dv = _bwd_dkv_sm90(q, k, v, do, stats, causal, scale)
        return dq, dk, dv
    delta = _delta(out, do)
    dq = _bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def flash_attention_fwd(q, k, v, *, causal=False, scale=None):
    """``(out [B, Sq, N, H], lse f32 [B, N, Sq])`` for q ``[B, Sq, N, H]``
    and k/v ``[B, Sk, Nkv, H]``."""
    _check(q, k, v)
    if use_kernel(q, k, v):
        return _flash_cuda(q, k, v, bool(causal), _scale(q, scale))
    return _reference_with_lse(q, k, v, bool(causal), _scale(q, scale))


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=False, scale=None):
    """``(dq, dk, dv)`` of flash attention from the forward's inputs, its
    output and lse, and the output's gradient ``do``."""
    _check(q, k, v)
    if use_kernel(q, k, v, out, lse, do):
        return _flash_bwd_cuda(q, k, v, out, lse, do, bool(causal), _scale(q, scale))
    return flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal, scale=scale)


class _FlashAttentionFn(torch.autograd.Function):
    """The forward kernel (or plain version) saving what the backward
    kernels (or plain version) recompute from, as JAX's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, causal=ctx.causal,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None


def _flash_attention(q, k, v, *, causal, scale):
    return _FlashAttentionFn.apply(q, k, v, causal, scale)


def flash_attention(q, k, v, *, causal=False, scale=None):
    """Blockwise flash attention, q/k/v in ``[B, S, N, H]``, differentiable;
    one op while a static Program is captured."""
    return apply("flash_attention", _flash_attention, q, k, v, causal=bool(causal),
                 scale=_scale(q, scale))
