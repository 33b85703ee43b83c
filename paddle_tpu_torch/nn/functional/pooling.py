"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py).

The JAX package pools with ``lax.reduce_window``, outside any Pallas
kernel; here with torch's pooling over an explicitly padded input, which
gives the same windows:

- max pooling pads with -inf; ``ceil_mode`` adds the JAX package's extra
  right padding (``_ceil_extra``), so the last window may hang over the
  end.  A window's gradient goes to its first maximum, as XLA's
  select-and-scatter sends it (after a ReLU many windows tie at 0, whose
  gradient is 0 either way);
- average pooling sums over zero padding and divides by the window's
  size (``exclusive=False`` with numeric padding) or by the count of
  input elements in the window (``exclusive=True``, and always under
  ``"SAME"``), the ceil extra included in either;
- adaptive pooling splits each axis into regions from ``floor(i n / o)``
  to ``ceil((i + 1) n / o)`` and reduces one axis after the other; a max
  shares its gradient among tied elements, as ``jnp.max``'s does.

Each call is one ``pool`` or ``adaptive_pool`` op, the JAX package's
names, in neither AMP list.  ``return_mask``, ``max_unpool*`` and
``lp_pool*`` are not ported yet (ROADMAP.md A.4); the JAX package takes
``divisor_override`` and ignores it, so here it raises rather than
giving another answer than Paddle's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.static.program import apply

from .conv import pad_arg, same_pads

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d", "avg_pool3d",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in (v if len(v) == n else list(v) * n)[:n])
    return tuple(int(v) for _ in range(n))


def _pads(padding, n):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1])) for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _ceil_extra(n, k, s, lo, hi):
    """Extra right padding giving the ceil-mode output size
    ``ceil((n + lo + hi - k) / s) + 1``."""
    total = n + lo + hi
    out = math.ceil(max(total - k, 0) / s) + 1
    return max((out - 1) * s + k - total, 0)


def _max(v, *, ks, st, pads):
    nd = len(ks)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ks)):
        return _MAX[nd](v, ks, st, [lo for lo, _ in pads])  # torch pads with -inf
    v = TF.pad(v, pad_arg(pads), value=float("-inf"))
    return _MAX[nd](v, ks, st)


def _avg(v, *, ks, st, pads, exclusive):
    nd = len(ks)
    if not any(lo or hi for lo, hi in pads):
        return _AVG[nd](v, ks, st)
    padded = TF.pad(v, pad_arg(pads))
    s = _AVG[nd](padded, ks, st)  # the window's sum over its size
    if not exclusive:
        return s
    ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype, device=v.device)
    return s / _AVG[nd](TF.pad(ones, pad_arg(pads)), ks, st)  # over the count


def _pool(v, *, kind, ks, st, pads, channel_last, exclusive=True):
    if channel_last:
        v = v.movedim(-1, 1)
    out = _max(v, ks=ks, st=st, pads=pads) if kind == "max" else _avg(
        v, ks=ks, st=st, pads=pads, exclusive=exclusive)
    return out.movedim(1, -1) if channel_last else out


def _pool_nd(x, kind, kernel_size, stride, padding, nd, data_format, ceil_mode,
             exclusive=True):
    ks = _tuple(kernel_size, nd)
    st = _tuple(stride if stride is not None else kernel_size, nd)
    channel_last = data_format[-1] == "C"
    sizes = [int(n) for n in (x.shape[1:1 + nd] if channel_last else x.shape[2:2 + nd])]
    pads = _pads(padding, nd)
    if isinstance(pads, str):
        if pads not in ("SAME", "VALID"):
            raise ValueError(f"bad padding {padding}")
        # the JAX package divides by the count under a string padding
        exclusive = exclusive or pads == "SAME"
        pads = same_pads(sizes, ks, st, (1,) * nd) if pads == "SAME" else [(0, 0)] * nd
    elif ceil_mode:
        pads = [(lo, hi + _ceil_extra(n, k, s, lo, hi))
                for (lo, hi), n, k, s in zip(pads, sizes, ks, st)]
    return apply("pool", _pool, x, kind=kind, ks=ks, st=st, pads=pads,
                 channel_last=channel_last, exclusive=bool(exclusive))


def _no_mask(return_mask, name):
    if return_mask:
        raise NotImplementedError(
            f"{name}(return_mask=True) is not ported yet (ROADMAP.md A.4, vision)")


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCL", name=None):
    _no_mask(return_mask, "max_pool1d")
    return _pool_nd(x, "max", kernel_size, stride, padding, 1, data_format, ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW", name=None):
    _no_mask(return_mask, "max_pool2d")
    return _pool_nd(x, "max", kernel_size, stride, padding, 2, data_format, ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCDHW", name=None):
    _no_mask(return_mask, "max_pool3d")
    return _pool_nd(x, "max", kernel_size, stride, padding, 3, data_format, ceil_mode)


def _no_divisor(divisor_override):
    if divisor_override is not None:
        raise NotImplementedError(
            "avg_pool divisor_override is not ported: the JAX package takes it and ignores it "
            "(ROADMAP.md §C)")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
               data_format="NCL", name=None):
    return _pool_nd(x, "avg", kernel_size, stride, padding, 1, data_format, ceil_mode,
                    exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    _no_divisor(divisor_override)
    return _pool_nd(x, "avg", kernel_size, stride, padding, 2, data_format, ceil_mode,
                    exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW", name=None):
    _no_divisor(divisor_override)
    return _pool_nd(x, "avg", kernel_size, stride, padding, 3, data_format, ceil_mode,
                    exclusive)


def _adaptive(v, *, sizes, axes, is_avg):
    out = v
    for ax, o in zip(axes, sizes):
        n = out.shape[ax]
        if n % o == 0:  # equal regions that do not overlap: one reduction
            shape = out.shape[:ax] + (o, n // o) + out.shape[ax + 1:]
            split = out.reshape(shape)
            out = split.mean(dim=ax + 1) if is_avg else split.amax(dim=ax + 1)
            continue
        pieces = []
        for i in range(o):
            seg = out.narrow(ax, i * n // o, -(-(i + 1) * n // o) - i * n // o)
            pieces.append(seg.mean(dim=ax, keepdim=True) if is_avg
                          else seg.amax(dim=ax, keepdim=True))
        out = torch.cat(pieces, dim=ax)
    return out


def _adaptive_pool(x, output_size, nd, data_format, is_avg):
    sizes = _tuple(output_size, nd)
    first = 1 if data_format[-1] == "C" else 2
    return apply("adaptive_pool", _adaptive, x, sizes=sizes,
                 axes=tuple(range(first, first + nd)), is_avg=is_avg)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "NCL", True)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format, True)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format, True)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool1d")
    return _adaptive_pool(x, output_size, 1, "NCL", False)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool2d")
    return _adaptive_pool(x, output_size, 2, "NCHW", False)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool3d")
    return _adaptive_pool(x, output_size, 3, "NCDHW", False)
