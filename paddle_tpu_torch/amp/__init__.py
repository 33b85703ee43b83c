"""AMP: ``auto_cast``, ``decorate`` and ``GradScaler`` (counterpart of
paddle_tpu/amp/__init__.py).

The cast hook sits in the port's op funnel, ``static.program.apply``, as
the JAX package's sits in ``_core.autograd.apply``: while ``auto_cast`` is
on, an op whose type name is white-listed casts its floating tensor
arguments to the AMP dtype, a black-listed one casts them to f32, and any
other follows its inputs.  The cast is ``Tensor.to``, so the cotangent is
cast back on the way down.  The names decide: ``fused_rms_norm`` (the
kernel path of ``nn.RMSNorm``) is in neither list, so the norm follows its
input, as the JAX package's Pallas path does.  ``torch.autocast`` is not
used: its op lists are not these, and it takes no custom lists.

``GradScaler`` keeps its state in 0-d tensors on the device (the scale in
f32, the good and bad step counts in int32, the found-inf flag) and makes
every decision there: ``step`` always runs the optimizer's update, which
keeps each parameter, f32 master, moment and beta power where the flag
is set (``Optimizer._skip``), so an eager step and a step recorded as a
CUDA graph do the same thing with no host sync.  The tensors are created
at construction and written in place ever after, so a recorded step reads
them at fixed addresses.  ``step_count`` counts every step run, skipped
ones too: knowing of a skip would need a sync.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from paddle_tpu_torch._core.device import resolve_device

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "amp_state", "white_list",
           "black_list", "is_bfloat16_supported", "is_float16_supported"]

# ops that gain from low precision (the tensor cores): the JAX package's white list
WHITE_LIST = {
    "matmul", "linear", "conv", "conv_transpose", "mm", "bmm", "einsum", "addmm",
    "scaled_dot_product_attention", "flash_attention",
    "fused_dot_product_attention", "flash_attn_unpadded",
    "fused_gate_attention",
}
# numerically sensitive ops stay f32: the JAX package's black list
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax_with_cross_entropy",
    "cross_entropy", "layer_norm", "rms_norm", "batch_norm", "group_norm",
    "instance_norm", "softmax", "log_softmax", "mean", "sum", "cumsum", "norm",
    "pow", "sqrt", "rsqrt", "square", "reciprocal",
}

CAPTURE_REFUSED = ("auto_cast while a static Program is captured is not ported yet "
                   "(ROADMAP.md A.5.6); the fp16 program rewrite is A.6")

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"AMP dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
    return _DTYPES[dtype]


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state():
    return _state


def white_list():
    return (WHITE_LIST | _state.custom_white) - _state.custom_black


def black_list():
    return (BLACK_LIST | _state.custom_black) - _state.custom_white


def cast_args(type_, args):
    """The op funnel's hook: ``args`` with their floating tensors cast for
    an op of type ``type_`` under the current AMP state."""
    if type_ in white_list():
        target = _state.dtype
    elif type_ in black_list():
        target = torch.float32
    else:
        return args
    return tuple(a.to(target) if isinstance(a, torch.Tensor) and a.is_floating_point()
                 and a.dtype != target else a for a in args)


@contextlib.contextmanager
def op_body():
    """The hook off while an op's body runs (``static.program.apply``):
    as in the JAX package, whose op bodies are plain jnp, only the op
    called from the model is cast, not the functions it is built of."""
    _state.enabled = False
    try:
        yield
    finally:
        _state.enabled = True


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None, level="O1",
              dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast``: inside it, ops cast their inputs by the
    white and black lists (module docstring); the previous state comes
    back on exit, nested scopes included.  The default dtype is bfloat16;
    float16 wants a ``GradScaler``."""
    from paddle_tpu_torch.static.program import in_static_capture

    if enable and in_static_capture():
        raise NotImplementedError(CAPTURE_REFUSED)
    prev = (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)
    _state.enabled = bool(enable)
    _state.dtype = _dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16", master_weight=None,
             save_dtype=None):
    """O2: cast every floating parameter of ``models`` to ``dtype`` in place
    (each stays the same ``Parameter``).  The optimizer keeps an f32 master
    weight for each bf16 or f16 parameter and updates that.  O1 changes
    nothing.  Returns the models, or ``(models, optimizers)``."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = _dtype(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (module docstring).  ``device=None`` means the
    CUDA card; the state tensors live there from construction on."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000, decr_every_n_nan_or_inf=1,
                 use_dynamic_loss_scaling=True, device=None):
        self._enable = enable
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every = int(incr_every_n_steps)
        self._decr_every = int(decr_every_n_nan_or_inf)
        self._dynamic = use_dynamic_loss_scaling
        dev = resolve_device(device)
        self._scale_t = torch.tensor(float(init_loss_scaling), dtype=torch.float32, device=dev)
        self._good_t = torch.zeros((), dtype=torch.int32, device=dev)
        self._bad_t = torch.zeros((), dtype=torch.int32, device=dev)
        self._found_t = torch.zeros((), dtype=torch.bool, device=dev)

    def state_tensors(self):
        """The scale and the two counts: the state a recorded TrainStep
        reads and writes in place."""
        return [self._scale_t, self._good_t, self._bad_t]

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale_t.to(var.dtype)

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every gradient by ``1 / scale`` in f32 (written back in
        the gradient's dtype, in place) and set the found flag when any
        product is not finite."""
        if not self._enable:
            return
        inv = torch.reciprocal(self._scale_t)
        self._found_t.zero_()
        for p in optimizer._parameter_list:
            g = p.grad
            if g is None:
                continue
            g32 = g.float() * inv
            self._found_t.logical_or_(~torch.isfinite(g32).all())
            g.copy_(g32)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        optimizer._skip = self._found_t
        try:
            optimizer.step()
        finally:
            optimizer._skip = None
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    @torch.no_grad()
    def update(self):
        """Halve the scale (not below 1) after ``decr_every_n_nan_or_inf``
        bad steps in a row, double it after ``incr_every_n_steps`` good
        ones: selects on the device, the counts reset where they fire."""
        if not self._enable or not self._dynamic:
            return
        found, good, bad, scale = self._found_t, self._good_t, self._bad_t, self._scale_t
        bad2 = torch.where(found, bad + 1, 0)
        good2 = torch.where(found, 0, good + 1)
        dec = bad2 >= self._decr_every
        inc = ~found & (good2 >= self._incr_every)
        new_scale = torch.where(dec, torch.clamp_min(scale * self._decr_ratio, 1.0), scale)
        scale.copy_(torch.where(inc, new_scale * self._incr_ratio, new_scale))
        bad.copy_(torch.where(dec, 0, bad2))
        good.copy_(torch.where(inc, 0, good2))

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return float(self._scale_t)

    def set_init_loss_scaling(self, v):
        self._scale_t.fill_(float(v))

    def state_dict(self):
        return {"scale": self.get_loss_scaling(), "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "incr_count": int(self._good_t),
                "decr_count": int(self._bad_t)}

    def load_state_dict(self, state):
        self._scale_t.fill_(float(state.get("scale", self.get_loss_scaling())))
        self._good_t.fill_(int(state.get("incr_count", 0)))
        self._bad_t.fill_(int(state.get("decr_count", 0)))


def is_bfloat16_supported(device=None):
    """bf16 runs on the card's tensor cores and in torch on the CPU."""
    return True


def is_float16_supported(device=None):
    """f16 runs on the card's tensor cores and in torch on the CPU."""
    return True
