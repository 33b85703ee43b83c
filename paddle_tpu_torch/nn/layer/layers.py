"""``ParamAttr`` (counterpart of the JAX package's paddle_tpu/nn/layer/layers.py:24-45).

A layer's ``weight_attr`` / ``bias_attr`` may be a ``ParamAttr``, a
string (the name), ``None`` (the defaults) or ``False`` (no parameter).
``set_param_attr`` gives the parameter what the JAX package's
``create_parameter`` gives it that an optimizer or a clip reads:
``regularizer`` (before the optimizer's own ``weight_decay``),
``need_clip`` (the clip classes) and ``trainable`` (``requires_grad``).
``learning_rate``, which no optimizer of the JAX package reads, and the
name (a torch tensor's cannot be set) stay on the attribute.
Initializers are not ported: an ``initializer`` raises.
"""

from __future__ import annotations

__all__ = ["ParamAttr", "set_param_attr", "copy_param_attrs"]


class ParamAttr:
    """Parameter attribute bundle (Paddle's ``paddle.ParamAttr``)."""

    def __init__(self, name=None, initializer=None, learning_rate: float = 1.0,
                 regularizer=None, trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """``None`` -> the defaults, a string -> a name, ``False`` stays
        ``False``; anything else is taken as an initializer."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr) or attr is False:
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


def set_param_attr(param, attr):
    """Give ``param`` the attributes of ``attr`` (any form ``_to_attr``
    takes); returns ``param``.  ``False`` counts as the defaults: a layer
    that can drop a parameter does so before it gets here, and a weight it
    always builds keeps the defaults."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        attr = ParamAttr()
    if attr.initializer is not None:
        raise NotImplementedError(
            "ParamAttr(initializer=...) is not ported yet (ROADMAP.md A.7, nn/initializer); "
            "the port's layers keep the JAX package's default initializers")
    param.regularizer = attr.regularizer
    param.need_clip = attr.need_clip
    param.requires_grad_(bool(attr.trainable))
    return param


_ATTRS = ("regularizer", "need_clip")


def copy_param_attrs(src, dst):
    """Carry the attributes ``set_param_attr`` sets from the parameters of
    module ``src`` to those of its deep copy ``dst`` (torch's
    ``Parameter.__deepcopy__`` drops a parameter's Python attributes)."""
    for a, b in zip(src.parameters(), dst.parameters(), strict=True):
        for name in _ATTRS:
            if hasattr(a, name):
                setattr(b, name, getattr(a, name))
