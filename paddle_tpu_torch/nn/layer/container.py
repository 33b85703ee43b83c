"""Layer containers (counterpart of paddle_tpu/nn/layer/container.py).

``Sequential`` takes an ``OrderedDict``, ``(name, layer)`` tuples or
layers; unnamed children are ``"0"``, ``"1"``, ..., so ``state_dict`` keys
are the JAX package's (``layer1.0.downsample.0.weight``).  A slice is a
new ``Sequential`` of the same layers, renumbered from ``"0"``, as in the
JAX package (torch's keeps the old names).
"""

from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(nn.Module):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_module(name, layer)
        else:
            for i, item in enumerate(layers):
                if isinstance(item, tuple):
                    self.add_module(item[0], item[1])
                else:
                    self.add_module(str(i), item)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(nn.Module):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_module(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx if idx >= 0 else idx + len(self))]

    def __setitem__(self, idx, layer):
        self.add_module(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_module(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, item in enumerate(layers):
            self.add_module(str(i), item)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class LayerDict(nn.Module):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_module(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        items = (sublayers.items() if isinstance(sublayers, (dict, LayerDict))
                 else sublayers)
        for key, layer in items:
            self.add_module(key, layer)


class ParameterList(nn.Module):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.register_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx if idx >= 0 else idx + len(self))]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter: nn.Parameter):
        self.register_parameter(str(len(self)), parameter)
        return self
