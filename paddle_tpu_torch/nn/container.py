"""Layer containers of the port (``paddle_tpu.nn.container``):
``Sequential``, ``LayerList``, ``LayerDict``, ``ParameterList`` and
``ParameterDict``, as Layers over torch's module and parameter
registries (sublayers and parameters keyed ``"0"``, ``"1"``, ...)."""
from __future__ import annotations

from collections import OrderedDict

from ..core.tensor import Parameter, wrap_leaf
from .layer import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList",
           "ParameterDict"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
            return
        if len(layers) == 1 and isinstance(layers[0], list):
            layers = tuple(layers[0])
        for i, item in enumerate(layers):
            if isinstance(item, tuple) and len(item) == 2 and \
                    isinstance(item[0], str):
                self.add_sublayer(item[0], item[1])
            else:
                self.add_sublayer(str(i), item)

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


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __setitem__(self, idx, layer):
        keys = list(self._modules.keys())
        self._modules[keys[idx]] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, l in enumerate(layers):
            self._modules[str(i)] = l

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return wrap_leaf(list(self._parameters.values())[idx])

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(wrap_leaf(p) for p in self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

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
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for k, v in items:
            self.add_sublayer(k, v)


class ParameterDict(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            self.update(parameters)

    def __getitem__(self, key):
        return wrap_leaf(self._parameters[key])

    def __setitem__(self, key, parameter):
        self.add_parameter(key, parameter)

    def __delitem__(self, key):
        del self._parameters[key]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters)

    def __contains__(self, key):
        return key in self._parameters

    def clear(self):
        self._parameters.clear()

    def pop(self, key):
        return wrap_leaf(self._parameters.pop(key))

    def keys(self):
        return self._parameters.keys()

    def items(self):
        return [(k, wrap_leaf(v)) for k, v in self._parameters.items()]

    def values(self):
        return [wrap_leaf(v) for v in self._parameters.values()]

    def update(self, parameters):
        items = parameters.items() if hasattr(parameters, "items") \
            else parameters
        for k, v in items:
            self[k] = v if isinstance(v, Parameter) else Parameter(v)
        return self
