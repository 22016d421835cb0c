"""Dygraph Layer base (counterpart of paddle_tpu/dygraph/layers.py).

`Layer` is not a `torch.nn.Module`: its `parameters()`, `state_dict()`,
`train()`, `eval()`, `__setattr__` and `__call__` keep Fluid's signatures and
return types (a list of VarBases, a dict of numpy arrays, no return value),
which collide with nn.Module's.  `__setattr__` files any persistable VarBase
as a parameter, batch norm's running statistics included, as the JAX
package does.  Initial values are drawn on the host by numpy from
`RandomState(_materialize_init._seed)`, the counter starting at 1234 and
rising by one a parameter: with equal counters both packages draw the same
bits.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple  # noqa: F401

import numpy as np

from ..core import unique_name
from ..core.initializer import ConstantInitializer, XavierInitializer
from ..core.param_attr import ParamAttr
from .base import VarBase, enabled  # noqa: F401


class Layer:
    def __init__(self, name_scope: str = "", dtype: str = "float32"):
        self._full_name = unique_name.generate(name_scope or self.__class__.__name__.lower())
        self._dtype = dtype
        self._parameters: "OrderedDict[str, VarBase]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self.training = True

    def full_name(self):
        return self._full_name

    # --- parameter plumbing ----------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> VarBase:
        import copy

        attr = copy.copy(ParamAttr._to_attr(attr))
        if attr.name is None:
            attr.name = unique_name.generate(
                f"{self._full_name}.{'b' if is_bias else 'w'}"
            )
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        # low-precision float parameters are float32 masters, as the graph
        # mode's LayerHelper makes them: ops cast per use
        from ..core.layer_helper import _master_dtype

        value = _materialize_init(init, shape, _master_dtype(dtype or self._dtype))
        return VarBase(value, stop_gradient=not attr.trainable, name=attr.name,
                       persistable=True)

    def add_parameter(self, name: str, param: VarBase) -> VarBase:
        self._parameters[name] = param
        return param

    def create_variable(self, name=None, persistable=None, dtype=None,
                        type=None):
        """A non-parameter state holder scoped to this layer."""
        return VarBase(np.zeros((1,), dtype or self._dtype),
                       stop_gradient=True,
                       name=name or unique_name.generate(f"{self._full_name}.var"),
                       persistable=bool(persistable))

    def backward(self, *inputs):
        """The reference's per-layer backward hook, which no built-in layer has."""
        raise ValueError("Layer.backward is not implemented (reference "
                         "raises the same)")

    def add_sublayer(self, name: str, layer: "Layer") -> "Layer":
        self._sub_layers[name] = layer
        return layer

    def parameters(self, include_sublayers: bool = True) -> List[VarBase]:
        out = list(self._parameters.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.parameters())
        return out

    def named_parameters(self, prefix: str = "") -> Iterator[Tuple[str, VarBase]]:
        for n, p in self._parameters.items():
            yield (f"{prefix}.{n}" if prefix else n), p
        for ln, sub in self._sub_layers.items():
            yield from sub.named_parameters(f"{prefix}.{ln}" if prefix else ln)

    def sublayers(self) -> List["Layer"]:
        out = []
        for sub in self._sub_layers.values():
            out.append(sub)
            out.extend(sub.sublayers())
        return out

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    def train(self):
        self.training = True
        for sub in self.sublayers():
            sub.training = True

    def eval(self):
        self.training = False
        for sub in self.sublayers():
            sub.training = False

    # --- state dict ------------------------------------------------------
    def state_dict(self, prefix: str = "") -> Dict[str, np.ndarray]:
        return {name: p.numpy() for name, p in self.named_parameters(prefix)}

    def set_dict(self, state: Dict[str, np.ndarray]):
        own = dict(self.named_parameters())
        for name, value in state.items():
            if name in own:
                own[name].set_value(value)

    load_dict = set_dict

    # --- call ------------------------------------------------------------
    def __call__(self, *args, **kw):
        return self.forward(*args, **kw)

    def forward(self, *args, **kw):
        raise NotImplementedError

    def __setattr__(self, name, value):
        if isinstance(value, VarBase) and value.persistable:
            object.__getattribute__(self, "_parameters")[name] = value
        elif isinstance(value, Layer):
            object.__getattribute__(self, "_sub_layers")[name] = value
        object.__setattr__(self, name, value)


def _np_dtype(dtype):
    from ..core.dtypes import canonical_dtype

    name = canonical_dtype(dtype)
    if name == "bfloat16":
        from ..core.dtypes import _numpy_bfloat16

        return _numpy_bfloat16()
    return np.dtype(name)


def _materialize_init(init, shape, dtype):
    """Run an initializer on the host (no startup program in dygraph)."""
    from ..core.initializer import (
        MSRAInitializer,
        NormalInitializer,
        NumpyArrayInitializer,
        TruncatedNormalInitializer,
        UniformInitializer,
        _fans,
    )

    shape = tuple(int(s) for s in shape)
    npdt = _np_dtype(dtype)
    rng = np.random.RandomState(_materialize_init._seed)
    _materialize_init._seed += 1
    if isinstance(init, ConstantInitializer):
        return np.full(shape, init.value, dtype=npdt)
    if isinstance(init, UniformInitializer):
        return rng.uniform(init.low, init.high, shape).astype(npdt)
    if isinstance(init, NormalInitializer):
        return (init.loc + init.scale * rng.randn(*shape)).astype(npdt)
    if isinstance(init, TruncatedNormalInitializer):
        z = np.clip(rng.randn(*shape), -2, 2)
        return (init.loc + init.scale * z).astype(npdt)
    if isinstance(init, NumpyArrayInitializer):
        return init.value.astype(npdt).reshape(shape)
    if isinstance(init, (XavierInitializer, MSRAInitializer)):

        class _V:  # what _fans reads
            pass

        v = _V()
        v.shape = shape
        fi, fo = _fans(v)
        if isinstance(init, XavierInitializer):
            fi = init.fan_in or fi
            fo = init.fan_out or fo
            if init.uniform:
                lim = float(np.sqrt(6.0 / (fi + fo)))
                return rng.uniform(-lim, lim, shape).astype(npdt)
            return (np.sqrt(2.0 / (fi + fo)) * rng.randn(*shape)).astype(npdt)
        fi = init.fan_in or fi
        if init.uniform:
            lim = float(np.sqrt(6.0 / fi))
            return rng.uniform(-lim, lim, shape).astype(npdt)
        return (np.sqrt(2.0 / fi) * rng.randn(*shape)).astype(npdt)
    raise TypeError(f"unsupported initializer in dygraph: {init!r}")


_materialize_init._seed = 1234
