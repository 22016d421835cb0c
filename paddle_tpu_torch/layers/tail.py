"""Layers of the JAX package's layers/tail.py whose ops the port has: the
attr'd and plain activations of its tail, elementwise_mod / _floordiv, the
compare layers, isfinite, shape, pad, unstack, range and the random fills."""
from __future__ import annotations

import builtins

from ..core.layer_helper import LayerHelper
from . import nn as _nn
from .nn import _out


def _attr_act(op_type, attr_map, out_dtype=None):
    """A unary op with attrs, in the reference's signature."""
    def f(x, *args, name=None, **kw):
        helper = LayerHelper(op_type, name=name)
        attrs = {}
        for i, (aname, default) in enumerate(attr_map):
            val = args[i] if i < len(args) else kw.get(aname, default)
            attrs[aname] = default if val is None else val
        out = _out(helper, out_dtype or x.dtype, shape=x.shape)
        helper.append_op(op_type, inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                         attrs=attrs)
        return out

    f.__name__ = op_type
    return f


elu = _attr_act("elu", [("alpha", 1.0)])
hard_shrink = _attr_act("hard_shrink", [("threshold", 0.5)])
softshrink = _attr_act("softshrink", [("lambda", 0.5)])
hard_sigmoid = _attr_act("hard_sigmoid", [("slope", 0.2), ("offset", 0.5)])
stanh = _attr_act("stanh", [("scale_a", 2.0 / 3.0), ("scale_b", 1.7159)])
swish = _attr_act("swish", [("beta", 1.0)])

acos = _nn._act_layer("acos")
asin = _nn._act_layer("asin")
atan = _nn._act_layer("atan")
rsqrt = _nn._act_layer("rsqrt")
sign = _nn._act_layer("sign")
tanh_shrink = _nn._act_layer("tanh_shrink")


def _binary_layer(op_type, out_dtype=None):
    def f(x, y, out=None, name=None, axis=-1, act=None):
        helper = LayerHelper(op_type, name=name, act=act)
        o = out if out is not None else _out(helper, out_dtype or x.dtype, shape=x.shape)
        helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [o.name]}, attrs={"axis": axis})
        return helper.append_activation(o) if act else o

    f.__name__ = op_type
    return f


elementwise_mod = _binary_layer("elementwise_mod")
elementwise_floordiv = _binary_layer("elementwise_floordiv")


def _compare_layer(op_type):
    def f(x, y, cond=None):
        helper = LayerHelper(op_type)
        out = cond if cond is not None else _out(helper, "bool", shape=x.shape)
        helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [out.name]})
        return out

    f.__name__ = op_type
    return f


less_equal = _compare_layer("less_equal")
greater_equal = _compare_layer("greater_equal")
not_equal = _compare_layer("not_equal")


def isfinite(x):
    helper = LayerHelper("isfinite")
    out = _out(helper, "bool", shape=(1,))
    helper.append_op("isfinite", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = _out(helper, "int32", shape=(len(input.shape),))
    helper.append_op("shape", inputs={"Input": [input.name]}, outputs={"Out": [out.name]})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("pad", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"paddings": list(paddings), "pad_value": pad_value})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    n = num if num is not None else x.shape[axis]
    if n is None or int(n) < 0:
        raise ValueError(f"unstack: dim {axis} is dynamic ({n}); pass num= explicitly "
                         "(reference raises the same)")
    outs = [_out(helper, x.dtype) for _ in builtins.range(int(n))]
    helper.append_op("unstack", inputs={"X": [x.name]}, outputs={"Y": [o.name for o in outs]},
                     attrs={"axis": axis, "num": int(n)})
    return outs


def range(start, end, step, dtype):
    """Each bound a Variable (an input) or a Python number (an attr)."""
    helper = LayerHelper("range")
    out = _out(helper, dtype)
    inputs, attrs = {}, {"dtype": dtype}
    for slot, key, v in (("Start", "start_v", start), ("End", "end_v", end),
                         ("Step", "step_v", step)):
        if hasattr(v, "name"):
            inputs[slot] = [v.name]
        else:
            attrs[key] = v
    helper.append_op("range", inputs=inputs, outputs={"Out": [out.name]}, attrs=attrs)
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = _out(helper, dtype, shape=tuple(shape))
    helper.append_op("uniform_random", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype, "min": min, "max": max,
                            "seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = _out(helper, dtype, shape=tuple(shape))
    helper.append_op("gaussian_random", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype, "mean": mean, "std": std,
                            "seed": seed})
    return out
