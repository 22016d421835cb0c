"""Tensor layers (counterpart of paddle_tpu/layers/tensor.py): fill_constant,
zeros, ones, create_global_var, cast, sums, assign, concat, zeros_like and
linspace."""
from __future__ import annotations

import numpy as np

from ..core.dtypes import canonical_dtype
from ..core.layer_helper import LayerHelper


def fill_constant(shape, dtype, value, name=None):
    helper = LayerHelper("fill_constant", name=name)
    out = helper.create_variable_for_type_inference(dtype, shape=tuple(shape))
    helper.append_op(
        "fill_constant",
        outputs={"Out": [out.name]},
        attrs={"shape": list(shape), "dtype": canonical_dtype(dtype), "value": float(value)},
    )
    out.stop_gradient = True
    return out


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    """A var of the main program's global block, filled with `value` by the
    startup program."""
    from ..core import unique_name
    from ..core.program import default_main_program, default_startup_program

    name = name if name is not None else unique_name.generate("global_var")
    var = default_main_program().global_block().create_var(name, shape=shape, dtype=dtype,
                                                           persistable=persistable)
    startup = default_startup_program().global_block()
    startup.create_var(name, shape=shape, dtype=dtype, persistable=persistable)
    startup.append_op("fill_constant", outputs={"Out": [name]},
                      attrs={"shape": list(shape), "dtype": canonical_dtype(dtype),
                             "value": float(value)})
    return var


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype, shape=x.shape)
    helper.append_op("cast", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"out_dtype": canonical_dtype(dtype), "in_dtype": x.dtype})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype, shape=input[0].shape)
    helper.append_op("sum", inputs={"X": [v.name for v in input]}, outputs={"Out": [out.name]})
    return out


def assign(input, output=None):
    """Copy a Variable, or bake a numpy array into the program as an
    `assign_value` op."""
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(str(input.dtype),
                                                               shape=input.shape)
        helper.append_op("assign_value", outputs={"Out": [output.name]},
                         attrs={"values": input, "dtype": canonical_dtype(input.dtype),
                                "shape": list(input.shape)})
        return output
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype, shape=input.shape)
    helper.append_op("assign", inputs={"X": [input.name]}, outputs={"Out": [output.name]})
    return output


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    shape = None
    if all(v.shape is not None for v in input):
        shapes = [tuple(v.shape) for v in input]
        ax = axis % len(shapes[0])
        rest = {s[:ax] + s[ax + 1:] for s in shapes}
        cat_dims = [s[ax] for s in shapes]
        if len(rest) == 1 and all(d is not None and d >= 0 for d in cat_dims):
            shape = shapes[0][:ax] + (sum(cat_dims),) + shapes[0][ax + 1:]
    out = helper.create_variable_for_type_inference(input[0].dtype, shape=shape)
    helper.append_op("concat", inputs={"X": [v.name for v in input]}, outputs={"Out": [out.name]},
                     attrs={"axis": axis})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("fill_zeros_like", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


def linspace(start, stop, num, dtype="float32", name=None):
    """`num` (a Python int) evenly spaced values in [start, stop]."""
    helper = LayerHelper("linspace", name=name)
    out = helper.create_variable_for_type_inference(dtype, shape=(int(num),))
    s = fill_constant([1], dtype, float(start))
    e = fill_constant([1], dtype, float(stop))
    helper.append_op("linspace", inputs={"Start": [s.name], "Stop": [e.name]},
                     outputs={"Out": [out.name]}, attrs={"num_v": int(num)})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_max", inputs={"X": [x.name]}, outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_min", inputs={"X": [x.name]}, outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out
