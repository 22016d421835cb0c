"""Tensor layers (counterpart of paddle_tpu/layers/tensor.py)."""
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
