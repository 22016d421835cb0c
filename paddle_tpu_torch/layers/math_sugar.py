"""Python-operator sugar on Variables (counterpart of
paddle_tpu/layers/math_sugar.py): `x + y`, `x - 1.0`, `2 * x`, ... append
the same ops as in the JAX package.  A scalar operand of add, sub, mul and
div becomes one `scale` op; any other becomes a [1] `fill_constant`."""
from __future__ import annotations

from ..core.analysis import BOOL_OUT_OPS  # shared with the infer rules: they cannot drift
from ..core.layer_helper import LayerHelper
from ..core.program import Variable


def binary(x, y, op_type: str):
    helper = LayerHelper(op_type)
    if isinstance(x, Variable) and not isinstance(y, Variable):
        scalar = float(y)
        if op_type == "elementwise_add":
            return _scale(helper, x, 1.0, scalar)
        if op_type == "elementwise_sub":
            return _scale(helper, x, 1.0, -scalar)
        if op_type == "elementwise_mul":
            return _scale(helper, x, scalar, 0.0)
        if op_type == "elementwise_div":
            return _scale(helper, x, 1.0 / scalar, 0.0)
        y = _const_like(helper, x, scalar)
    elif isinstance(y, Variable) and not isinstance(x, Variable):
        x = _const_like(helper, y, float(x))
    # the output's shape follows the tensor operand, not a [1] constant
    out_shape = x.shape
    if out_shape == (1,) and y.shape not in (None, (1,)):
        out_shape = y.shape
    out_dtype = "bool" if op_type in BOOL_OUT_OPS else x.dtype
    out = helper.create_variable_for_type_inference(out_dtype, shape=out_shape)
    helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": -1})
    return out


def _scale(helper, x, scale, bias):
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("scale", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"scale": scale, "bias": bias})
    return out


def _const_like(helper, ref, value):
    out = helper.create_variable_for_type_inference(ref.dtype, shape=(1,))
    helper.append_op("fill_constant", outputs={"Out": [out.name]},
                     attrs={"shape": [1], "dtype": ref.dtype, "value": value})
    return out
