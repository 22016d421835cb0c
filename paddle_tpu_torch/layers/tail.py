"""Layers of the JAX package's layers/tail.py whose ops the port has: the
attr'd and plain activations of its tail, elementwise_mod / _floordiv, the
compare layers, isfinite, shape, pad, unstack, range, the random fills,
sequence_reshape, the one-step recurrences gru_unit and lstm_unit, prelu,
huber_loss, conv3d_transpose, image_resize (and _short), deformable_conv
and deformable_roi_pooling."""
from __future__ import annotations

import builtins

from ..core.initializer import ConstantInitializer
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


def sequence_reshape(input, new_dim):
    from .sequence import _lod_of, _set_lod

    helper = LayerHelper("sequence_reshape")
    lod = _lod_of(input)
    out = _out(helper, input.dtype)
    out_lod = helper.create_variable_for_type_inference("int32")
    helper.append_op("sequence_reshape", inputs={"X": [input.name], "XLod": [lod.name]},
                     outputs={"Out": [out.name], "OutLod": [out_lod.name]},
                     attrs={"new_dim": new_dim})
    _set_lod(out, out_lod)
    return out


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None, activation="tanh",
             gate_activation="sigmoid", origin_mode=False):
    """One GRU step; size = 3*D.  Returns (hidden, reset hidden, gates)."""
    helper = LayerHelper("gru_unit")
    d = size // 3
    w = helper.create_parameter(param_attr, [d, 3 * d], input.dtype)
    inputs = {"Input": [input.name], "HiddenPrev": [hidden.name], "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [1, 3 * d], input.dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    hid = _out(helper, input.dtype, shape=(input.shape[0], d))
    reset_h = _out(helper, input.dtype)
    gate = _out(helper, input.dtype)
    helper.append_op("gru_unit", inputs=inputs,
                     outputs={"Hidden": [hid.name], "ResetHiddenPrev": [reset_h.name],
                              "Gate": [gate.name]},
                     attrs={"origin_mode": origin_mode})
    return hid, reset_h, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0, param_attr=None,
              bias_attr=None, name=None):
    """One LSTM step: fc([x, h]) then the `lstm_unit` op; returns (h, c)."""
    helper = LayerHelper("lstm_unit", name=name)
    d = int(cell_t_prev.shape[1])
    fc_out = _nn.fc(_concat([x_t, hidden_t_prev], axis=1), 4 * d, param_attr=param_attr,
                    bias_attr=bias_attr)
    c = _out(helper, x_t.dtype, shape=cell_t_prev.shape)
    h = _out(helper, x_t.dtype, shape=cell_t_prev.shape)
    helper.append_op("lstm_unit", inputs={"X": [fc_out.name], "C_prev": [cell_t_prev.name]},
                     outputs={"C": [c.name], "H": [h.name]}, attrs={"forget_bias": forget_bias})
    return h, c


def _concat(xs, axis):
    from .tensor import concat

    return concat(xs, axis=axis)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """reference layers/nn.py conv3d_transpose (conv_transpose_op.cc)."""
    helper = LayerHelper("conv3d_transpose", name=name, act=act)
    groups = groups or 1

    def _triple(v):
        return [v] * 3 if isinstance(v, int) else list(v)

    st = _triple(stride)
    pd = _triple(padding)
    if filter_size is None:
        if output_size is None:
            raise ValueError("conv3d_transpose: give filter_size or "
                             "output_size")
        # out = (in-1)*stride - 2*pad + filter  =>  solve for filter
        osz = _triple(output_size)
        fs = [osz[i] - (int(input.shape[2 + i]) - 1) * st[i] + 2 * pd[i]
              for i in range(3)]
    else:
        fs = _triple(filter_size)
    num_channels = input.shape[1]
    w = helper.create_parameter(
        param_attr, [num_channels, num_filters // groups, fs[0], fs[1], fs[2]],
        input.dtype)
    pre_bias = _out(helper, input.dtype)
    helper.append_op(
        "conv3d_transpose",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs={"strides": st, "paddings": pd,
               "dilations": _triple(dilation), "groups": groups},
    )
    pre_act = helper.append_bias_op(pre_bias, bias_attr, [num_filters], dim_start=1)
    return helper.append_activation(pre_act)


def prelu(x, mode, param_attr=None, name=None):
    """reference layers/nn.py prelu (modes all|channel|element)."""
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [int(x.shape[1])]
    elif mode == "element":
        shape = [int(d) for d in x.shape[1:]]
    else:
        raise ValueError(f"prelu: unknown mode {mode!r}")
    alpha = helper.create_parameter(param_attr, shape, x.dtype,
                                    default_initializer=ConstantInitializer(0.25))
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op("prelu", inputs={"X": [x.name], "Alpha": [alpha.name]},
                     outputs={"Out": [out.name]}, attrs={"mode": mode})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = _out(helper, input.dtype)
    res = _out(helper, input.dtype)
    helper.append_op("huber_loss",
                     inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [out.name], "Residual": [res.name]},
                     attrs={"delta": delta})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1):
    """reference layers/nn.py image_resize: dispatch on resample."""
    if resample.upper() == "BILINEAR":
        return _nn.resize_bilinear(input, out_shape=out_shape, scale=scale,
                                      name=name, align_corners=align_corners)
    if resample.upper() == "NEAREST":
        return _nn.resize_nearest(input, out_shape=out_shape, scale=scale,
                                     name=name, align_corners=align_corners)
    raise ValueError(f"image_resize: unsupported resample {resample!r}")


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """reference layers/nn.py image_resize_short: scale so the short side
    equals out_short_len."""
    h, w = int(input.shape[2]), int(input.shape[3])
    short = min(h, w)
    out_shape = [int(round(h * out_short_len / short)),
                 int(round(w * out_short_len / short))]
    return image_resize(input, out_shape=out_shape, resample=resample)


def deformable_conv(input, offset, mask, num_filters, filter_size, stride=1,
                    padding=0, dilation=1, groups=None,
                    deformable_groups=None, im2col_step=None,
                    param_attr=None, bias_attr=None, modulated=True,
                    name=None):
    """Deformable conv v1/v2 (reference layers/nn.py:11965).  `mask` None
    (or modulated=False) selects v1."""
    helper = LayerHelper("deformable_conv", name=name)
    groups = groups or 1
    deformable_groups = deformable_groups or 1

    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)

    fs = _pair(filter_size)
    if input.shape is None:
        raise ValueError("deformable_conv: input needs a static channel "
                         "count (shape is None)")
    num_channels = int(input.shape[1])
    w = helper.create_parameter(
        param_attr, [num_filters, num_channels // groups, fs[0], fs[1]],
        input.dtype)
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    oh = (int(input.shape[2]) + 2 * pd[0] - (dl[0] * (fs[0] - 1) + 1)) // st[0] + 1
    ow = (int(input.shape[3]) + 2 * pd[1] - (dl[1] * (fs[1] - 1) + 1)) // st[1] + 1
    pre_bias = _out(helper, input.dtype,
                    shape=(input.shape[0], num_filters, oh, ow))
    inputs = {"Input": [input.name], "Offset": [offset.name],
              "Filter": [w.name]}
    if modulated and mask is not None:
        inputs["Mask"] = [mask.name]
    helper.append_op(
        "deformable_conv", inputs=inputs,
        outputs={"Output": [pre_bias.name]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups,
               "deformable_groups": deformable_groups},
    )
    pre_act = helper.append_bias_op(pre_bias, bias_attr, [num_filters],
                                    dim_start=1)
    return pre_act


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1, position_sensitive=False,
                           rois_batch=None, name=None):
    """reference layers/nn.py:12250 deformable_roi_pooling over
    deformable_psroi_pooling_op.h; dense [R, 4] rois + optional batch
    vector (static-shape form)."""
    helper = LayerHelper("deformable_psroi_pooling", name=name)
    c_in = int(input.shape[1])
    gh, gw = (group_size if isinstance(group_size, (list, tuple))
              else (group_size, group_size))
    # reference layers/nn.py: position-sensitive pooling divides channels
    # by the POOLED grid (each bin owns its channel slice)
    output_dim = (c_in // (pooled_height * pooled_width)
                  if position_sensitive else c_in)
    if part_size is None:
        part_size = (pooled_height, pooled_width)
    out = _out(helper, input.dtype)
    cnt = _out(helper, "float32")
    inputs = {"Input": [input.name], "ROIs": [rois.name]}
    if not no_trans and trans is not None:
        inputs["Trans"] = [trans.name]
    if rois_batch is not None:
        inputs["RoisBatch"] = [rois_batch.name]
    helper.append_op(
        "deformable_psroi_pooling", inputs=inputs,
        outputs={"Output": [out.name], "TopCount": [cnt.name]},
        attrs={"no_trans": no_trans, "spatial_scale": spatial_scale,
               "output_dim": output_dim, "group_size": [gh, gw],
               "pooled_height": pooled_height, "pooled_width": pooled_width,
               "part_size": list(part_size),
               "sample_per_part": sample_per_part, "trans_std": trans_std},
    )
    return out
