"""The layers of the JAX package's layers/tail.py (counterpart of it): the
attr'd and plain activations of its tail, the logic, compare and boolean
reduce layers, the tail losses, the shape and tensor utilities (shape,
pad, unstack, range, sum, rank, create_tensor / create_parameter, the
step counter), the random and batch-size-like fills, the shape shufflers,
adaptive pooling, bilinear_tensor_product, data_norm, the SelectedRows
helpers, the one-step recurrences, prelu, conv3d_transpose, image_resize,
the deformable layers and the reader aliases (batch, shuffle,
double_buffer; load raises, as in the JAX package)."""
from __future__ import annotations

import builtins

from ..core import unique_name
from ..core.initializer import ConstantInitializer
from ..core.layer_helper import LayerHelper
from ..core.program import default_main_program, default_startup_program
from . import nn as _nn
from . import tensor as _tensor
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


brelu = _attr_act("brelu", [("t_min", 0.0), ("t_max", 24.0)])
soft_relu = _attr_act("soft_relu", [("threshold", 40.0)])
thresholded_relu = _attr_act("thresholded_relu", [("threshold", 1.0)])
logical_xor = _binary_layer("logical_xor", out_dtype="bool")


def _reduce_layer(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = _out(helper, "bool")
        dims = dim if dim is None or isinstance(dim, (list, tuple)) else [dim]
        helper.append_op(op_type, inputs={"X": [input.name]},
                         outputs={"Out": [out.name]},
                         attrs={"dim": list(dims) if dims else None,
                                "keep_dim": keep_dim})
        return out

    f.__name__ = op_type
    return f


reduce_all = _reduce_layer("reduce_all")
reduce_any = _reduce_layer("reduce_any")


def _scalar_probe(op_type):
    def f(x):
        helper = LayerHelper(op_type)
        out = _out(helper, "bool", shape=(1,))
        helper.append_op(op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]})
        return out

    f.__name__ = op_type
    return f


has_inf = _scalar_probe("has_inf")
has_nan = _scalar_probe("has_nan")
isfinite = _scalar_probe("isfinite")


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    out = cond if cond is not None else _out(helper, "bool", shape=(1,))
    helper.append_op("is_empty", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = _out(helper, X.dtype)
    xn = _out(helper, X.dtype)
    yn = _out(helper, X.dtype)
    helper.append_op("cos_sim", inputs={"X": [X.name], "Y": [Y.name]},
                     outputs={"Out": [out.name], "XNorm": [xn.name],
                              "YNorm": [yn.name]})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    out = _out(helper, x.dtype)
    diff = _out(helper, x.dtype)
    inputs = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight.name]
    helper.append_op("smooth_l1_loss", inputs=inputs,
                     outputs={"Out": [out.name], "Diff": [diff.name]},
                     attrs={"sigma": 1.0 if sigma is None else sigma})
    return out


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    helper = LayerHelper("teacher_student_sigmoid_loss")
    out = _out(helper, input.dtype)
    helper.append_op("teacher_student_sigmoid_loss",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Y": [out.name]},
                     attrs={"soft_max_up_bound": soft_max_up_bound,
                            "soft_max_lower_bound": soft_max_lower_bound})
    return out


def dice_loss(input, label, epsilon=1e-5):
    """reference layers/nn.py dice_loss: composed from elementwise ops —
    mean over rows of 1 - 2*|input ∩ label| / (|input| + |label| + eps)."""
    label = _tensor.cast(label, input.dtype)
    reduce_dim = list(builtins.range(1, len(input.shape)))
    inse = _nn.reduce_sum(input * label, dim=reduce_dim)
    denom = (_nn.reduce_sum(input, dim=reduce_dim)
             + _nn.reduce_sum(label, dim=reduce_dim))
    dice = 1.0 - (inse * 2.0) / (denom + epsilon)
    return _nn.reduce_mean(dice)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """reference layers/nn.py npair_loss: composed cross-entropy over
    anchor @ positive^T similarity + l2 on embeddings."""
    labels = _tensor.cast(_nn.reshape(labels, [-1, 1]), "float32")
    same = _tensor.cast(_eq_matrix(labels), "float32")
    norm = _nn.reduce_sum(same, dim=1, keep_dim=True)
    target = same / norm
    sim = _nn.matmul(anchor, positive, transpose_y=True)
    ce = _nn.softmax_with_cross_entropy(sim, target, soft_label=True)
    celoss = _nn.reduce_mean(ce)
    # batch-mean of per-row squared norms (robust to dynamic batch dim)
    row_l2 = _nn.reduce_sum(anchor * anchor + positive * positive, dim=1)
    l2 = _nn.scale(_nn.reduce_mean(row_l2), scale=l2_reg)
    return celoss + l2


def _eq_matrix(labels):
    from .math_sugar import binary

    lt = _nn.transpose(labels, [1, 0])
    return binary(labels, lt, "equal")


def rank(input):
    """reference layers/nn.py rank: the static rank as a constant tensor."""
    return _tensor.fill_constant([1], "int32", len(input.shape))


def sum(x):
    """reference layers/tensor.py sum: elementwise sum of a var list."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    helper = LayerHelper("sum")
    out = _out(helper, xs[0].dtype, shape=xs[0].shape)
    helper.append_op("sum", inputs={"X": [v.name for v in xs]},
                     outputs={"Out": [out.name]})
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """reference pad_constant_like_op.cc: pad y up to x's shape.  Dims x
    doesn't know statically (the batch dim, -1) are left unpadded."""
    paddings = []
    for xd, yd in zip(x.shape, y.shape):
        delta = int(xd) - int(yd) if xd is not None and int(xd) > 0 else 0
        paddings += [0, max(delta, 0)]
    return pad(y, paddings, pad_value=pad_value, name=name)


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.main_block.create_var(
        name or unique_name.generate("create_tensor"), dtype=dtype,
        persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..core.param_attr import ParamAttr

    helper = LayerHelper("create_parameter")
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias=is_bias,
                                   default_initializer=default_initializer)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """reference layers/tensor.py: a persistable int counter incremented
    once per executed step."""
    name = counter_name or "@STEP_COUNTER@"
    main = default_main_program().global_block()
    if main.has_var(name):
        return main.var(name)
    counter = main.create_var(name, shape=(1,), dtype="int64", persistable=True)
    startup = default_startup_program().global_block()
    startup.create_var(name, shape=(1,), dtype="int64", persistable=True)
    startup.append_op("fill_constant", outputs={"Out": [name]},
                      attrs={"shape": [1], "dtype": "int64",
                             "value": float(begin - step)})
    main.append_op("increment", inputs={"X": [name]}, outputs={"Out": [name]},
                   attrs={"step": float(step)})
    return counter


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = _out(helper, dtype)
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = _out(helper, dtype)
    helper.append_op("uniform_random_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx,
                            "min": min, "max": max, "seed": seed})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = _out(helper, dtype)
    helper.append_op("gaussian_random_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx,
                            "mean": mean, "std": std, "seed": seed})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id")
    out = _out(helper, "int32", shape=(x.shape[0],))
    helper.append_op("sampling_id", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"min": min, "max": max, "seed": seed})
    return out


def pixel_shuffle(x, upscale_factor):
    helper = LayerHelper("pixel_shuffle")
    n, c, h, w = x.shape
    r = upscale_factor
    out = _out(helper, x.dtype, shape=(n, c // (r * r), h * r, w * r))
    helper.append_op("pixel_shuffle", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"upscale_factor": r})
    return out


def shuffle_channel(x, group, name=None):
    helper = LayerHelper("shuffle_channel", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op("shuffle_channel", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"group": group})
    return out


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    helper = LayerHelper("temporal_shift", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op("temporal_shift", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"seg_num": seg_num, "shift_ratio": shift_ratio})
    return out


def fsp_matrix(x, y):
    helper = LayerHelper("fsp")
    out = _out(helper, x.dtype, shape=(x.shape[0], x.shape[1], y.shape[1]))
    helper.append_op("fsp", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]})
    return out


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    helper = LayerHelper("unfold", name=name)

    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)

    out = _out(helper, x.dtype)
    helper.append_op("unfold", inputs={"X": [x.name]},
                     outputs={"Y": [out.name]},
                     attrs={"kernel_sizes": _pair(kernel_sizes),
                            "strides": _pair(strides),
                            "paddings": _pair(paddings),
                            "dilations": _pair(dilations)})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    if require_index:
        raise NotImplementedError("adaptive_pool2d: require_index (mask "
                                  "output) is not implemented")
    helper = LayerHelper("adaptive_pool2d", name=name)
    ps = [pool_size, pool_size] if isinstance(pool_size, int) else list(pool_size)
    oshape = ((input.shape[0], input.shape[1], ps[0], ps[1])
              if input.shape is not None else None)
    out = _out(helper, input.dtype, shape=oshape)
    helper.append_op("adaptive_pool2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooled_size": ps, "pooling_type": pool_type})
    return out


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    if require_index:
        raise NotImplementedError("adaptive_pool3d: require_index is not "
                                  "implemented")
    helper = LayerHelper("adaptive_pool3d", name=name)
    ps = [pool_size] * 3 if isinstance(pool_size, int) else list(pool_size)
    out = _out(helper, input.dtype)
    helper.append_op("adaptive_pool3d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooled_size": ps, "pooling_type": pool_type})
    return out


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    helper = LayerHelper("add_position_encoding", name=name)
    out = _out(helper, input.dtype, shape=input.shape)
    helper.append_op("add_position_encoding", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"alpha": alpha, "beta": beta})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None,
                            bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", name=name, act=act)
    dx, dy = int(x.shape[-1]), int(y.shape[-1])
    w = helper.create_parameter(param_attr, [size, dx, dy], x.dtype)
    out = _out(helper, x.dtype, shape=(x.shape[0], size))
    inputs = {"X": [x.name], "Y": [y.name], "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [1, size], x.dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    helper.append_op("bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out.name]})
    return helper.append_activation(out)


def continuous_value_model(input, cvm, use_cvm=True):
    helper = LayerHelper("cvm")
    out = _out(helper, input.dtype)
    helper.append_op("cvm", inputs={"X": [input.name], "CVM": [cvm.name]},
                     outputs={"Y": [out.name]}, attrs={"use_cvm": use_cvm})
    return out


def data_norm(input, act=None, epsilon=1e-05, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    """reference layers/nn.py data_norm: normalization by accumulated batch
    statistics with three persistable accumulators."""
    helper = LayerHelper("data_norm", name=name, act=act)
    d = int(input.shape[-1])

    def _acc(suffix, value):
        vname = unique_name.generate(f"data_norm.{suffix}")
        main = helper.main_program.global_block()
        v = main.create_var(vname, shape=(d,), dtype="float32", persistable=True)
        startup = default_startup_program().global_block()
        startup.create_var(vname, shape=(d,), dtype="float32", persistable=True)
        startup.append_op("fill_constant", outputs={"Out": [vname]},
                          attrs={"shape": [d], "dtype": "float32",
                                 "value": value})
        return v

    size = _acc("batch_size", 1e4)
    xsum = _acc("batch_sum", 0.0)
    sqs = _acc("batch_square_sum", 1e4)
    y = _out(helper, input.dtype, shape=input.shape)
    means = _out(helper, "float32")
    scales = _out(helper, "float32")
    helper.append_op(
        "data_norm",
        inputs={"X": [input.name], "BatchSize": [size.name],
                "BatchSum": [xsum.name], "BatchSquareSum": [sqs.name]},
        outputs={"Y": [y.name], "Means": [means.name], "Scales": [scales.name],
                 "BatchSizeOut": [size.name], "BatchSumOut": [xsum.name],
                 "BatchSquareSumOut": [sqs.name]},
        attrs={"epsilon": epsilon},
    )
    return helper.append_activation(y)


def get_tensor_from_selected_rows(x, name=None):
    helper = LayerHelper("get_tensor_from_selected_rows", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("get_tensor_from_selected_rows",
                     inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


def merge_selected_rows(x, name=None):
    helper = LayerHelper("merge_selected_rows", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("merge_selected_rows", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop")
    out = _out(helper, x.dtype)
    helper.append_op("random_crop", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape)})
    return out


def batch(reader, batch_size):
    """reference layers/io.py batch: alias of the reader decorator (the
    reader-op stack is subsumed by the python reader pipeline)."""
    from .. import reader as _reader

    return _reader.batch(reader, batch_size)


def shuffle(reader, buffer_size):
    """reference layers/io.py shuffle: reader-decorator alias."""
    from .. import reader as _reader

    return _reader.shuffle(reader, buffer_size)


def double_buffer(reader, place=None, name=None):
    """reference layers/io.py double_buffer: the DataLoader's background
    prefetch thread is the TPU-native double buffer; pass-through here."""
    return reader


def load(out, file_path, load_as_fp16=None):
    """reference layers/io.py load op: read one saved variable into `out`
    at build time via the io module."""
    from .. import io as _io

    raise NotImplementedError(
        "layers.load: use fluid.io.load_vars/load_persistables (program-"
        "level load ops have no XLA residue; IO happens host-side)")
