"""NN layer builders (counterpart of
paddle_tpu/layers/nn.py).  Builders only: each appends program ops; all
numerics live in ops/ lowerings.  Each builder emits the same ops, vars and
attrs as its JAX counterpart, so programs serialize identically."""
from __future__ import annotations

import numpy as np

from ..core.initializer import ConstantInitializer, NormalInitializer
from ..core.layer_helper import LayerHelper
from ..core.param_attr import ParamAttr


def _out(helper, dtype, shape=None):
    return helper.create_variable_for_type_inference(dtype, shape=shape)


def _keep_lod(src, out):
    """Carry the ragged lengths companion of `src` to `out`, for a layer
    whose output keeps the time axis (paddle_tpu_torch/lod.py)."""
    ref = getattr(src, "_lod_ref", None)
    if ref is not None:
        out._lod_ref = ref
        out.lod_level = 1
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("fc", name=name, act=act)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_shape = inp.shape
        fan_in = int(np.prod(in_shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, [fan_in, size], inp.dtype)
        out = _out(helper, inp.dtype, shape=tuple(in_shape[:num_flatten_dims]) + (size,))
        helper.append_op(
            "mul",
            inputs={"X": [inp.name], "Y": [w.name]},
            outputs={"Out": [out.name]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = _out(helper, mul_results[0].dtype, shape=mul_results[0].shape)
        helper.append_op("sum", inputs={"X": [v.name for v in mul_results]},
                         outputs={"Out": [pre_bias.name]})
    pre_act = helper.append_bias_op(pre_bias, bias_attr, [size], dim_start=num_flatten_dims)
    out = helper.append_activation(pre_act)
    # a projection that keeps the time axis keeps the lengths companion
    return _keep_lod(inputs[0], out) if num_flatten_dims >= 2 else out


def embedding(input, size, is_sparse=False, is_distributed=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, size, dtype)
    in_shape = input.shape
    out_shape = None
    if in_shape is not None:
        base = in_shape[:-1] if in_shape[-1] == 1 else in_shape
        out_shape = tuple(base) + (size[1],)
    out = _out(helper, dtype, shape=out_shape)
    helper.append_op(
        "lookup_table",
        inputs={"Ids": [input.name], "W": [w.name]},
        outputs={"Out": [out.name]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx},
    )
    return _keep_lod(input, out)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=None,
           param_attr=None, bias_attr=None, use_cudnn=True, act=None, name=None,
           data_format="NCHW"):
    """2-D convolution; the filter is OIHW in either layout, initialized
    N(0, 2 / fan_in); `padding` is [ph, pw] or [top, bottom, left, right].
    The builder records NHWC as the JAX package does; the port's lowering
    runs NCHW only."""
    helper = LayerHelper("conv2d", name=name, act=act)
    groups = groups or 1
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d: data_format must be NCHW or NHWC, got {data_format!r}")
    ch_axis = 1 if data_format == "NCHW" else 3
    num_channels = input.shape[ch_axis]
    filter_shape = [num_filters, num_channels // groups, filter_size[0], filter_size[1]]
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(param_attr, filter_shape, input.dtype,
                                default_initializer=NormalInitializer(0.0, float(np.sqrt(2.0 / fan_in))))
    out_shape = None
    h_axis, w_axis = (2, 3) if data_format == "NCHW" else (1, 2)
    pad_hw = (((padding[0], padding[1]), (padding[2], padding[3])) if len(padding) == 4
              else ((padding[0], padding[0]), (padding[1], padding[1])))
    if input.shape is not None and input.shape[h_axis] is not None:
        def _osz(i, k, p2, s, d):
            if i is None or i < 0:
                return -1
            return (i + p2[0] + p2[1] - (d * (k - 1) + 1)) // s + 1
        oh = _osz(input.shape[h_axis], filter_size[0], pad_hw[0], stride[0], dilation[0])
        ow = _osz(input.shape[w_axis], filter_size[1], pad_hw[1], stride[1], dilation[1])
        out_shape = ((input.shape[0], num_filters, oh, ow) if data_format == "NCHW"
                     else (input.shape[0], oh, ow, num_filters))
    pre_bias = _out(helper, input.dtype, shape=out_shape)
    helper.append_op(
        "conv2d",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation, "groups": groups,
               "data_format": data_format},
    )
    pre_act = helper.append_bias_op(pre_bias, bias_attr, [num_filters], dim_start=ch_axis)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, exclusive=True, name=None,
           data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"pool2d: data_format must be NCHW or NHWC, got {data_format!r}")
    h_axis, w_axis = (2, 3) if data_format == "NCHW" else (1, 2)
    out_shape = None
    if input.shape is not None and not global_pooling:
        def _osz(i, k, p, s):
            if i is None or i < 0:
                return -1
            return (i + 2 * p - k) // s + 1
        oh = _osz(input.shape[h_axis], pool_size[0], pool_padding[0], pool_stride[0])
        ow = _osz(input.shape[w_axis], pool_size[1], pool_padding[1], pool_stride[1])
        out_shape = ((input.shape[0], input.shape[1], oh, ow) if data_format == "NCHW"
                     else (input.shape[0], oh, ow, input.shape[3]))
    elif input.shape is not None:
        out_shape = ((input.shape[0], input.shape[1], 1, 1) if data_format == "NCHW"
                     else (input.shape[0], 1, 1, input.shape[3]))
    out = _out(helper, input.dtype, shape=out_shape)
    helper.append_op(
        "pool2d",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"pooling_type": pool_type, "ksize": pool_size, "strides": pool_stride,
               "paddings": pool_padding, "global_pooling": global_pooling,
               "ceil_mode": ceil_mode, "exclusive": exclusive, "data_format": data_format},
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5, param_attr=None,
               bias_attr=None, data_layout="NCHW", name=None, moving_mean_name=None,
               moving_variance_name=None, use_global_stats=False):
    """Scale, bias and the running mean / variance are float32 whatever the
    input's dtype; the running statistics are persistable, not trainable
    (no gradient, no optimizer update)."""
    helper = LayerHelper("batch_norm", name=name, act=act)
    ch = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = input.dtype
    param_dtype = "float32" if str(dtype) in ("bfloat16", "float16") else dtype
    scale = helper.create_parameter(param_attr, [ch], param_dtype,
                                    default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, [ch], param_dtype, is_bias=True)
    mean_attr = ParamAttr(name=moving_mean_name, initializer=ConstantInitializer(0.0),
                          trainable=False)
    var_attr = ParamAttr(name=moving_variance_name, initializer=ConstantInitializer(1.0),
                         trainable=False)
    mean = helper.create_parameter(mean_attr, [ch], param_dtype)
    variance = helper.create_parameter(var_attr, [ch], param_dtype)
    mean.stop_gradient = True
    variance.stop_gradient = True
    saved_mean = _out(helper, dtype, shape=(ch,))
    saved_var = _out(helper, dtype, shape=(ch,))
    out = _out(helper, dtype, shape=input.shape)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
                "Mean": [mean.name], "Variance": [variance.name]},
        outputs={"Y": [out.name], "MeanOut": [mean.name], "VarianceOut": [variance.name],
                 "SavedMean": [saved_mean.name], "SavedVariance": [saved_var.name]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout, "use_global_stats": use_global_stats},
    )
    return helper.append_activation(out)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    shape = tuple(input.shape[:-1]) + (k,) if input.shape is not None else None
    values = _out(helper, input.dtype, shape=shape)
    indices = _out(helper, "int64", shape=shape)
    helper.append_op("top_k", inputs={"X": [input.name]},
                     outputs={"Out": [values.name], "Indices": [indices.name]}, attrs={"k": k})
    return values, indices


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", name=name, act=act)
    dtype = input.dtype
    norm_size = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(param_attr, [norm_size], dtype,
                                    default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(bias_attr, [norm_size], dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    out = _out(helper, dtype, shape=input.shape)
    mean = _out(helper, dtype)
    var = _out(helper, dtype)
    helper.append_op(
        "layer_norm",
        inputs=inputs,
        outputs={"Y": [out.name], "Mean": [mean.name], "Variance": [var.name]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return _keep_lod(input, helper.append_activation(out))


def dropout_prob_check(p):
    if not 0 <= p < 1:
        raise ValueError("dropout prob must be in [0,1)")


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    mask = _out(helper, x.dtype, shape=x.shape)
    helper.append_op(
        "dropout",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "Mask": [mask.name]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test, "fix_seed": seed is not None,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation},
    )
    return _keep_lod(x, out)


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = _out(helper, input.dtype, shape=input.shape)
    helper.append_op("softmax", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
                     attrs={"axis": axis})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    shape = tuple(input.shape[:-1]) + (1,) if input.shape is not None else None
    out = _out(helper, input.dtype, shape=shape)
    helper.append_op(
        "cross_entropy",
        inputs={"X": [input.name], "Label": [label.name]},
        outputs={"Y": [out.name]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    loss_shape = tuple(logits.shape[:-1]) + (1,) if logits.shape is not None else None
    softmax_out = _out(helper, logits.dtype, shape=logits.shape)
    loss = _out(helper, logits.dtype, shape=loss_shape)
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": [logits.name], "Label": [label.name]},
        outputs={"Loss": [loss.name], "Softmax": [softmax_out.name]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    _keep_lod(logits, loss)
    if return_softmax:
        return loss, softmax_out
    return loss


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = _out(helper, input.dtype, shape=input.shape)
    helper.append_op("square_error_cost", inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [out.name]})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = _out(helper, x.dtype, shape=(1,))
    helper.append_op("mean", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None, normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op(
        "sigmoid_cross_entropy_with_logits",
        inputs={"X": [x.name], "Label": [label.name]},
        outputs={"Out": [out.name]},
        attrs={"ignore_index": ignore_index, "normalize": normalize},
    )
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
    out = _out(helper, input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": [dim] if isinstance(dim, int) else list(dim), "keep_dim": keep_dim,
                 "reduce_all": False}
    helper.append_op("reduce_sum", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
                     attrs=attrs)
    return out


def _act_layer(op_type):
    def f(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = _out(helper, x.dtype, shape=x.shape)
        helper.append_op(op_type, inputs={"X": [x.name]}, outputs={"Out": [out.name]})
        return out

    f.__name__ = op_type
    return f


relu = _act_layer("relu")
relu6 = _act_layer("relu6")
sigmoid = _act_layer("sigmoid")
logsigmoid = _act_layer("logsigmoid")
tanh = _act_layer("tanh")
exp = _act_layer("exp")
log = _act_layer("log")
sqrt = _act_layer("sqrt")
abs = _act_layer("abs")
square = _act_layer("square")
softplus = _act_layer("softplus")
softsign = _act_layer("softsign")
gelu = _act_layer("gelu")
erf = _act_layer("erf")
floor = _act_layer("floor")
ceil = _act_layer("ceil")
round = _act_layer("round")
reciprocal = _act_layer("reciprocal")
sin = _act_layer("sin")
cos = _act_layer("cos")


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op("leaky_relu", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"alpha": alpha})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op(
        "scale",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"scale": float(scale), "bias": float(bias), "bias_after_scale": bias_after_scale},
    )
    return _keep_lod(x, helper.append_activation(out))


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op("pow", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"factor": float(factor)})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op("clip", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op("clip_by_norm", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"max_norm": max_norm})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = _out(helper, "float32")
    helper.append_op("one_hot", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
                     attrs={"depth": depth})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32", name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = _out(helper, dtype, shape=label.shape)
    inputs = {"X": [label.name]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist.name]
    helper.append_op("label_smooth", inputs=inputs, outputs={"Out": [out.name]},
                     attrs={"epsilon": float(epsilon)})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    helper = LayerHelper("mul")
    out = _out(helper, x.dtype)
    helper.append_op(
        "mul",
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
        attrs={"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = _out(helper, x.dtype)  # its shape is inferred at append_op
    helper.append_op(
        "matmul",
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": float(alpha)},
    )
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out_shape = [(x.shape[i] if x.shape is not None else -1) if s == 0 else s
                 for i, s in enumerate(shape)]
    out = _out(helper, x.dtype, shape=tuple(out_shape))
    xshape = _out(helper, x.dtype)
    helper.append_op(
        "reshape2",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "XShape": [xshape.name]},
        attrs={"shape": list(shape)},
    )
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    shape = tuple(x.shape[p] for p in perm) if x.shape is not None else None
    out = _out(helper, x.dtype, shape=shape)
    xshape = _out(helper, x.dtype)
    helper.append_op(
        "transpose2",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "XShape": [xshape.name]},
        attrs={"axis": list(perm)},
    )
    return out


def _elementwise_layer(op_type):
    def f(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = _out(helper, x.dtype, shape=x.shape)
        helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [out.name]}, attrs={"axis": axis})
        return _keep_lod(x, helper.append_activation(out))

    f.__name__ = op_type
    return f


elementwise_add = _elementwise_layer("elementwise_add")
elementwise_sub = _elementwise_layer("elementwise_sub")
elementwise_mul = _elementwise_layer("elementwise_mul")
elementwise_div = _elementwise_layer("elementwise_div")
elementwise_max = _elementwise_layer("elementwise_max")
elementwise_min = _elementwise_layer("elementwise_min")
elementwise_pow = _elementwise_layer("elementwise_pow")


def _reduce_layer(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = _out(helper, input.dtype)
        if dim is None:
            attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        else:
            attrs = {"dim": [dim] if isinstance(dim, int) else list(dim), "keep_dim": keep_dim,
                     "reduce_all": False}
        helper.append_op(op_type, inputs={"X": [input.name]}, outputs={"Out": [out.name]},
                         attrs=attrs)
        return out

    f.__name__ = op_type
    return f


reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else len(input.shape) + dim
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [_out(helper, input.dtype) for _ in range(n)]
    helper.append_op("split", inputs={"X": [input.name]},
                     outputs={"Out": [o.name for o in outs]}, attrs=attrs)
    return outs


def _shape_op(op_type, input, attrs, name):
    """squeeze2 / unsqueeze2: Out and the XShape carrier."""
    helper = LayerHelper(op_type, name=name)
    out = _out(helper, input.dtype)
    xshape = _out(helper, input.dtype)
    helper.append_op(op_type, inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "XShape": [xshape.name]}, attrs=attrs)
    return out


def squeeze(input, axes, name=None):
    return _shape_op("squeeze2", input, {"axes": list(axes)}, name)


def unsqueeze(input, axes, name=None):
    return _shape_op("unsqueeze2", input, {"axes": list(axes)}, name)


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("flatten2", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "XShape": [_out(helper, x.dtype).name]},
                     attrs={"axis": axis})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = _out(helper, xs[0].dtype)
    helper.append_op("stack", inputs={"X": [v.name for v in xs]}, outputs={"Y": [out.name]},
                     attrs={"axis": axis})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    shape = None
    if input.shape is not None:
        shape = list(input.shape)
        for ax, st, en in zip(axes, starts, ends):
            dim = shape[ax]
            if dim is None or dim < 0:
                continue
            st2 = max(st + dim, 0) if st < 0 else min(st, dim)
            en2 = max(en + dim, 0) if en < 0 else min(en, dim)
            shape[ax] = max(en2 - st2, 0)
        shape = tuple(shape)
    out = _out(helper, input.dtype, shape=shape)
    helper.append_op("slice", inputs={"Input": [input.name]}, outputs={"Out": [out.name]},
                     attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends)})
    return out


def space_to_depth(x, blocksize, name=None):
    """[B, C, H, W] -> [B, C*bs^2, H/bs, W/bs] (C must divide bs^2)."""
    helper = LayerHelper("space_to_depth", name=name)
    bs = int(blocksize)
    shape = None
    if x.shape is not None and None not in x.shape[1:]:
        b, c, h, w = x.shape
        shape = (b, c * bs * bs, h // bs, w // bs)
    out = _out(helper, x.dtype, shape=shape)
    helper.append_op("space_to_depth", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"blocksize": bs})
    return out


def l2_normalize(x, axis, epsilon=1e-10, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    norm = _out(helper, x.dtype)
    helper.append_op("norm", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Norm": [norm.name]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def gather(input, index, name=None):
    helper = LayerHelper("gather", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("gather", inputs={"X": [input.name], "Index": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("gather_nd", inputs={"X": [input.name], "Index": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = _out(helper, input.dtype, shape=input.shape)
    helper.append_op("scatter",
                     inputs={"X": [input.name], "Ids": [index.name], "Updates": [updates.name]},
                     outputs={"Out": [out.name]}, attrs={"overwrite": overwrite})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op("cumsum", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"axis": axis, "exclusive": exclusive, "reverse": reverse})
    return out


def argsort(input, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = _out(helper, input.dtype, shape=input.shape)
    ids = _out(helper, "int64", shape=input.shape)
    helper.append_op("argsort", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "Indices": [ids.name]},
                     attrs={"axis": axis, "descending": descending})
    return out, ids


def fused_attention(q, k, v, bias=None, causal=False, scale=None, score_dtype=None, name=None):
    """Fused scaled-dot-product attention over (B, H, L, dh) tensors; `bias`
    is an additive pre-softmax mask (B, 1|H, Lq, Lk), `scale` defaults to
    1/sqrt(dh)."""
    helper = LayerHelper("fused_attention", name=name)
    out = _out(helper, q.dtype, shape=q.shape)
    inputs = {"Q": [q.name], "K": [k.name], "V": [v.name]}
    if bias is not None:
        inputs["Bias"] = [bias.name]
    attrs = {"causal": causal}
    if scale is not None:
        attrs["scale"] = float(scale)
    if score_dtype is not None:
        sd = {"bf16": "bfloat16", "bfloat16": "bfloat16",
              "float32": "float32", "fp32": "float32"}.get(str(score_dtype))
        if sd is None:
            raise ValueError(f"fused_attention: score_dtype must be 'float32' or "
                             f"'bfloat16', got {score_dtype!r}")
        attrs["score_dtype"] = sd
    helper.append_op("fused_attention", inputs=inputs, outputs={"Out": [out.name]}, attrs=attrs)
    return out


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None, stride=1, padding=0,
                     dilation=1, groups=None, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv2d_transpose", name=name, act=act)
    groups = groups or 1
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    num_channels = input.shape[1]
    filter_shape = [num_channels, num_filters // groups, filter_size[0], filter_size[1]]
    w = helper.create_parameter(param_attr, filter_shape, input.dtype)
    pre_bias = _out(helper, input.dtype)
    helper.append_op(
        "conv2d_transpose",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation, "groups": groups},
    )
    pre_act = helper.append_bias_op(pre_bias, bias_attr, [num_filters], dim_start=1)
    return helper.append_activation(pre_act)


def resize_bilinear(input, out_shape=None, scale=None, name=None, align_corners=True):
    """reference nn.py resize_bilinear over bilinear_interp_op."""
    helper = LayerHelper("bilinear_interp", name=name)
    attrs = {"align_corners": align_corners}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
        oshape = None
        if input.shape is not None:
            oshape = (input.shape[0], input.shape[1], attrs["out_h"], attrs["out_w"])
    else:
        attrs["scale"] = float(scale)
        oshape = None
    out = _out(helper, input.dtype, shape=oshape)
    helper.append_op("bilinear_interp", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def resize_nearest(input, out_shape=None, scale=None, name=None, align_corners=True):
    helper = LayerHelper("nearest_interp", name=name)
    attrs = {"align_corners": align_corners}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    else:
        attrs["scale"] = float(scale)
    out = _out(helper, input.dtype)
    helper.append_op("nearest_interp", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0, name=None):
    helper = LayerHelper("pad2d", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("pad2d", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": pad_value})
    return out


def crop(x, shape=None, offsets=None, name=None):
    if shape is None:
        raise ValueError("crop: `shape` is required (static output extents)")
    helper = LayerHelper("crop", name=name)
    out = _out(helper, x.dtype, shape=tuple(shape) if shape else None)
    helper.append_op("crop", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"offsets": list(offsets or [0] * len(shape)),
                            "shape": list(shape)})
    return out


def Print(input, first_n=-1, message=None, summarize=-1, print_tensor_name=True,
          print_tensor_type=True, print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """reference layers.Print (print_op.cc): identity that prints at
    execution (a host read: its plan runs eagerly)."""
    helper = LayerHelper("print")
    out = _out(helper, input.dtype, shape=input.shape)
    msg = message or f"{input.name}: " if print_tensor_name else (message or "")
    helper.append_op("print", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
                     attrs={"message": msg, "first_n": first_n})
    return out


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", name=name, act=act)
    if data_layout != "NCHW":
        raise NotImplementedError("group_norm: only NCHW")
    c = input.shape[1]
    scale = helper.create_parameter(param_attr, [c], input.dtype,
                                    default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, [c], input.dtype, is_bias=True)
    out = _out(helper, input.dtype, shape=input.shape)
    mean = _out(helper, "float32")
    var = _out(helper, "float32")
    helper.append_op(
        "group_norm",
        inputs={"X": [input.name], "Scale": [scale.name], "Bias": [bias.name]},
        outputs={"Y": [out.name], "Mean": [mean.name], "Variance": [var.name]},
        attrs={"epsilon": epsilon, "groups": groups},
    )
    return helper.append_activation(out)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None, name=None):
    helper = LayerHelper("instance_norm", name=name)
    c = input.shape[1]
    scale = helper.create_parameter(param_attr, [c], input.dtype,
                                    default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, [c], input.dtype, is_bias=True)
    out = _out(helper, input.dtype, shape=input.shape)
    smean = _out(helper, "float32")
    svar = _out(helper, "float32")
    helper.append_op(
        "instance_norm",
        inputs={"X": [input.name], "Scale": [scale.name], "Bias": [bias.name]},
        outputs={"Y": [out.name], "SavedMean": [smean.name],
                 "SavedVariance": [svar.name]},
        attrs={"epsilon": epsilon},
    )
    return out


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Embed a host python callable in the program (reference layers.py_func
    over py_func_op.cc).  `out` declares the output variables (shapes/dtypes
    must be exact); backward_func is not supported (the callable is opaque
    to autodiff; stop-gradient semantics)."""
    from ..ops.control_flow_ops import register_py_func

    if backward_func is not None:
        raise NotImplementedError(
            "py_func: backward_func is not supported — the host callback is "
            "opaque to the vjp; compute gradients with program ops instead")
    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    for o in outs:
        if o.shape is None or any(s is None or s < 0 for s in o.shape):
            raise ValueError(
                f"py_func: output {o.name!r} needs a fully static shape")
    fid = register_py_func(func)
    helper.append_op(
        "py_func",
        inputs={"X": [v.name for v in xs]},
        outputs={"Out": [o.name for o in outs]},
        attrs={"func_id": fid,
               "out_shapes": [list(o.shape) for o in outs],
               "out_dtypes": [str(o.dtype) for o in outs]},
    )
    return out
