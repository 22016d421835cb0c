"""Sequence (ragged / LoD) layers (counterpart of paddle_tpu/layers/sequence.py).

A ragged variable is padded dense [batch, time, *feature] with an int32
lengths companion `<name>@LOD` (paddle_tpu_torch/lod.py).  The layers pass
the lengths as an explicit input slot, so a program carried by
`to_dict` / `from_dict` (which drops the Python-side `_lod_ref`) still runs;
ragged outputs carry `_lod_ref` for the next layer.  The port has the
layers of NMT and of the fluid_benchmark models: sequence_pool with its
first / last step forms, sequence_mask, attention_bias, position_encoding,
sequence_conv and dynamic_lstm.
"""
from __future__ import annotations

from ..core.layer_helper import LayerHelper


def _lod_of(x):
    ref = getattr(x, "_lod_ref", None)
    if ref is None:
        raise ValueError(
            f"{x.name!r} is not a ragged variable: declare it with "
            "layers.data(..., lod_level=1) or produce it with a sequence layer")
    return ref


def _set_lod(var, lod_var):
    var._lod_ref = lod_var
    var.lod_level = 1
    return var


def sequence_pool(input, pool_type="average"):
    helper = LayerHelper("sequence_pool")
    lod = _lod_of(input)
    out_shape = None
    if input.shape is not None:
        out_shape = (input.shape[0],) + tuple(input.shape[2:])
    out = helper.create_variable_for_type_inference(input.dtype, shape=out_shape)
    max_index = helper.create_variable_for_type_inference("int32", shape=out_shape)
    helper.append_op(
        "sequence_pool",
        inputs={"X": [input.name], "XLod": [lod.name]},
        outputs={"Out": [out.name], "MaxIndex": [max_index.name]},
        attrs={"pooltype": pool_type.upper()},
    )
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1, padding=True,
                  padding_start=None, bias_attr=None, param_attr=None, act=None, name=None):
    helper = LayerHelper("sequence_conv", name=name, act=act)
    lod = _lod_of(input)
    d = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [filter_size * d, num_filters], input.dtype)
    out_shape = None
    if input.shape is not None:
        out_shape = tuple(input.shape[:2]) + (num_filters,)
    out = helper.create_variable_for_type_inference(input.dtype, shape=out_shape)
    helper.append_op(
        "sequence_conv",
        inputs={"X": [input.name], "XLod": [lod.name], "Filter": [w.name]},
        outputs={"Out": [out.name]},
        attrs={"contextStart": padding_start, "contextLength": filter_size,
               "contextStride": filter_stride},
    )
    pre_act = helper.append_bias_op(out, bias_attr, [num_filters], dim_start=2)
    return _set_lod(helper.append_activation(pre_act), lod)


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None, bias_attr=None,
                 use_peepholes=True, is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 dtype="float32", name=None):
    """`input` is the ragged pre-projected sequence [*, 4D]; returns
    (hidden, cell), both ragged [*, D].  Weight is the (D, 4D) hidden-hidden
    matrix {W_ch, W_ih, W_fh, W_oh}; bias is (1, 4D), or with peepholes
    (1, 7D) = {b, W_ic, W_fc, W_oc}."""
    if gate_activation != "sigmoid" or cell_activation != "tanh" or \
            candidate_activation != "tanh":
        raise NotImplementedError("dynamic_lstm: only the default activations")
    helper = LayerHelper("dynamic_lstm", name=name)
    hidden = size // 4
    lod = _lod_of(input)
    weight = helper.create_parameter(param_attr, [hidden, 4 * hidden], dtype)
    bias_size = [1, 7 * hidden] if use_peepholes else [1, 4 * hidden]
    bias = helper.create_parameter(bias_attr, bias_size, dtype, is_bias=True)
    shape = None
    if input.shape is not None:
        shape = (input.shape[0], input.shape[1], hidden)
    hidden_out = helper.create_variable_for_type_inference(dtype, shape=shape)
    cell_out = helper.create_variable_for_type_inference(dtype, shape=shape)
    inputs = {"Input": [input.name], "XLod": [lod.name], "Weight": [weight.name],
              "Bias": [bias.name]}
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    if c_0 is not None:
        inputs["C0"] = [c_0.name]
    helper.append_op("dynamic_lstm", inputs=inputs,
                     outputs={"Hidden": [hidden_out.name], "Cell": [cell_out.name]},
                     attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse})
    return _set_lod(hidden_out, lod), _set_lod(cell_out, lod)


def sequence_mask(x, maxlen, dtype="int64", name=None):
    """x holds lengths; out[i, t] = t < x[i].  maxlen is a build-time int."""
    helper = LayerHelper("sequence_mask", name=name)
    if maxlen is None or int(maxlen) <= 0:
        raise ValueError("sequence_mask needs a positive build-time maxlen")
    out = helper.create_variable_for_type_inference(dtype, shape=(-1, int(maxlen)))
    helper.append_op("sequence_mask", inputs={"X": [x.name]}, outputs={"Y": [out.name]},
                     attrs={"maxlen": int(maxlen), "out_dtype": dtype})
    return out


def attention_bias(q, k, causal=False, name=None):
    """Additive [b, 1, Tq, Tk] bias masking the padded keys of ragged `k`
    (and the future, with `causal`); add it to pre-softmax scores."""
    helper = LayerHelper("attention_bias", name=name)
    klod = _lod_of(k)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("attention_bias",
                     inputs={"Q": [q.name], "K": [k.name], "KLod": [klod.name]},
                     outputs={"Out": [out.name]}, attrs={"causal": causal})
    return out


def position_encoding(x, name=None):
    """x + sinusoid positions along the (padded) time axis; keeps the lengths."""
    helper = LayerHelper("position_encoding", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("position_encoding", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    ref = getattr(x, "_lod_ref", None)
    return _set_lod(out, ref) if ref is not None else out
