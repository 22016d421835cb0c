"""Sequence (ragged / LoD) layers (counterpart of paddle_tpu/layers/sequence.py).

A ragged variable is padded dense [batch, time, *feature] with an int32
lengths companion `<name>@LOD` (paddle_tpu_torch/lod.py).  The layers pass
the lengths as an explicit input slot, so a program carried by
`to_dict` / `from_dict` (which drops the Python-side `_lod_ref`) still runs;
ragged outputs carry `_lod_ref` for the next layer.  The port has the four
layers NMT uses so far.
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
