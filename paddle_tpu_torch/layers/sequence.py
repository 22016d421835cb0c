"""Sequence (ragged / LoD) layers (counterpart of paddle_tpu/layers/sequence.py).

A ragged variable is padded dense [batch, time, *feature] with an int32
lengths companion `<name>@LOD` (paddle_tpu_torch/lod.py).  The layers pass
the lengths as an explicit input slot, so a program carried by
`to_dict` / `from_dict` (which drops the Python-side `_lod_ref`) still runs;
ragged outputs carry `_lod_ref` for the next layer.  The layers: the
sequence_* family, attention_bias, position_encoding, the recurrences
(dynamic_lstm, dynamic_lstmp, dynamic_gru, lstm), warpctc, the CRF pair
(linear_chain_crf, crf_decoding) and the with-block RNNs DynamicRNN and
StaticRNN, whose sub-block the `dynamic_rnn` op runs once a time step.

`fc`, `concat` and `elementwise_mul` do not carry the lengths companion
(the JAX package's do not either): a program that passes their output to a
sequence layer sets it by hand, `_set_lod(out, _lod_of(src))`.
"""
from __future__ import annotations

from ..core import unique_name
from ..core.layer_helper import LayerHelper
from ..core.program import default_main_program


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


def _new_lod_var(helper):
    return helper.create_variable_for_type_inference("int32", shape=(-1,))


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


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    lod = _lod_of(input)
    out = helper.create_variable_for_type_inference(input.dtype, shape=input.shape)
    helper.append_op(
        "sequence_softmax",
        inputs={"X": [input.name], "XLod": [lod.name]},
        outputs={"Out": [out.name]},
    )
    return _set_lod(out, lod)


def sequence_expand(x, y, ref_level=-1, name=None):
    """Broadcast one row of x per batch item across y's time axis, masked to
    y's lengths (sequence_expand of a lod-level-0 x)."""
    helper = LayerHelper("sequence_expand", name=name)
    ylod = _lod_of(y)
    out_shape = None
    if x.shape is not None and y.shape is not None:
        feat = tuple(x.shape[1:]) if len(x.shape) == 2 or x.shape[1] != 1 else tuple(x.shape[2:])
        out_shape = (x.shape[0], y.shape[1]) + feat
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    helper.append_op(
        "sequence_expand",
        inputs={"X": [x.name], "Y": [y.name], "YLod": [ylod.name]},
        outputs={"Out": [out.name]},
        attrs={"ref_level": ref_level},
    )
    return _set_lod(out, ylod)


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y, name=name)


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    lod = _lod_of(x)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(
        "sequence_reverse",
        inputs={"X": [x.name], "XLod": [lod.name]},
        outputs={"Out": [out.name]},
    )
    return _set_lod(out, lod)


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """Returns (padded dense tensor, lengths): the op's (Out, Length)."""
    helper = LayerHelper("sequence_pad", name=name)
    lod = _lod_of(x)
    T = maxlen if maxlen is not None else (x.shape[1] if x.shape is not None else None)
    out_shape = None
    if x.shape is not None and T is not None and T > 0:
        out_shape = (x.shape[0], T) + tuple(x.shape[2:])
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    length = helper.create_variable_for_type_inference("int64", shape=(-1,))
    helper.append_op(
        "sequence_pad",
        inputs={"X": [x.name], "XLod": [lod.name], "PadValue": [pad_value.name]},
        outputs={"Out": [out.name], "Length": [length.name]},
        attrs={"padded_length": -1 if maxlen is None else int(maxlen)},
    )
    return out, length


def sequence_unpad(x, length, name=None):
    """Dense [b, T, *f] + lengths -> ragged variable."""
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    out_lod = _new_lod_var(helper)
    helper.append_op(
        "sequence_unpad",
        inputs={"X": [x.name], "Length": [length.name]},
        outputs={"Out": [out.name], "OutLod": [out_lod.name]},
    )
    return _set_lod(out, out_lod)


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    xs = list(input)
    lods = [_lod_of(x) for x in xs]
    T_out = None
    if all(x.shape is not None and x.shape[1] and x.shape[1] > 0 for x in xs):
        T_out = sum(int(x.shape[1]) for x in xs)
    out_shape = None
    if xs[0].shape is not None and T_out is not None:
        out_shape = (xs[0].shape[0], T_out) + tuple(xs[0].shape[2:])
    out = helper.create_variable_for_type_inference(xs[0].dtype, shape=out_shape)
    out_lod = _new_lod_var(helper)
    helper.append_op(
        "sequence_concat",
        inputs={"X": [x.name for x in xs], "XLod": [l.name for l in lods]},
        outputs={"Out": [out.name], "OutLod": [out_lod.name]},
    )
    return _set_lod(out, out_lod)


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    lod = _lod_of(input)
    out = helper.create_variable_for_type_inference(input.dtype, shape=input.shape)
    out_lod = _new_lod_var(helper)
    helper.append_op(
        "sequence_slice",
        inputs={"X": [input.name], "XLod": [lod.name],
                "Offset": [offset.name], "Length": [length.name]},
        outputs={"Out": [out.name], "OutLod": [out_lod.name]},
    )
    return _set_lod(out, out_lod)


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", name=name)
    lod = _lod_of(input)
    out = helper.create_variable_for_type_inference(input.dtype, shape=input.shape)
    out_lod = _new_lod_var(helper)
    helper.append_op(
        "sequence_erase",
        inputs={"X": [input.name], "XLod": [lod.name]},
        outputs={"Out": [out.name], "OutLod": [out_lod.name]},
        attrs={"tokens": list(tokens)},
    )
    return _set_lod(out, out_lod)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    lod = _lod_of(input)
    out_shape = None
    if input.shape is not None:
        out_shape = tuple(input.shape[:2]) + (win_size,)
    out = helper.create_variable_for_type_inference(input.dtype, shape=out_shape)
    out_lod = _new_lod_var(helper)
    helper.append_op(
        "sequence_enumerate",
        inputs={"X": [input.name], "XLod": [lod.name]},
        outputs={"Out": [out.name], "OutLod": [out_lod.name]},
        attrs={"win_size": win_size, "pad_value": pad_value},
    )
    return _set_lod(out, out_lod)


class DynamicRNN:
    """With-block RNN over a ragged input.  The body is a sub-block that the
    `dynamic_rnn` op (ops/sequence_ops.py) runs once a time step over the
    padded batch, memories frozen and outputs 0 past each row's length: no
    host read, so a plan that holds it replays as one CUDA graph.

        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(emb)         # [b, f] per step
            prev = drnn.memory(shape=[h])        # carried state
            hidden = layers.fc([word, prev], h, act="tanh")
            drnn.update_memory(prev, hidden)
            drnn.output(hidden)
        out = drnn()                             # ragged [b, T, h]
    """

    def __init__(self, name=None, is_reverse=False):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.main = default_main_program()
        self._steps = []      # (src Variable, sub Variable)
        self._mems = []       # dict(sub, init, shape, dtype, update)
        self._outputs = []    # sub Variables
        self._out_vars = None
        self._lod = None
        self._sub_block = None
        self.is_reverse = is_reverse
        self._allow_dense = False

    def block(self):
        return _DRNNGuard(self)

    def _require_in_block(self):
        if self._sub_block is None or self.main.current_block() is not self._sub_block:
            raise RuntimeError("call inside `with drnn.block():`")

    def step_input(self, x):
        self._require_in_block()
        lod = getattr(x, "_lod_ref", None) if self._allow_dense else _lod_of(x)
        if self._lod is None:
            self._lod = lod
        shape = None
        if x.shape is not None:
            shape = (x.shape[0],) + tuple(x.shape[2:])
        sub = self._sub_block.create_var(
            unique_name.generate("drnn.step"), shape=shape, dtype=x.dtype
        )
        self._steps.append((x, sub))
        return sub

    def static_input(self, x):
        # outer vars are visible inside the scan body via env capture
        self._require_in_block()
        return x

    def memory(self, init=None, shape=None, value=0.0, dtype="float32"):
        self._require_in_block()
        if init is not None:
            shape_full = init.shape
            dtype = init.dtype
        else:
            if shape is None:
                raise ValueError("memory() needs init= or shape=")
            shape_full = (-1,) + tuple(int(s) for s in shape)
        sub = self._sub_block.create_var(
            unique_name.generate("drnn.mem"), shape=shape_full, dtype=dtype
        )
        self._mems.append(
            {"sub": sub, "init": init, "shape": shape, "dtype": str(dtype), "update": None,
             "value": value}
        )
        return sub

    def update_memory(self, mem, new):
        self._require_in_block()
        for m in self._mems:
            if m["sub"].name == mem.name:
                m["update"] = new
                return
        raise ValueError(f"{mem.name!r} is not a drnn memory")

    def output(self, *outputs):
        self._require_in_block()
        self._outputs.extend(outputs)

    def _finalize(self, parent_block, sub_idx):
        helper = self.helper
        if not self._steps:
            raise ValueError("DynamicRNN needs at least one step_input")
        for m in self._mems:
            if m["update"] is None:
                raise ValueError(f"memory {m['sub'].name!r} never updated")
        out_vars = []
        for o in self._outputs:
            shape = None
            src = self._steps[0][0]
            if o.shape is not None and src.shape is not None:
                shape = (src.shape[0], src.shape[1]) + tuple(o.shape[1:])
            ov = parent_block.create_var(
                unique_name.generate("drnn.out"), shape=shape, dtype=o.dtype
            )
            out_vars.append(ov)
        final_mems = []
        for m in self._mems:
            fv = parent_block.create_var(
                unique_name.generate("drnn.final_mem"),
                shape=m["sub"].shape,
                dtype=m["sub"].dtype,
            )
            final_mems.append(fv)
        inits = [m["init"] for m in self._mems if m["init"] is not None]
        rnn_inputs = {
            "X": [src.name for src, _ in self._steps],
            "MemInit": [v.name for v in inits],
        }
        if self._lod is not None:
            rnn_inputs["XLod"] = [self._lod.name]
        parent_block.append_op(
            "dynamic_rnn",
            inputs=rnn_inputs,
            outputs={
                "Out": [v.name for v in out_vars],
                "FinalMem": [v.name for v in final_mems],
            },
            attrs={
                "sub_block": sub_idx,
                "step_vars": [sub.name for _, sub in self._steps],
                "mem_vars": [m["sub"].name for m in self._mems],
                "mem_updates": [m["update"].name for m in self._mems],
                "out_vars": [o.name for o in self._outputs],
                "mem_has_init": [m["init"] is not None for m in self._mems],
                "mem_shapes": [list(m["shape"] or []) for m in self._mems],
                "mem_dtypes": [m["dtype"] for m in self._mems],
                "mem_values": [float(m["value"]) for m in self._mems],
                "is_reverse": self.is_reverse,
            },
        )
        if self._lod is not None:
            for ov in out_vars:
                _set_lod(ov, self._lod)
        self._out_vars = out_vars
        self._final_mems = final_mems

    def __call__(self):
        if self._out_vars is None:
            raise RuntimeError("DynamicRNN block not finished")
        return self._out_vars[0] if len(self._out_vars) == 1 else self._out_vars


class _DRNNGuard:
    def __init__(self, drnn: DynamicRNN):
        self.drnn = drnn
        self.main = drnn.main

    def __enter__(self):
        self.parent_block = self.main.current_block()
        self.drnn._sub_block = self.main.create_block()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.main.rollback()
            return False
        sub_idx = self.drnn._sub_block.idx
        self.main.rollback()
        self.drnn._finalize(self.parent_block, sub_idx)
        return False


def dynamic_gru(input, size, param_attr=None, bias_attr=None, is_reverse=False,
                gate_activation="sigmoid", candidate_activation="tanh",
                h_0=None, origin_mode=False, name=None):
    """Reference layers/nn.py dynamic_gru — `input` is ragged [*, 3D];
    returns ragged hidden [*, D]."""
    if gate_activation != "sigmoid" or candidate_activation != "tanh":
        raise NotImplementedError("dynamic_gru: only the default activations")
    helper = LayerHelper("dynamic_gru", name=name)
    lod = _lod_of(input)
    dtype = input.dtype
    weight = helper.create_parameter(param_attr, [size, 3 * size], dtype)
    bias = helper.create_parameter(bias_attr, [1, 3 * size], dtype, is_bias=True)
    shape = None
    if input.shape is not None:
        shape = (input.shape[0], input.shape[1], size)
    out = helper.create_variable_for_type_inference(dtype, shape=shape)
    inputs = {"Input": [input.name], "XLod": [lod.name], "Weight": [weight.name],
              "Bias": [bias.name]}
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    helper.append_op(
        "dynamic_gru", inputs=inputs, outputs={"Hidden": [out.name]},
        attrs={"is_reverse": is_reverse, "origin_mode": origin_mode},
    )
    return _set_lod(out, lod)


def warpctc(input, label, blank=0, norm_by_times=False):
    """CTC loss over ragged logits/labels.
    `input`: ragged [*, C] unnormalized logits; `label`: ragged [*, 1] int
    targets.  Returns [b, 1] per-sequence loss."""
    helper = LayerHelper("warpctc")
    in_lod = _lod_of(input)
    lbl_lod = _lod_of(label)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "warpctc",
        inputs={"Logits": [input.name], "XLod": [in_lod.name],
                "Label": [label.name], "LabelLod": [lbl_lod.name]},
        outputs={"Loss": [out.name]},
        attrs={"blank": blank, "norm_by_times": norm_by_times},
    )
    return out


class StaticRNN(DynamicRNN):
    """Fixed-length RNN over dense [b, T, f] inputs.  Same with-block API as DynamicRNN; every row runs the full
    padded length (lengths companion optional)."""

    def __init__(self, name=None):
        super().__init__(name=name)
        self._allow_dense = True

    def step(self):
        """The with-block context, under StaticRNN's name."""
        return self.block()

    def step_output(self, o):
        """The single-output form of output()."""
        return self.output(o)


def linear_chain_crf(input, label, param_attr=None):
    """CRF negative log-likelihood layer.  `input`: ragged [*, D] unnormalized tag scores;
    `label`: ragged [*, 1] int tags.  Creates the [D+2, D] transition
    parameter (rows 0/1 = start/end weights) and returns the per-sequence
    [b, 1] cost.  Share the parameter with crf_decoding via a named
    ParamAttr (by convention name="crfw")."""
    helper = LayerHelper("linear_chain_crf")
    in_lod = _lod_of(input)
    lbl_lod = _lod_of(label)
    tag_num = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [tag_num + 2, tag_num], "float32")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "linear_chain_crf",
        inputs={"Emission": [input.name], "XLod": [in_lod.name],
                "Transition": [w.name],
                "Label": [label.name], "LabelLod": [lbl_lod.name]},
        outputs={"LogLikelihood": [out.name]},
    )
    return out


def crf_decoding(input, param_attr, label=None):
    """Viterbi decode layer.  Reuses
    the transition parameter trained by linear_chain_crf (same named
    ParamAttr).  Without `label`: [b, T] int64 best tag paths (0 past each
    row's length).  With `label`: per-position 0/1 correctness indicator."""
    helper = LayerHelper("crf_decoding")
    in_lod = _lod_of(input)
    tag_num = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [tag_num + 2, tag_num], "float32")
    out = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": [input.name], "XLod": [in_lod.name],
              "Transition": [w.name]}
    if label is not None:
        inputs["Label"] = [label.name]
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [out.name]})
    _set_lod(out, in_lod)
    return out


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """Projection LSTM (the `dynamic_lstmp` op).  `input` ragged [*, 4D]; returns (projection [*, P],
    cell [*, D]); the projection activation (default 'tanh') is applied to h @ W_proj inside the recurrence."""
    if gate_activation != "sigmoid" or cell_activation != "tanh" or \
            candidate_activation != "tanh":
        raise NotImplementedError("dynamic_lstmp: only the default activations")
    if proj_activation not in ("tanh", "sigmoid", "relu", "identity"):
        raise NotImplementedError(
            f"dynamic_lstmp: proj_activation {proj_activation!r}")
    helper = LayerHelper("dynamic_lstmp", name=name)
    hidden = size // 4
    lod = _lod_of(input)
    weight = helper.create_parameter(param_attr, [proj_size, 4 * hidden], dtype)
    proj_weight = helper.create_parameter(param_attr, [hidden, proj_size], dtype)
    bias_size = [1, 7 * hidden] if use_peepholes else [1, 4 * hidden]
    bias = helper.create_parameter(bias_attr, bias_size, dtype, is_bias=True)
    pshape = cshape = None
    if input.shape is not None:
        pshape = (input.shape[0], input.shape[1], proj_size)
        cshape = (input.shape[0], input.shape[1], hidden)
    proj_out = helper.create_variable_for_type_inference(dtype, shape=pshape)
    cell_out = helper.create_variable_for_type_inference(dtype, shape=cshape)
    helper.append_op(
        "dynamic_lstmp",
        inputs={"Input": [input.name], "XLod": [lod.name],
                "Weight": [weight.name], "ProjWeight": [proj_weight.name],
                "Bias": [bias.name]},
        outputs={"Projection": [proj_out.name], "Cell": [cell_out.name]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "proj_activation": proj_activation},
    )
    _set_lod(proj_out, lod)
    _set_lod(cell_out, lod)
    return proj_out, cell_out


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Multi-layer LSTM over dense [b, T, I] input (the `cudnn_lstm` op: plain
    torch, not cuDNN).  Returns (rnn_out [b, T, D*dirs],
    last_h [L*dirs, b, D], last_c [L*dirs, b, D]).  The flat weight layout
    is documented in the cudnn_lstm lowering (per layer+direction:
    Wx, Wh, bx, bh; gates i,f,c,o)."""
    helper = LayerHelper("lstm", name=name)
    dirs = 2 if is_bidirec else 1
    I = int(input.shape[-1])
    D = hidden_size
    total = 0
    for layer in range(num_layers):
        in_dim = I if layer == 0 else D * dirs
        total += dirs * (4 * D * in_dim + 4 * D * D + 8 * D)
    w = helper.create_parameter(None, [total], input.dtype,
                                default_initializer=default_initializer)
    out = helper.create_variable_for_type_inference(input.dtype)
    last_h = helper.create_variable_for_type_inference(input.dtype)
    last_c = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "cudnn_lstm",
        inputs={"Input": [input.name], "W": [w.name],
                "InitH": [init_h.name], "InitC": [init_c.name]},
        outputs={"Out": [out.name], "LastH": [last_h.name],
                 "LastC": [last_c.name]},
        attrs={"hidden_size": hidden_size, "num_layers": num_layers,
               "is_bidirec": is_bidirec, "dropout_prob": dropout_prob,
               "is_test": is_test},
    )
    return out, last_h, last_c


def sequence_scatter(input, index, updates, name=None):
    """Add ragged per-row updates
    into the dense input at ragged column indices."""
    helper = LayerHelper("sequence_scatter", name=name)
    idx_lod = _lod_of(index)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "sequence_scatter",
        inputs={"X": [input.name], "Ids": [index.name],
                "IdsLod": [idx_lod.name], "Updates": [updates.name]},
        outputs={"Out": [out.name]},
    )
    return out
