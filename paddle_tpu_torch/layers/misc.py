"""The layers of the JAX package's layers/misc.py (counterpart of it): the
in-program beam search and the tensor layers the beam decode uses, the
loss family, the activation and norm stragglers, 3-D conv / pool, the
spatial transforms, the sequence utilities, the sampled and tree
classifiers (nce, hsigmoid, sampled_softmax_with_cross_entropy),
chunk_eval and hash."""
from __future__ import annotations

import numpy as np

from ..core.layer_helper import LayerHelper
from .nn import _out


def beam_search(logits, seqs, scores, finished, step_idx, beam_size, end_id, name=None):
    """One beam step over static [b, k] state; writes seqs, scores and
    finished in place, so they carry through a surrounding `While`."""
    helper = LayerHelper("beam_search", name=name)
    helper.append_op(
        "beam_search",
        inputs={"Logits": [logits.name], "Seqs": [seqs.name], "Scores": [scores.name],
                "Finished": [finished.name], "StepIdx": [step_idx.name]},
        outputs={"SelectedSeqs": [seqs.name], "SelectedScores": [scores.name],
                 "FinishedOut": [finished.name]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id)},
    )
    return seqs, scores, finished


def beam_search_decode(seqs, scores, end_id, length_penalty=0.0, name=None):
    """The best beam of each row: (ids [b, L], score [b])."""
    helper = LayerHelper("beam_search_decode", name=name)
    b, k, L = seqs.shape
    ids = _out(helper, seqs.dtype, shape=(b, L))
    best = _out(helper, "float32", shape=(b,))
    helper.append_op(
        "beam_search_decode",
        inputs={"Seqs": [seqs.name], "Scores": [scores.name]},
        outputs={"SentenceIds": [ids.name], "SentenceScores": [best.name]},
        attrs={"end_id": int(end_id), "length_penalty": float(length_penalty)},
    )
    return ids, best


def key_padding_bias(mask, name=None):
    """[b, Tk] 0/1 key mask -> additive [b, 1, 1, Tk] pre-softmax bias."""
    helper = LayerHelper("key_padding_bias", name=name)
    out = _out(helper, "float32")
    helper.append_op("key_padding_bias", inputs={"X": [mask.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def logical_and(x, y, out=None, name=None):
    helper = LayerHelper("logical_and", name=name)
    if out is None:
        out = _out(helper, "bool", shape=x.shape)
    helper.append_op("logical_and", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def logical_or(x, y, out=None, name=None):
    helper = LayerHelper("logical_or", name=name)
    if out is None:
        out = _out(helper, "bool", shape=x.shape)
    helper.append_op("logical_or", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", name=name)
    if out is None:
        out = _out(helper, "bool", shape=x.shape)
    helper.append_op("logical_not", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    shape = None
    if x.shape is not None:
        shape = tuple(d * t if d is not None and d >= 0 else d for d, t in zip(x.shape, expand_times))
    out = _out(helper, x.dtype, shape=shape)
    helper.append_op("expand", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"expand_times": [int(t) for t in expand_times]})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = _out(helper, input.dtype, shape=input.shape)
    helper.append_op("log_loss", inputs={"Predicted": [input.name], "Labels": [label.name]},
                     outputs={"Loss": [out.name]}, attrs={"epsilon": float(epsilon)})
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = _out(helper, left.dtype, shape=left.shape)
    helper.append_op("rank_loss",
                     inputs={"Label": [label.name], "Left": [left.name], "Right": [right.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = _out(helper, left.dtype, shape=left.shape)
    act = _out(helper, left.dtype, shape=left.shape)
    helper.append_op("margin_rank_loss",
                     inputs={"Label": [label.name], "X1": [left.name], "X2": [right.name]},
                     outputs={"Out": [out.name], "Activated": [act.name]},
                     attrs={"margin": float(margin)})
    return out


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", name=name)
    shape = None
    if input.shape is not None:
        shape = tuple(input.shape[:-1]) + (1,)
    out = _out(helper, input.dtype, shape=shape)
    helper.append_op("bpr_loss", inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Y": [out.name]}, attrs={})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    shape = x.shape if reduction == "none" else ()
    out = _out(helper, x.dtype, shape=shape)
    helper.append_op("kldiv_loss", inputs={"X": [x.name], "Target": [target.name]},
                     outputs={"Loss": [out.name]}, attrs={"reduction": reduction})
    return out


def hinge_loss(input, label, name=None):
    """Op-parity surface for hinge_loss_op (the reference exposes the op but
    no fluid.layers wrapper; kept importable for kernel users)."""
    helper = LayerHelper("hinge_loss", name=name)
    out = _out(helper, input.dtype, shape=input.shape)
    helper.append_op("hinge_loss", inputs={"Logits": [input.name], "Labels": [label.name]},
                     outputs={"Loss": [out.name]}, attrs={})
    return out


def selu(x, scale=None, alpha=None, name=None):
    helper = LayerHelper("selu", name=name)
    out = _out(helper, x.dtype, shape=x.shape)
    attrs = {}
    if scale is not None:
        attrs["scale"] = float(scale)
    if alpha is not None:
        attrs["alpha"] = float(alpha)
    helper.append_op("selu", inputs={"X": [x.name]}, outputs={"Out": [out.name]}, attrs=attrs)
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = _out(helper, input.dtype, shape=input.shape)
    mid = _out(helper, input.dtype, shape=input.shape)
    helper.append_op("lrn", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "MidOut": [mid.name]},
                     attrs={"n": int(n), "k": float(k), "alpha": float(alpha),
                            "beta": float(beta)})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    shape = None
    if x.shape is not None:
        shape = (x.shape[0], x.shape[1] // groups) + tuple(x.shape[2:])
    out = _out(helper, x.dtype, shape=shape)
    helper.append_op("maxout", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"groups": int(groups)})
    return out


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None, act=None):
    helper = LayerHelper("affine_channel", name=name, act=act)
    if scale is None or bias is None:
        raise ValueError(
            "affine_channel needs per-channel scale and bias variables "
            "(the reference kernel has no default-parameter path either)")
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op("affine_channel",
                     inputs={"X": [x.name], "Scale": [scale.name], "Bias": [bias.name]},
                     outputs={"Out": [out.name]}, attrs={"data_layout": data_layout})
    return helper.append_activation(out)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """reference layers/nn.py spectral_norm: creates persistable U/V vectors
    and emits the power-iteration normalization op."""
    helper = LayerHelper("spectral_norm", name=name)
    shape = weight.shape
    perm_rows = shape[dim]
    cols = int(np.prod([d for i, d in enumerate(shape) if i != dim]))
    u = helper.create_parameter(None, [1, perm_rows], "float32")
    v = helper.create_parameter(None, [1, cols], "float32")
    u.stop_gradient = True
    v.stop_gradient = True
    out = _out(helper, weight.dtype, shape=shape)
    helper.append_op("spectral_norm",
                     inputs={"Weight": [weight.name], "U": [u.name], "V": [v.name]},
                     outputs={"Out": [out.name]},
                     attrs={"dim": int(dim), "power_iters": int(power_iters),
                            "eps": float(eps)})
    return out


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = _out(helper, inputs[0].dtype, shape=inputs[0].shape)
    helper.append_op("multiplex", inputs={"X": [v.name for v in inputs],
                                          "Ids": [index.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op("reverse", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"axis": axis if isinstance(axis, (list, tuple)) else [axis]})
    return out


def diag(diagonal):
    helper = LayerHelper("diag")
    shape = None
    if diagonal.shape is not None:
        n = int(np.prod(diagonal.shape))
        shape = (n, n)
    out = _out(helper, diagonal.dtype, shape=shape)
    helper.append_op("diag", inputs={"Diagonal": [diagonal.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    helper = LayerHelper("conv3d", name=name, act=act)
    groups = groups or 1

    def _triple(v):
        return [v] * 3 if isinstance(v, int) else list(v)

    fsize = _triple(filter_size)
    stride = _triple(stride)
    padding = _triple(padding)
    dilation = _triple(dilation)
    cin = input.shape[1]
    w = helper.create_parameter(param_attr, [num_filters, cin // groups] + fsize,
                                input.dtype)
    shape = None
    if input.shape is not None and None not in input.shape[2:]:
        sp = [
            (input.shape[2 + i] + 2 * padding[i]
             - (dilation[i] * (fsize[i] - 1) + 1)) // stride[i] + 1
            for i in range(3)
        ]
        shape = (input.shape[0], num_filters) + tuple(sp)
    out = _out(helper, input.dtype, shape=shape)
    helper.append_op("conv3d", inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    out = helper.append_bias_op(out, bias_attr, [num_filters], dim_start=1)
    return helper.append_activation(out)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None,
           exclusive=True):
    helper = LayerHelper("pool3d", name=name)

    def _triple(v):
        return [v] * 3 if isinstance(v, int) else list(v)

    ksize = _triple(pool_size)
    stride = _triple(pool_stride)
    padding = _triple(pool_padding)
    shape = None
    if input.shape is not None and None not in input.shape[2:] and not global_pooling:
        def odim(i):
            span = input.shape[2 + i] + 2 * padding[i] - ksize[i]
            n = -(-span // stride[i]) if ceil_mode else span // stride[i]
            return n + 1
        shape = (input.shape[0], input.shape[1]) + tuple(odim(i) for i in range(3))
    elif global_pooling:
        shape = (input.shape[0], input.shape[1], 1, 1, 1) if input.shape else None
    out = _out(helper, input.dtype, shape=shape)
    helper.append_op("pool3d", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
                     attrs={"pooling_type": pool_type, "ksize": ksize,
                            "strides": stride, "paddings": padding,
                            "global_pooling": global_pooling, "exclusive": exclusive,
                            "ceil_mode": ceil_mode})
    return out


def affine_grid(theta, out_shape, name=None):
    helper = LayerHelper("affine_grid", name=name)
    inputs = {"Theta": [theta.name]}
    attrs = {}
    if hasattr(out_shape, "name"):  # Variable
        inputs["OutputShape"] = [out_shape.name]
        shape = None
    else:
        attrs["output_shape"] = [int(d) for d in out_shape]
        shape = (theta.shape[0] if theta.shape else None,
                 attrs["output_shape"][2], attrs["output_shape"][3], 2)
    out = _out(helper, theta.dtype, shape=shape)
    helper.append_op("affine_grid", inputs=inputs, outputs={"Output": [out.name]},
                     attrs=attrs)
    return out


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", name=name)
    shape = None
    if x.shape is not None and grid.shape is not None:
        shape = (x.shape[0], x.shape[1], grid.shape[1], grid.shape[2])
    out = _out(helper, x.dtype, shape=shape)
    helper.append_op("grid_sampler", inputs={"X": [x.name], "Grid": [grid.name]},
                     outputs={"Output": [out.name]}, attrs={})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """reference layers/nn.py row_conv: filter shape
    [future_context_size + 1, D] (current step + lookahead)."""
    helper = LayerHelper("row_conv", act=act)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, [future_context_size + 1, d], input.dtype)
    out = _out(helper, input.dtype, shape=input.shape)
    helper.append_op("row_conv", inputs={"X": [input.name], "Filter": [w.name]},
                     outputs={"Out": [out.name]}, attrs={})
    from .nn import _keep_lod

    _keep_lod(input, out)
    return helper.append_activation(out)


def im2sequence(input, filter_size=1, stride=1, padding=0, input_image_size=None,
                out_stride=1, name=None):
    if input_image_size is not None:
        raise NotImplementedError(
            "im2sequence: per-image dynamic sizes (input_image_size/out_stride) "
            "are a dynamic-shape feature; the TPU build supports the static "
            "batch path only")
    helper = LayerHelper("im2sequence", name=name)

    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)

    k = _pair(filter_size)
    s = _pair(stride)
    p = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    if len(p) == 2:
        p = [p[0], p[1], p[0], p[1]]
    shape = None
    if input.shape is not None and None not in input.shape[1:]:
        N, C, H, W = input.shape
        oh = (H + p[0] + p[2] - k[0]) // s[0] + 1
        ow = (W + p[1] + p[3] - k[1]) // s[1] + 1
        shape = (None, C * k[0] * k[1]) if N is None else (N * oh * ow, C * k[0] * k[1])
    out = _out(helper, input.dtype, shape=shape)
    helper.append_op("im2sequence", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"kernels": k, "strides": s, "paddings": list(p)})
    return out


def edit_distance(input, label, normalized=True, ignored_tokens=None):
    """reference layers/nn.py edit_distance over edit_distance_op: ragged
    int sequences (lod_level=1); returns (distances [B,1], seq_num)."""
    helper = LayerHelper("edit_distance")
    in_lod = getattr(input, "_lod_ref", None)
    lb_lod = getattr(label, "_lod_ref", None)
    if in_lod is None or lb_lod is None:
        raise ValueError("edit_distance expects ragged (lod_level=1) inputs")
    out = _out(helper, "float32")
    seq_num = _out(helper, "int32", shape=(1,))
    attrs = {"normalized": bool(normalized)}
    if ignored_tokens:
        attrs["ignored_tokens"] = list(ignored_tokens)
    helper.append_op("edit_distance",
                     inputs={"Hyps": [input.name], "Refs": [label.name],
                             "HypsLen": [in_lod.name], "RefsLen": [lb_lod.name]},
                     outputs={"Out": [out.name], "SequenceNum": [seq_num.name]},
                     attrs=attrs)
    return out, seq_num


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False, custom_neg_classes=None):
    """reference layers/nn.py nce over nce_op; weight (C, D), bias (C,).
    is_sparse is accepted for source compat (grads here are dense — the
    SelectedRows path is exclusive to lookup_table)."""
    helper = LayerHelper("nce", name=name)
    d = input.shape[-1]
    num_neg_samples = int(num_neg_samples or 10)
    w = helper.create_parameter(param_attr, [num_total_classes, d], input.dtype)
    inputs = {"Input": [input.name], "Label": [label.name], "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_total_classes, 1],
                                    input.dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight.name]
    sampler_id = {"uniform": 0, "log_uniform": 1, "custom_dist": 2}[sampler]
    attrs = {"num_total_classes": int(num_total_classes),
             "num_neg_samples": num_neg_samples, "sampler": sampler_id,
             "seed": int(seed)}
    if custom_neg_classes:
        attrs["custom_neg_classes"] = [int(c) for c in custom_neg_classes]
    if custom_dist is not None:
        from .tensor import assign
        import numpy as _np

        probs = assign(_np.asarray(custom_dist, "float32"))
        inputs["CustomDistProbs"] = [probs.name]
    bshape = (input.shape[0], 1) if input.shape else None
    cost = _out(helper, input.dtype, shape=bshape)
    slog = _out(helper, input.dtype)
    slab = _out(helper, "int64")
    helper.append_op("nce", inputs=inputs,
                     outputs={"Cost": [cost.name], "SampleLogits": [slog.name],
                              "SampleLabels": [slab.name]},
                     attrs=attrs)
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """reference layers/nn.py hsigmoid over hierarchical_sigmoid_op (complete
    binary tree by default; custom trees via path_table/path_code vars)."""
    helper = LayerHelper("hierarchical_sigmoid", name=name)
    d = input.shape[-1]
    if is_custom and (path_table is None or path_code is None):
        raise ValueError("hsigmoid(is_custom=True) needs path_table and path_code")
    n_nodes = num_classes - 1
    w = helper.create_parameter(param_attr, [n_nodes, d], input.dtype)
    inputs = {"X": [input.name], "Label": [label.name], "W": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [n_nodes, 1], input.dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    if path_table is not None:
        inputs["PathTable"] = [path_table.name]
        inputs["PathCode"] = [path_code.name]
    bshape = (input.shape[0], 1) if input.shape else None
    out = _out(helper, input.dtype, shape=bshape)
    pre = _out(helper, input.dtype)
    helper.append_op("hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [out.name], "PreOut": [pre.name]},
                     attrs={"num_classes": int(num_classes)})
    return out


def ctc_greedy_decoder(input, blank, name=None):
    """reference layers/nn.py ctc_greedy_decoder.  Ragged [*, C] input ->
    ragged decoded int tokens (padded carrier + lengths companion)."""
    from .sequence import _lod_of, _set_lod

    helper = LayerHelper("ctc_greedy_decoder", name=name)
    lod = _lod_of(input)
    out = helper.create_variable_for_type_inference("int32")
    out_lod = helper.create_variable_for_type_inference("int32")
    helper.append_op("ctc_greedy_decoder",
                     inputs={"Input": [input.name], "XLod": [lod.name]},
                     outputs={"Out": [out.name], "OutLod": [out_lod.name]},
                     attrs={"blank": blank})
    _set_lod(out, out_lod)
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_info=None):
    """reference layers/nn.py chunk_eval.  Ragged int tag sequences ->
    (precision, recall, f1, num_infer, num_label, num_correct); padded
    dense inputs may pass their lengths vector as seq_info instead."""
    from .sequence import _lod_of

    helper = LayerHelper("chunk_eval")
    lod = seq_info if seq_info is not None else _lod_of(input)
    outs = [helper.create_variable_for_type_inference(dt)
            for dt in ("float32", "float32", "float32", "int32", "int32", "int32")]
    helper.append_op(
        "chunk_eval",
        inputs={"Inference": [input.name], "Label": [label.name],
                "XLod": [lod.name]},
        outputs={"Precision": [outs[0].name], "Recall": [outs[1].name],
                 "F1-Score": [outs[2].name], "NumInferChunks": [outs[3].name],
                 "NumLabelChunks": [outs[4].name],
                 "NumCorrectChunks": [outs[5].name]},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": list(excluded_chunk_types or [])},
    )
    return tuple(outs)


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """reference layers/nn.py sampled_softmax_with_cross_entropy: sample
    classes (log-uniform), correct the sampled logits, regular softmax CE
    over the sampled set.  Returns [N, 1] loss."""
    if use_customized_samples:
        raise NotImplementedError(
            "sampled_softmax_with_cross_entropy: customized_samples")
    if num_true != 1:
        raise NotImplementedError(
            "sampled_softmax_with_cross_entropy: num_true > 1 (the final "
            "hard-label CE indexes one true column per row)")
    from . import nn as _nn

    helper = LayerHelper("sample_logits")
    sampled = helper.create_variable_for_type_inference(logits.dtype)
    sampled_labels = helper.create_variable_for_type_inference("int32")
    samples = helper.create_variable_for_type_inference("int32")
    probs = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "sample_logits",
        inputs={"Logits": [logits.name], "Labels": [label.name]},
        outputs={"SampledLogits": [sampled.name],
                 "SampledLabels": [sampled_labels.name],
                 "Samples": [samples.name], "Probabilities": [probs.name]},
        attrs={"num_samples": num_samples,
               "remove_accidental_hits": remove_accidental_hits,
               "uniq": True},
    )
    return _nn.softmax_with_cross_entropy(sampled, sampled_labels)


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1, max_depth=2,
              act="tanh", param_attr=None, bias_attr=None, name=None):
    """TBCNN tree convolution (reference layers/nn.py tree_conv over
    tree_conv_op.h).  nodes_vector [B, N, F], edge_set [B, E, 2]
    (1-indexed, zero-padded); returns [B, N, output_size, num_filters]."""
    helper = LayerHelper("tree_conv", name=name, act=act)
    F = int(nodes_vector.shape[-1])
    w = helper.create_parameter(param_attr, [F, 3, output_size, num_filters],
                                nodes_vector.dtype)
    out = helper.create_variable_for_type_inference(nodes_vector.dtype)
    helper.append_op(
        "tree_conv",
        inputs={"NodesVector": [nodes_vector.name], "EdgeSet": [edge_set.name],
                "Filter": [w.name]},
        outputs={"Out": [out.name]},
        attrs={"max_depth": max_depth},
    )
    if bias_attr is not False:
        out = helper.append_bias_op(out, bias_attr, [num_filters], dim_start=3)
    return helper.append_activation(out)


def similarity_focus(input, axis, indexes, name=None):
    """reference layers/nn.py similarity_focus."""
    helper = LayerHelper("similarity_focus", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("similarity_focus", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axis": axis, "indexes": list(indexes)})
    return out


def hash(input, hash_size, num_hash=1, name=None):
    """reference layers/nn.py hash over hash_op.h (XXH64 % hash_size)."""
    helper = LayerHelper("hash", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("hash", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"mod_by": hash_size, "num_hash": num_hash})
    return out
