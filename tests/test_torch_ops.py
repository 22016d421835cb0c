"""One-op differential harness (a twin of tests/op_test.py): the same
single-op program, built in both packages from the same numpy inputs, runs
through the JAX Executor and the port's Executor on the CPU and must give
the same fetches.  Random ops are checked by their moments."""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core.dtypes import canonical_dtype as j_canon
from paddle_tpu_torch.models import detection_cases as _cases
from paddle_tpu_torch.models import tail_cases as _tail
from paddle_tpu_torch.ops import cuda_kernels as ck


def _out_names(out_slots):
    """[(slot, var name)]: "Out" is one var, "Out:3" three vars of one slot."""
    names = []
    for spec in out_slots:
        slot, _, n = spec.partition(":")
        names += [(slot, f"out_{slot}{i}") for i in range(int(n))] if n else [(slot, f"out_{slot}")]
    return names


def _build(fluid, op_type, inputs, attrs, out_slots):
    """The one-op program: {slot: array or [arrays]} fed as data vars; the
    output vars take attrs' `out_dtype`, or per slot `out_dtypes` (not an
    attr of the op), and no shape (the op's inference rule declares it)."""
    attrs = dict(attrs)
    out_dtypes = attrs.pop("out_dtypes", {})
    prog = fluid.Program()
    feed = {}
    with fluid.program_guard(prog, fluid.Program()):
        block = prog.global_block()
        in_io = {}
        for slot, val in inputs.items():
            # a list feeds several vars into one slot (sum's X)
            vals = val if isinstance(val, list) else [val]
            in_io[slot] = []
            for k, v in enumerate(vals):
                arr = np.asarray(v)
                name = f"in_{slot}" if len(vals) == 1 else f"in_{slot}{k}"
                var = block.create_var(name, shape=arr.shape, dtype=j_canon(arr.dtype), is_data=True)
                var.stop_gradient = False
                feed[name] = arr
                in_io[slot].append(name)
        out_io = {}
        for slot, name in _out_names(out_slots):
            block.create_var(name, dtype=out_dtypes.get(slot, attrs.get("out_dtype", "float32")))
            out_io.setdefault(slot, []).append(name)
        block.append_op(op_type, inputs=in_io, outputs=out_io, attrs=dict(attrs))
    return prog, feed


def _run(fluid, op_type, inputs, attrs, out_slots, declared=None):
    """Build -> one op -> fetch every output var, on the CPU.  `declared`,
    a dict, receives each output var's declared (shape, dtype)."""
    prog, feed = _build(fluid, op_type, inputs, attrs, out_slots)
    names = [n for _, n in _out_names(out_slots)]
    if declared is not None:
        block = prog.global_block()
        declared.update({n: (block.var(n).shape, str(block.var(n).dtype)) for n in names})
    exe = fluid.Executor(fluid.CPUPlace())
    return exe.run(prog, feed=feed, fetch_list=names, scope=fluid.Scope())


rng = np.random.RandomState(0)
F32 = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
BF16 = lambda *s: rng.randn(*s).astype(ml_dtypes.bfloat16)  # noqa: E731
POS = lambda *s: (rng.rand(*s) + 0.5).astype("float32")  # noqa: E731
BN_OUT = ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]


def _bn(x, c=3):
    return {"X": x, "Scale": POS(c), "Bias": F32(c), "Mean": F32(c) * 0.1, "Variance": POS(c)}

CASES = [
    # (id, op_type, inputs, attrs, out_slots, atol)
    ("mul", "mul", {"X": F32(2, 3, 4), "Y": F32(4, 5)}, {"x_num_col_dims": 2, "y_num_col_dims": 1}, ["Out"], 1e-5),
    ("mul_flatten", "mul", {"X": F32(2, 3, 4), "Y": F32(12, 5)}, {"x_num_col_dims": 1}, ["Out"], 1e-5),
    ("add_same", "elementwise_add", {"X": F32(2, 3, 4), "Y": F32(2, 3, 4)}, {"axis": -1}, ["Out"], 1e-6),
    ("add_bias_axis", "elementwise_add", {"X": F32(2, 3, 4), "Y": F32(4)}, {"axis": 2}, ["Out"], 1e-6),
    ("add_mid_axis", "elementwise_add", {"X": F32(2, 3, 4), "Y": F32(3)}, {"axis": 1}, ["Out"], 1e-6),
    ("add_fuse_gelu", "elementwise_add", {"X": F32(2, 3, 8), "Y": F32(8)}, {"axis": 2, "fuse_act": "gelu"}, ["Out"], 2e-6),
    ("add_fuse_relu", "elementwise_add", {"X": F32(6, 8), "Y": F32(8)}, {"axis": -1, "fuse_act": "relu"}, ["Out"], 1e-6),
    ("add_fuse_gelu_full", "elementwise_add", {"X": F32(6, 8), "Y": F32(6, 8)}, {"fuse_act": "gelu"}, ["Out"], 2e-6),
    ("gelu", "gelu", {"X": F32(4, 5)}, {}, ["Out"], 2e-6),
    ("relu", "relu", {"X": F32(4, 5)}, {}, ["Out"], 0.0),
    ("matmul_t", "matmul", {"X": F32(2, 3, 4), "Y": F32(2, 5, 4)}, {"transpose_Y": True, "alpha": 0.5}, ["Out"], 1e-5),
    ("softmax", "softmax", {"X": F32(3, 7)}, {"axis": -1}, ["Out"], 1e-6),
    ("reshape2", "reshape2", {"X": F32(2, 3, 4)}, {"shape": [0, -1, 2]}, ["Out"], 0.0),
    ("transpose2", "transpose2", {"X": F32(2, 3, 4, 5)}, {"axis": [0, 2, 1, 3]}, ["Out"], 0.0),
    ("cast_int64", "cast", {"X": F32(3, 4) * 10}, {"out_dtype": "int64"}, ["Out"], 0.0),
    ("cast_bf16", "cast", {"X": F32(3, 4)}, {"out_dtype": "bfloat16"}, ["Out"], 0.0),
    ("lookup", "lookup_table", {"W": F32(10, 4), "Ids": rng.randint(0, 10, (3, 5, 1))}, {"padding_idx": None}, ["Out"], 0.0),
    ("lookup_pad", "lookup_table", {"W": F32(10, 4), "Ids": rng.randint(0, 10, (3, 5))}, {"padding_idx": 3}, ["Out"], 0.0),
    ("ln_fused", "layer_norm", {"X": F32(2, 3, 8), "Scale": F32(8), "Bias": F32(8)}, {"begin_norm_axis": 2}, ["Y"], 2e-6),
    ("ln_residual", "layer_norm", {"X": F32(2, 3, 8), "Residual": F32(2, 3, 8), "Scale": F32(8), "Bias": F32(8)},
     {"begin_norm_axis": 2, "epsilon": 1e-3}, ["Y"], 2e-6),
    ("ln_stats", "layer_norm", {"X": F32(2, 3, 8), "Scale": F32(8), "Bias": F32(8)}, {"begin_norm_axis": 2},
     ["Y", "Mean", "Variance"], 2e-6),
    ("ln_multi_axis", "layer_norm", {"X": F32(2, 3, 8), "Scale": F32(24), "Bias": F32(24)}, {"begin_norm_axis": 1}, ["Y"], 2e-6),
    ("dropout_upscale", "dropout", {"X": F32(3, 4)},
     {"is_test": True, "dropout_prob": 0.3, "dropout_implementation": "upscale_in_train"}, ["Out"], 0.0),
    ("dropout_downgrade", "dropout", {"X": F32(3, 4)}, {"is_test": True, "dropout_prob": 0.3}, ["Out", "Mask"], 1e-7),
    ("attn", "fused_attention", {"Q": F32(2, 2, 5, 8), "K": F32(2, 2, 5, 8), "V": F32(2, 2, 5, 8)}, {}, ["Out"], 1e-5),
    ("attn_bias_causal", "fused_attention",
     {"Q": F32(2, 2, 5, 8), "K": F32(2, 2, 7, 8), "V": F32(2, 2, 7, 8), "Bias": F32(2, 1, 5, 7)},
     {"causal": True, "scale": 0.3}, ["Out"], 1e-5),
    ("fill_constant", "fill_constant", {}, {"shape": [2, 3], "dtype": "float32", "value": 2.5}, ["Out"], 0.0),
    ("mean", "mean", {"X": F32(3, 4, 5)}, {}, ["Out"], 1e-6),
    ("xent_hard", "softmax_with_cross_entropy",
     {"Logits": F32(6, 9) * 3, "Label": np.array([[0], [8], [-100], [3], [-100], [5]])},
     {"ignore_index": -100}, ["Loss"], 1e-5),
    ("xent_rank1_label", "softmax_with_cross_entropy",
     {"Logits": F32(4, 7), "Label": np.array([1, 6, 0, 2])}, {}, ["Loss"], 1e-5),
    ("xent_softmax_read", "softmax_with_cross_entropy",
     {"Logits": F32(5, 7), "Label": np.array([[1], [6], [0], [2], [3]])}, {}, ["Loss", "Softmax"],
     1e-5),
    ("xent_soft", "softmax_with_cross_entropy",
     {"Logits": F32(5, 7), "Label": np.abs(F32(5, 7)) / 7}, {"soft_label": True}, ["Loss"], 1e-5),
    ("adam", "adam",
     {"Param": F32(4, 6), "Grad": F32(4, 6) * 0.1, "Moment1": F32(4, 6) * 0.01,
      "Moment2": np.abs(F32(4, 6)) * 1e-3, "Beta1Pow": np.array([0.9 ** 3], np.float32),
      "Beta2Pow": np.array([0.999 ** 3], np.float32), "LearningRate": np.array([0.01], np.float32)},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
     ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"], 1e-6),
    # conv2d: NCHW / OIHW; symmetric and [top, bottom, left, right] padding
    ("conv_sym", "conv2d", {"Input": F32(2, 4, 9, 9), "Filter": F32(6, 4, 3, 3)},
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1], "groups": 1}, ["Output"], 1e-4),
    ("conv_pad4_s2d", "conv2d", {"Input": F32(2, 12, 8, 8), "Filter": F32(5, 12, 4, 4)},
     {"strides": [1, 1], "paddings": [2, 1, 2, 1], "dilations": [1, 1], "groups": 1}, ["Output"], 1e-4),
    ("conv_pad4_stride", "conv2d", {"Input": F32(2, 3, 11, 10), "Filter": F32(4, 3, 3, 3)},
     {"strides": [2, 2], "paddings": [0, 2, 1, 0], "dilations": [1, 1], "groups": 1}, ["Output"], 1e-4),
    ("conv_dilation", "conv2d", {"Input": F32(2, 3, 10, 10), "Filter": F32(4, 3, 3, 3)},
     {"strides": [1, 1], "paddings": [2, 2], "dilations": [2, 2], "groups": 1}, ["Output"], 1e-4),
    ("conv_groups", "conv2d", {"Input": F32(2, 6, 7, 7), "Filter": F32(9, 2, 3, 3)},
     {"strides": [2, 1], "paddings": [1, 0], "dilations": [1, 1], "groups": 3}, ["Output"], 1e-4),
    # pool2d: max and both averages with padding and ceil_mode, global
    ("pool_max_pad", "pool2d", {"X": F32(2, 3, 9, 9)},
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, ["Out"], 0.0),
    ("pool_max_ceil", "pool2d", {"X": F32(2, 3, 10, 10)},
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
      "ceil_mode": True}, ["Out"], 0.0),
    ("pool_avg_excl_ceil", "pool2d", {"X": F32(2, 3, 10, 10)},
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
      "ceil_mode": True, "exclusive": True}, ["Out"], 1e-6),
    ("pool_avg_incl_ceil", "pool2d", {"X": F32(2, 3, 10, 10)},
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
      "ceil_mode": True, "exclusive": False}, ["Out"], 1e-6),
    ("pool_avg_excl_ceil_nopad", "pool2d", {"X": F32(2, 3, 7, 7)},
     {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
      "ceil_mode": True}, ["Out"], 1e-6),
    ("pool_avg_global", "pool2d", {"X": F32(2, 5, 7, 7)},
     {"pooling_type": "avg", "global_pooling": True, "ksize": [1, 1]}, ["Out"], 1e-6),
    # batch_norm: train and test, float32 and bf16, fuse_relu, SavedMean fetched
    ("bn_train", "batch_norm", _bn(F32(4, 3, 5, 5) * 2 + 1),
     {"is_test": False, "momentum": 0.9, "epsilon": 1e-5}, BN_OUT, 1e-5),
    ("bn_train_relu", "batch_norm", _bn(F32(4, 3, 5, 5) * 2 + 1),
     {"is_test": False, "momentum": 0.8, "epsilon": 1e-3, "fuse_relu": True}, BN_OUT, 1e-5),
    ("bn_test", "batch_norm", _bn(F32(4, 3, 5, 5)),
     {"is_test": True, "fuse_relu": True}, ["Y", "MeanOut", "SavedMean"], 1e-5),
    ("bn_global_stats", "batch_norm", _bn(F32(4, 3, 6)),
     {"is_test": False, "use_global_stats": True}, ["Y", "VarianceOut"], 1e-5),
    ("bn_train_2d", "batch_norm", _bn(F32(6, 3) + 2),
     {"is_test": False, "fuse_relu": True}, BN_OUT, 1e-5),
    # bf16: float32 statistics of bf16 x.  The port rounds x^2 to bf16 (the
    # dtype of jnp.square(x)); XLA on the CPU keeps it unrounded: 1e-4 on
    # variances near 1.  Y differs by bf16 roundings (the JAX package's CPU
    # composite rounds mul/add to bf16, the port's epilogue does not)
    ("bn_train_bf16", "batch_norm", _bn(BF16(4, 3, 5, 5)),
     {"is_test": False, "fuse_relu": True}, ["MeanOut", "VarianceOut", "SavedMean"], 1e-4),
    ("bn_train_bf16_y", "batch_norm", _bn(BF16(4, 3, 5, 5)),
     {"is_test": False, "fuse_relu": True}, ["Y"], 5e-2),
    ("bn_test_bf16_y", "batch_norm", _bn(BF16(4, 3, 5, 5)), {"is_test": True}, ["Y"], 5e-2),
    ("top_k", "top_k", {"X": F32(4, 7)}, {"k": 3, "out_dtypes": {"Indices": "int64"}},
     ["Out", "Indices"], 0.0),
    ("accuracy", "accuracy",
     {"Out": F32(5, 2), "Indices": np.array([[1, 2], [0, 3], [4, 4], [2, 1], [3, 0]]),
      "Label": np.array([[2], [1], [4], [0], [0]])}, {}, ["Accuracy", "Correct", "Total"], 0.0),
    ("momentum", "momentum",
     {"Param": F32(4, 6), "Grad": F32(4, 6), "Velocity": F32(4, 6),
      "LearningRate": np.array([0.1], np.float32)}, {"mu": 0.9}, ["ParamOut", "VelocityOut"], 1e-6),
    ("momentum_nesterov", "momentum",
     {"Param": F32(4, 6), "Grad": F32(4, 6), "Velocity": F32(4, 6),
      "LearningRate": np.array([0.1], np.float32)}, {"mu": 0.9, "use_nesterov": True},
     ["ParamOut", "VelocityOut"], 1e-6),
    # the DeepFM slice's ops
    ("reduce_sum_dims", "reduce_sum", {"X": F32(3, 4, 5)},
     {"dim": [1, 2], "keep_dim": False, "reduce_all": False}, ["Out"], 1e-5),
    ("reduce_sum_keep_neg", "reduce_sum", {"X": F32(3, 4, 5)},
     {"dim": [-1], "keep_dim": True, "reduce_all": False}, ["Out"], 1e-5),
    ("reduce_sum_all", "reduce_sum", {"X": F32(3, 4, 5)},
     {"dim": [0], "keep_dim": False, "reduce_all": True}, ["Out"], 1e-5),
    ("reduce_sum_int32", "reduce_sum", {"X": rng.randint(-9, 9, (3, 4)).astype("int32")},
     {"dim": [0], "out_dtype": "int32"}, ["Out"], 0.0),
    ("reduce_sum_bf16", "reduce_sum", {"X": BF16(4, 6)}, {"dim": [1]}, ["Out"], 5e-2),
    ("square", "square", {"X": F32(4, 5)}, {}, ["Out"], 1e-6),
    ("sigmoid", "sigmoid", {"X": F32(4, 5) * 4}, {}, ["Out"], 1e-6),
    ("sub_axis", "elementwise_sub", {"X": F32(2, 3, 4), "Y": F32(3)}, {"axis": 1}, ["Out"], 1e-6),
    ("sub_same", "elementwise_sub", {"X": F32(2, 3), "Y": F32(2, 3)}, {"axis": -1}, ["Out"], 1e-6),
    ("mul_axis", "elementwise_mul", {"X": F32(2, 3, 4), "Y": F32(4)}, {"axis": 2}, ["Out"], 1e-6),
    ("mul_bf16_f32", "elementwise_mul", {"X": BF16(3, 4), "Y": F32(3, 4)},
     {"axis": -1, "out_dtype": "bfloat16"}, ["Out"], 0.0),
    ("scale", "scale", {"X": F32(3, 4)}, {"scale": 0.5, "bias": 0.25}, ["Out"], 1e-6),
    ("scale_bias_first", "scale", {"X": F32(3, 4)},
     {"scale": -2.0, "bias": 1.5, "bias_after_scale": False}, ["Out"], 1e-6),
    ("sigmoid_ce", "sigmoid_cross_entropy_with_logits",
     {"X": F32(6, 1) * 3, "Label": np.array([[1], [0], [-100], [1], [0], [-100]], np.float32)},
     {"ignore_index": -100}, ["Out"], 1e-6),
    ("sigmoid_ce_normalize", "sigmoid_cross_entropy_with_logits",
     {"X": F32(4, 3) * 3, "Label": (rng.rand(4, 3) < 0.5).astype(np.float32)},
     {"normalize": True}, ["Out"], 1e-6),
    # the NMT slice's ops: training
    ("pow", "pow", {"X": POS(3, 4)}, {"factor": -0.5}, ["Out"], 1e-6),
    ("pow_zero_to_inf", "pow", {"X": np.array([0.0, 1.0, 4.0], np.float32)}, {"factor": -0.5},
     ["Out"], 0.0),
    ("div_same", "elementwise_div", {"X": F32(2, 3), "Y": POS(2, 3)}, {"axis": -1}, ["Out"], 1e-6),
    ("div_axis", "elementwise_div", {"X": F32(2, 3, 4), "Y": POS(3)}, {"axis": 1}, ["Out"], 1e-6),
    ("min_same", "elementwise_min", {"X": F32(2, 3), "Y": F32(2, 3)}, {"axis": -1}, ["Out"], 0.0),
    ("min_of_inf", "elementwise_min", {"X": np.array([np.inf, 1.0, -2.0], np.float32),
                                       "Y": np.array([0.0, 2.0, np.inf], np.float32)},
     {"axis": -1}, ["Out"], 0.0),
    ("one_hot", "one_hot", {"X": np.array([[[3], [0]], [[5], [1]]])}, {"depth": 6}, ["Out"], 0.0),
    ("one_hot_out_of_range", "one_hot", {"X": np.array([2, -1, 6, 0])}, {"depth": 6}, ["Out"], 0.0),
    ("label_smooth", "label_smooth", {"X": np.eye(5, dtype=np.float32)[[0, 3, 4]]},
     {"epsilon": 0.1}, ["Out"], 1e-7),
    ("label_smooth_prior", "label_smooth",
     {"X": np.eye(4, dtype=np.float32)[[1, 2]], "PriorDist": POS(1, 4) / 4}, {"epsilon": 0.2},
     ["Out"], 1e-7),
    ("increment_float", "increment", {"X": np.array([-1.0], np.float32)}, {"step": 1.0},
     ["Out"], 0.0),
    ("increment_int", "increment", {"X": np.array([3], np.int32)},
     {"step": 2.0, "out_dtype": "int32"}, ["Out"], 0.0),
    ("seq_pool_sum", "sequence_pool", {"X": F32(3, 5, 2), "XLod": np.array([2, 5, 1], np.int32)},
     {"pooltype": "SUM"}, ["Out"], 1e-6),
    ("seq_pool_average", "sequence_pool",
     {"X": F32(3, 5, 2), "XLod": np.array([2, 5, 0], np.int32)}, {"pooltype": "AVERAGE"},
     ["Out"], 1e-6),
    ("seq_pool_sqrt", "sequence_pool", {"X": F32(3, 4), "XLod": np.array([1, 4, 3], np.int32)},
     {"pooltype": "SQRT"}, ["Out"], 1e-6),
    ("seq_pool_max", "sequence_pool", {"X": F32(3, 5, 2), "XLod": np.array([2, 5, 1], np.int32)},
     {"pooltype": "MAX", "out_dtypes": {"MaxIndex": "int32"}}, ["Out", "MaxIndex"], 0.0),
    ("seq_pool_last", "sequence_pool", {"X": F32(3, 5, 2), "XLod": np.array([2, 5, 1], np.int32)},
     {"pooltype": "LAST"}, ["Out"], 0.0),
    ("seq_pool_first", "sequence_pool", {"X": F32(3, 5), "XLod": np.array([2, 5, 1], np.int32)},
     {"pooltype": "FIRST"}, ["Out"], 0.0),
    ("attention_bias", "attention_bias",
     {"Q": F32(2, 4, 8), "K": F32(2, 6, 8), "KLod": np.array([3, 6], np.int32)}, {},
     ["Out"], 0.0),
    ("attention_bias_causal", "attention_bias",
     {"Q": F32(2, 5, 8), "K": F32(2, 5, 8), "KLod": np.array([2, 5], np.int32)},
     {"causal": True}, ["Out"], 0.0),
    ("position_encoding", "position_encoding", {"X": F32(2, 5, 6)}, {}, ["Out"], 1e-6),
    ("position_encoding_odd_d", "position_encoding", {"X": F32(2, 3, 7)}, {}, ["Out"], 1e-6),
    # the NMT slice's ops: decoding
    ("assign_value_int64", "assign_value", {},
     {"values": np.arange(6).reshape(2, 3), "dtype": "int64", "shape": [2, 3],
      "out_dtype": "int64"}, ["Out"], 0.0),
    ("assign_value_float", "assign_value", {},
     {"values": F32(2, 2), "dtype": "float32", "shape": [2, 2]}, ["Out"], 0.0),
    ("assign_value_bool", "assign_value", {},
     {"values": np.array([[True, False]]), "dtype": "bool", "shape": [1, 2], "out_dtype": "bool"},
     ["Out"], 0.0),
    ("expand", "expand", {"X": F32(2, 1, 3)}, {"expand_times": [1, 4, 2]}, ["Out"], 0.0),
    ("assign", "assign", {"X": F32(3, 4)}, {}, ["Out"], 0.0),
    ("less_than_scalar", "less_than",
     {"X": np.array([3], np.int32), "Y": np.array([4], np.int32)}, {"out_dtype": "bool"},
     ["Out"], 0.0),
    ("less_than", "less_than", {"X": F32(3, 4), "Y": F32(3, 4)}, {"out_dtype": "bool"},
     ["Out"], 0.0),
    ("logical_and", "logical_and",
     {"X": np.array([True, True, False, False]), "Y": np.array([True, False, True, False])},
     {"out_dtype": "bool"}, ["Out"], 0.0),
    ("sequence_mask", "sequence_mask", {"X": np.array([3, 0, 6], np.int32)},
     {"maxlen": 6, "out_dtype": "float32"}, ["Y"], 0.0),
    ("sequence_mask_int64", "sequence_mask", {"X": np.array([[2], [5]], np.int32)},
     {"maxlen": 4, "out_dtype": "int64"}, ["Y"], 0.0),
    ("key_padding_bias", "key_padding_bias", {"X": (rng.rand(3, 5) < 0.6).astype(np.float32)},
     {}, ["Out"], 0.0),
    ("beam_search", "beam_search",
     {"Logits": F32(6, 6, 10), "Seqs": rng.randint(3, 10, (2, 3, 6)).astype(np.int32),
      "Scores": F32(2, 3), "Finished": np.array([[False, False, False], [False, False, True]]),
      "StepIdx": np.array([2], np.int32)},
     {"beam_size": 3, "end_id": 2,
      "out_dtypes": {"SelectedSeqs": "int32", "FinishedOut": "bool"}},
     ["SelectedSeqs", "SelectedScores", "FinishedOut"], 1e-6),
    ("beam_search_first_step", "beam_search",
     {"Logits": F32(4, 5, 7), "Seqs": np.full((2, 2, 5), 2, np.int32),
      "Scores": np.array([[0.0, -1e9], [0.0, -1e9]], np.float32),
      "Finished": np.zeros((2, 2), bool), "StepIdx": np.array([1], np.int32)},
     {"beam_size": 2, "end_id": 2,
      "out_dtypes": {"SelectedSeqs": "int32", "FinishedOut": "bool"}},
     ["SelectedSeqs", "SelectedScores", "FinishedOut"], 1e-6),
    ("beam_search_decode", "beam_search_decode",
     {"Seqs": rng.randint(0, 6, (3, 4, 5)).astype(np.int32), "Scores": F32(3, 4)},
     {"end_id": 2, "out_dtypes": {"SentenceIds": "int32"}},
     ["SentenceIds", "SentenceScores"], 0.0),
    # the clips', regularizers' and losses' ops
    ("sum", "sum", {"X": [F32(3, 4), F32(3, 4), F32(3, 4)]}, {}, ["Out"], 1e-6),
    ("sum_broadcast_scalars", "sum", {"X": [np.float32(0.5), F32(1), F32(1)]}, {}, ["Out"], 1e-6),
    ("sqrt", "sqrt", {"X": POS(3, 4)}, {}, ["Out"], 1e-6),
    ("sign", "sign", {"X": np.concatenate([F32(3, 4), np.zeros((1, 4), np.float32)])}, {},
     ["Out"], 0.0),
    ("elementwise_max", "elementwise_max", {"X": F32(2, 3, 4), "Y": F32(4)}, {"axis": -1},
     ["Out"], 0.0),
    ("elementwise_max_scalar", "elementwise_max", {"X": F32(1), "Y": F32(1)}, {}, ["Out"], 0.0),
    ("clip", "clip", {"X": F32(3, 4)}, {"min": -0.5, "max": 0.7}, ["Out"], 0.0),
    ("clip_by_norm", "clip_by_norm", {"X": F32(3, 4)}, {"max_norm": 1.0}, ["Out"], 1e-6),
    ("clip_by_norm_below", "clip_by_norm", {"X": F32(3, 4)}, {"max_norm": 100.0}, ["Out"], 0.0),
    ("square_error_cost", "square_error_cost", {"X": F32(4, 1), "Y": F32(4, 1)}, {}, ["Out"], 1e-6),
    ("cross_entropy", "cross_entropy",
     {"X": POS(4, 5) / 5.0, "Label": rng.randint(0, 5, (4, 1)).astype(np.int64)}, {}, ["Y"], 1e-6),
    ("cross_entropy_ignore", "cross_entropy",
     {"X": POS(4, 5) / 5.0, "Label": np.array([1, -100, 3, 0], np.int64)},
     {"ignore_index": -100}, ["Y"], 1e-6),
    ("cross_entropy_soft", "cross_entropy", {"X": POS(4, 5) / 5.0, "Label": POS(4, 5) / 5.0},
     {"soft_label": True}, ["Y"], 1e-6),
    ("beam_search_decode_penalty", "beam_search_decode",
     {"Seqs": rng.randint(0, 6, (3, 4, 5)).astype(np.int32), "Scores": -POS(3, 4)},
     {"end_id": 2, "length_penalty": 0.6, "out_dtypes": {"SentenceIds": "int32"}},
     ["SentenceIds", "SentenceScores"], 1e-6),
]


# --- the rest of ops/math_ops.py and ops/tensor_ops.py, and the sequence
# conv.  (input maker, tolerance) per unary op; the domains keep log, rsqrt,
# asin, ... finite
UNIT = lambda *s: (rng.rand(*s) * 1.8 - 0.9).astype("float32")  # noqa: E731
INTS = lambda *s: rng.randint(-3, 4, s).astype("int32")  # noqa: E731
UNARY_NEW = {
    "relu6": (lambda: F32(4, 5) * 4, 0.0), "logsigmoid": (lambda: F32(4, 5) * 3, 1e-6),
    "tanh": (lambda: F32(4, 5), 1e-6), "exp": (lambda: F32(4, 5), 1e-5),
    "log": (lambda: POS(4, 5), 1e-6), "rsqrt": (lambda: POS(4, 5), 1e-6),
    "abs": (lambda: F32(4, 5), 0.0), "reciprocal": (lambda: POS(4, 5), 1e-6),
    "floor": (lambda: F32(4, 5) * 3, 0.0), "ceil": (lambda: F32(4, 5) * 3, 0.0),
    "round": (lambda: np.concatenate([F32(4, 5) * 3, [[0.5, 1.5, -2.5, 2.5, -0.5]]]).astype("f4"),
              0.0),
    "sin": (lambda: F32(4, 5), 1e-6), "cos": (lambda: F32(4, 5), 1e-6),
    "softplus": (lambda: F32(4, 5) * 5, 1e-6), "softsign": (lambda: F32(4, 5), 1e-6),
    "tanh_shrink": (lambda: F32(4, 5), 1e-6), "erf": (lambda: F32(4, 5), 1e-6),
    "tan": (lambda: UNIT(4, 5), 1e-6), "asin": (lambda: UNIT(4, 5), 1e-6),
    "acos": (lambda: UNIT(4, 5), 1e-6), "atan": (lambda: F32(4, 5), 1e-6),
    "sinh": (lambda: F32(4, 5), 1e-5), "cosh": (lambda: F32(4, 5), 1e-5),
    "log2": (lambda: POS(4, 5), 1e-6), "log10": (lambda: POS(4, 5), 1e-6),
    "log1p": (lambda: POS(4, 5), 1e-6), "expm1": (lambda: F32(4, 5), 1e-5),
}
ATTR_UNARY_NEW = [
    ("hard_shrink", {"threshold": 0.6}), ("stanh", {"scale_a": 0.5, "scale_b": 1.5}),
    ("leaky_relu", {"alpha": 0.1}), ("elu", {"alpha": 0.7}),
    ("hard_sigmoid", {"slope": 0.3, "offset": 0.4}), ("swish", {"beta": 1.3}),
    ("softshrink", {"lambda": 0.4}),
]
REDUCE_NEW = ["reduce_mean", "reduce_max", "reduce_min", "reduce_prod"]
CMP_NEW = ["equal", "not_equal", "less_equal", "greater_than", "greater_equal"]
BOOLS = lambda *s: rng.rand(*s) < 0.5  # noqa: E731
NAN_ROW = np.array([[1.0, np.nan, 2.0]], np.float32)
SEQ = F32(3, 6, 4)
SEQ_LOD = np.array([6, 2, 4], np.int32)

NEW_CASES = (
    [(f"{n}", n, {"X": make()}, {}, ["Out"], tol) for n, (make, tol) in UNARY_NEW.items()]
    + [(f"{n}_bf16", n, {"X": BF16(4, 6)}, {"out_dtype": "bfloat16"}, ["Out"], 2e-2)
       for n in ("tanh", "exp", "sin", "softsign", "erf")]
    + [(n, n, {"X": F32(4, 5) * 2}, a, ["Out"], 1e-6) for n, a in ATTR_UNARY_NEW]
    + [(f"{n}_default", n, {"X": F32(4, 5) * 2}, {}, ["Out"], 1e-6) for n, _ in ATTR_UNARY_NEW]
    + [(f"{n}_dims", n, {"X": POS(3, 4, 5)}, {"dim": [0, 2], "keep_dim": False}, ["Out"], 1e-5)
       for n in REDUCE_NEW]
    + [(f"{n}_keep_neg", n, {"X": POS(3, 4, 5)}, {"dim": [-1], "keep_dim": True}, ["Out"], 1e-5)
       for n in REDUCE_NEW]
    + [(f"{n}_all", n, {"X": POS(3, 4)}, {"dim": [0], "reduce_all": True}, ["Out"], 1e-5)
       for n in REDUCE_NEW]
    # an integer mean is float32, where the inference rule declares X's int32
    + [(f"{n}_int32", n, {"X": INTS(3, 4)}, {"dim": [1], "out_dtype": "int32"}, ["Out"], 1e-6)
       for n in REDUCE_NEW]
    + [("reduce_mean_bf16", "reduce_mean", {"X": BF16(4, 16)}, {"dim": [1], "out_dtype": "bfloat16"},
        ["Out"], 1e-2)]
    + [(n, n, {"X": INTS(3, 4), "Y": INTS(3, 4)}, {"out_dtype": "bool"}, ["Out"], 0.0) for n in CMP_NEW]
    + [(f"{n}_axis", n, {"X": F32(2, 3, 4), "Y": F32(3)}, {"axis": 1, "out_dtype": "bool"}, ["Out"], 0.0)
       for n in CMP_NEW]
    + [
        ("elementwise_pow", "elementwise_pow", {"X": POS(3, 4), "Y": F32(3, 4)}, {}, ["Out"], 1e-5),
        ("elementwise_pow_axis", "elementwise_pow", {"X": POS(2, 3, 4), "Y": F32(3)}, {"axis": 1},
         ["Out"], 1e-5),
        ("elementwise_mod", "elementwise_mod", {"X": F32(3, 4) * 5, "Y": POS(3, 4) + 0.5}, {},
         ["Out"], 1e-5),
        ("elementwise_mod_int", "elementwise_mod", {"X": INTS(3, 4) * 3, "Y": np.array([2, -3, 4, 5],
                                                                                     np.int32)},
         {"out_dtype": "int32"}, ["Out"], 0.0),
        ("elementwise_floordiv", "elementwise_floordiv",
         {"X": INTS(3, 4) * 5, "Y": np.array([[2, -3, 4, 7]], np.int32).repeat(3, 0)},
         {"out_dtype": "int32"}, ["Out"], 0.0),
        ("frobenius_norm", "frobenius_norm", {"X": F32(3, 4)}, {"dim": [0, 1]}, ["Out"], 1e-5),
        ("logical_or", "logical_or", {"X": BOOLS(3, 4), "Y": BOOLS(3, 4)}, {"out_dtype": "bool"},
         ["Out"], 0.0),
        ("logical_not", "logical_not", {"X": BOOLS(3, 4)}, {"out_dtype": "bool"}, ["Out"], 0.0),
        ("isfinite", "isfinite", {"X": F32(3, 4)}, {"out_dtype": "bool"}, ["Out"], 0.0),
        ("isfinite_nan", "isfinite", {"X": NAN_ROW}, {"out_dtype": "bool"}, ["Out"], 0.0),
        ("minus", "minus", {"X": F32(3, 4), "Y": F32(3, 4)}, {}, ["Out"], 1e-6),
        ("l1_norm", "l1_norm", {"X": F32(3, 4)}, {}, ["Out"], 1e-5),
        ("squared_l2_norm", "squared_l2_norm", {"X": F32(3, 4)}, {}, ["Out"], 1e-5),
        ("squared_l2_distance", "squared_l2_distance", {"X": F32(4, 3), "Y": F32(4, 3)}, {},
         ["Out", "sub_result"], 1e-5),
        ("squared_l2_distance_row", "squared_l2_distance", {"X": F32(4, 3), "Y": F32(1, 3)}, {},
         ["Out", "sub_result"], 1e-5),
        ("fill", "fill", {}, {"shape": [2, 3], "dtype": "float32", "value": list(range(6))},
         ["Out"], 0.0),
        ("fill_int64", "fill", {}, {"shape": [3], "dtype": "int64", "value": [4, -1, 7],
                                    "out_dtype": "int64"}, ["Out"], 0.0),
        ("fill_zeros_like2", "fill_zeros_like2", {"X": F32(3, 4)}, {}, ["Out"], 0.0),
        ("fill_zeros_like2_int", "fill_zeros_like2", {"X": F32(3, 4)},
         {"dtype": "int32", "out_dtype": "int32"}, ["Out"], 0.0),
        # tensor_ops
        ("reshape", "reshape", {"X": F32(2, 3, 4)}, {"shape": [0, -1]}, ["Out"], 0.0),
        ("transpose", "transpose", {"X": F32(2, 3, 4)}, {"axis": [2, 0, 1]}, ["Out"], 0.0),
        ("concat", "concat", {"X": [F32(2, 3), F32(2, 1), F32(2, 4)]}, {"axis": 1}, ["Out"], 0.0),
        ("concat_neg_bf16", "concat", {"X": [BF16(2, 3), BF16(2, 2)]},
         {"axis": -1, "out_dtype": "bfloat16"}, ["Out"], 0.0),
        ("split_num", "split", {"X": F32(2, 6, 3)}, {"axis": 1, "num": 3}, ["Out:3"], 0.0),
        ("split_sections", "split", {"X": F32(5, 4)}, {"axis": 0, "sections": [1, 3, 1]},
         ["Out:3"], 0.0),
        ("shape", "shape", {"Input": F32(2, 3, 5)}, {"out_dtype": "int32"}, ["Out"], 0.0),
        ("slice", "slice", {"Input": F32(4, 5, 6)},
         {"axes": [0, 2], "starts": [1, -4], "ends": [3, 100]}, ["Out"], 0.0),
        ("stack", "stack", {"X": [F32(2, 3), F32(2, 3), F32(2, 3)]}, {"axis": 1}, ["Y"], 0.0),
        ("unstack", "unstack", {"X": F32(2, 3, 4)}, {"axis": 1, "num": 3}, ["Y:3"], 0.0),
        ("squeeze", "squeeze", {"X": F32(2, 1, 3, 1)}, {"axes": [1]}, ["Out"], 0.0),
        ("squeeze2_all", "squeeze2", {"X": F32(2, 1, 3, 1)}, {"axes": []}, ["Out"], 0.0),
        ("squeeze2_neg", "squeeze2", {"X": F32(2, 1, 3, 1)}, {"axes": [-1, 1]}, ["Out"], 0.0),
        ("unsqueeze", "unsqueeze", {"X": F32(2, 3)}, {"axes": [0, 2]}, ["Out"], 0.0),
        ("unsqueeze2", "unsqueeze2", {"X": F32(2, 3)}, {"axes": [1]}, ["Out"], 0.0),
        ("flatten", "flatten", {"X": F32(2, 3, 4, 5)}, {"axis": 2}, ["Out"], 0.0),
        ("flatten2", "flatten2", {"X": F32(2, 3, 4)}, {"axis": 1}, ["Out"], 0.0),
        ("flatten2_axis0", "flatten2", {"X": F32(2, 3)}, {"axis": 0}, ["Out"], 0.0),
        ("gather", "gather", {"X": F32(5, 3), "Index": np.array([4, 0, 2, 2], np.int32)}, {},
         ["Out"], 0.0),
        ("gather_nd", "gather_nd", {"X": F32(3, 4, 5), "Index": np.array([[[0, 1], [2, 3]],
                                                                          [[1, 0], [2, 2]]])},
         {}, ["Out"], 0.0),
        ("scatter", "scatter", {"X": F32(5, 3), "Ids": np.array([3, 0], np.int32),
                                "Updates": F32(2, 3)}, {}, ["Out"], 0.0),
        ("scatter_add", "scatter", {"X": F32(5, 3), "Ids": np.array([3, 0, 3], np.int32),
                                    "Updates": F32(3, 3)}, {"overwrite": False}, ["Out"], 1e-6),
        ("scatter_nd_add", "scatter_nd_add",
         {"X": F32(3, 4, 2), "Index": np.array([[0, 1], [2, 3], [0, 1]]), "Updates": F32(3, 2)},
         {}, ["Out"], 1e-6),
        ("pad", "pad", {"X": F32(2, 3)}, {"paddings": [1, 0, 2, 3], "pad_value": 0.5}, ["Out"], 0.0),
        ("fill_zeros_like", "fill_zeros_like", {"X": F32(3, 4)}, {}, ["Out"], 0.0),
        ("range_int", "range", {}, {"start_v": 1, "end_v": 11, "step_v": 3, "dtype": "int64",
                                    "out_dtype": "int64"}, ["Out"], 0.0),
        ("range_float", "range", {}, {"start_v": 0.5, "end_v": 3.0, "step_v": 0.5,
                                      "dtype": "float32"}, ["Out"], 1e-7),
        ("cumsum", "cumsum", {"X": F32(3, 5)}, {"axis": 1}, ["Out"], 1e-6),
        ("cumsum_excl_rev", "cumsum", {"X": F32(3, 5)},
         {"axis": 0, "exclusive": True, "reverse": True}, ["Out"], 1e-6),
        ("cumsum_int", "cumsum", {"X": INTS(2, 6)}, {"axis": -1, "out_dtype": "int32"}, ["Out"], 0.0),
        ("argsort", "argsort", {"X": F32(3, 6)}, {"axis": -1, "out_dtypes": {"Indices": "int64"}},
         ["Out", "Indices"], 0.0),
        ("argsort_desc_axis0", "argsort", {"X": F32(5, 3)},
         {"axis": 0, "descending": True, "out_dtypes": {"Indices": "int64"}},
         ["Out", "Indices"], 0.0),
        ("expand_as", "expand_as", {"X": F32(2, 1, 3), "target_tensor": F32(4, 5, 3)}, {},
         ["Out"], 0.0),
        ("linspace", "linspace", {"Start": np.array([-1.0], np.float32),
                                  "Stop": np.array([2.5], np.float32)}, {"num_v": 8}, ["Out"], 1e-6),
        ("norm", "norm", {"X": F32(3, 4, 5)}, {"axis": 1, "epsilon": 1e-6}, ["Out", "Norm"], 1e-6),
        ("shard_index", "shard_index", {"X": rng.randint(0, 20, (6, 1)).astype(np.int64)},
         {"index_num": 20, "nshards": 3, "shard_id": 1, "ignore_value": -1, "out_dtype": "int64"},
         ["Out"], 0.0),
        ("space_to_depth", "space_to_depth", {"X": F32(2, 8, 4, 6)}, {"blocksize": 2}, ["Out"], 0.0),
        ("sequence_conv", "sequence_conv",
         {"X": SEQ, "XLod": SEQ_LOD, "Filter": F32(12, 5)}, {"contextLength": 3}, ["Out"], 1e-5),
        ("sequence_conv_start", "sequence_conv",
         {"X": SEQ, "XLod": SEQ_LOD, "Filter": F32(16, 2)},
         {"contextLength": 4, "contextStart": -3}, ["Out"], 1e-5),
    ]
)
CASES += NEW_CASES

# (id, op_type, inputs, attrs, out_slots, the input slots to differentiate)
GRAD_CASES = (
    [(n, n, {"X": make()}, {}, ["Out"], ["X"]) for n, (make, _) in UNARY_NEW.items()]
    + [(n, n, {"X": F32(4, 5) * 2}, a, ["Out"], ["X"]) for n, a in ATTR_UNARY_NEW]
    + [(f"{n}_dims", n, {"X": POS(3, 4, 5)}, {"dim": [0, 2]}, ["Out"], ["X"]) for n in REDUCE_NEW]
    + [(f"{n}_all", n, {"X": POS(3, 4)}, {"dim": [0], "reduce_all": True}, ["Out"], ["X"])
       for n in REDUCE_NEW]
    + [
        ("elementwise_pow", "elementwise_pow", {"X": POS(3, 4), "Y": F32(3, 4)}, {}, ["Out"],
         ["X", "Y"]),
        ("elementwise_mod", "elementwise_mod", {"X": F32(3, 4) * 5, "Y": POS(3, 4) + 0.5}, {},
         ["Out"], ["X"]),
        ("frobenius_norm", "frobenius_norm", {"X": F32(3, 4)}, {}, ["Out"], ["X"]),
        ("minus", "minus", {"X": F32(3, 4), "Y": F32(3, 4)}, {}, ["Out"], ["X", "Y"]),
        ("l1_norm", "l1_norm", {"X": F32(3, 4)}, {}, ["Out"], ["X"]),
        ("squared_l2_norm", "squared_l2_norm", {"X": F32(3, 4)}, {}, ["Out"], ["X"]),
        ("squared_l2_distance", "squared_l2_distance", {"X": F32(4, 3), "Y": F32(1, 3)}, {},
         ["Out", "sub_result"], ["X", "Y"]),
        ("reshape", "reshape", {"X": F32(2, 3, 4)}, {"shape": [0, -1]}, ["Out"], ["X"]),
        ("transpose", "transpose", {"X": F32(2, 3, 4)}, {"axis": [2, 0, 1]}, ["Out"], ["X"]),
        ("concat", "concat", {"X": [F32(2, 3), F32(2, 1)]}, {"axis": 1}, ["Out"], ["X0", "X1"]),
        ("split_sections", "split", {"X": F32(5, 4)}, {"axis": 0, "sections": [1, 3, 1]},
         ["Out:3"], ["X"]),
        ("slice", "slice", {"Input": F32(4, 5, 6)},
         {"axes": [0, 2], "starts": [1, -4], "ends": [3, 100]}, ["Out"], ["Input"]),
        ("stack", "stack", {"X": [F32(2, 3), F32(2, 3)]}, {"axis": 1}, ["Y"], ["X0", "X1"]),
        ("unstack", "unstack", {"X": F32(2, 3, 4)}, {"axis": 1, "num": 3}, ["Y:3"], ["X"]),
        ("squeeze2", "squeeze2", {"X": F32(2, 1, 3, 1)}, {"axes": [1]}, ["Out"], ["X"]),
        ("squeeze", "squeeze", {"X": F32(2, 1, 3)}, {"axes": []}, ["Out"], ["X"]),
        ("unsqueeze2", "unsqueeze2", {"X": F32(2, 3)}, {"axes": [0, 2]}, ["Out"], ["X"]),
        ("unsqueeze", "unsqueeze", {"X": F32(2, 3)}, {"axes": [1]}, ["Out"], ["X"]),
        ("flatten2", "flatten2", {"X": F32(2, 3, 4)}, {"axis": 2}, ["Out"], ["X"]),
        ("flatten", "flatten", {"X": F32(2, 3, 4)}, {"axis": 1}, ["Out"], ["X"]),
        ("gather", "gather", {"X": F32(5, 3), "Index": np.array([4, 0, 2, 2], np.int32)}, {},
         ["Out"], ["X"]),
        ("gather_nd", "gather_nd", {"X": F32(3, 4, 5), "Index": np.array([[0, 1], [2, 3], [0, 1]])},
         {}, ["Out"], ["X"]),
        ("scatter", "scatter", {"X": F32(5, 3), "Ids": np.array([3, 0], np.int32),
                                "Updates": F32(2, 3)}, {}, ["Out"], ["X", "Updates"]),
        ("scatter_add", "scatter", {"X": F32(5, 3), "Ids": np.array([3, 0, 3], np.int32),
                                    "Updates": F32(3, 3)}, {"overwrite": False}, ["Out"],
         ["X", "Updates"]),
        ("scatter_nd_add", "scatter_nd_add",
         {"X": F32(3, 4, 2), "Index": np.array([[0, 1], [2, 3], [0, 1]]), "Updates": F32(3, 2)},
         {}, ["Out"], ["X", "Updates"]),
        ("pad", "pad", {"X": F32(2, 3)}, {"paddings": [1, 0, 2, 3], "pad_value": 0.5}, ["Out"],
         ["X"]),
        ("cumsum_excl_rev", "cumsum", {"X": F32(3, 5)},
         {"axis": 0, "exclusive": True, "reverse": True}, ["Out"], ["X"]),
        ("argsort", "argsort", {"X": F32(3, 6)}, {"axis": -1, "out_dtypes": {"Indices": "int64"}},
         ["Out"], ["X"]),
        ("expand_as", "expand_as", {"X": F32(2, 1, 3), "target_tensor": F32(4, 5, 3)}, {},
         ["Out"], ["X"]),
        ("norm", "norm", {"X": F32(3, 4, 5)}, {"axis": 1}, ["Out", "Norm"], ["X"]),
        ("space_to_depth", "space_to_depth", {"X": F32(2, 8, 4, 6)}, {"blocksize": 2}, ["Out"],
         ["X"]),
        ("sequence_conv", "sequence_conv", {"X": SEQ, "XLod": SEQ_LOD, "Filter": F32(12, 5)},
         {"contextLength": 3}, ["Out"], ["X", "Filter"]),
    ]
)


# --- the other optimizers' updates, the ragged path and the select op ------
# (own seed, so the cases above keep their inputs)
r14 = np.random.RandomState(14)
G32 = lambda *s: r14.randn(*s).astype("float32")  # noqa: E731
GPOS = lambda *s: (r14.rand(*s) + 0.5).astype("float32")  # noqa: E731
LR1 = np.array([0.1], np.float32)
LENS = np.array([5, 2, 3], np.int32)


def _opt(op_type, extra, outs, attrs):
    """An update op on a [4, 5] parameter: (op type, inputs, attrs, outputs)."""
    return op_type, dict({"Param": G32(4, 5), "Grad": G32(4, 5), "LearningRate": LR1}, **extra), \
        attrs, outs


_LAMB_IN = {"Moment1": G32(4, 5) * 0.1, "Moment2": GPOS(4, 5) * 0.1,
            "Beta1Pow": np.array([0.81], np.float32), "Beta2Pow": np.array([0.998], np.float32)}
_ADAM_OUT = ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"]
_RMS_OUT = ["ParamOut", "MeanSquareOut", "MeanGradOut", "MomentOut"]
_FTRL_OUT = ["ParamOut", "SquaredAccumOut", "LinearAccumOut"]
OPT_CASES = {
    "rmsprop": _opt("rmsprop", {"MeanSquare": GPOS(4, 5), "MeanGrad": G32(4, 5) * 0.1,
                                "Moment": G32(4, 5)}, _RMS_OUT,
                    {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}),
    "rmsprop_centered": _opt("rmsprop", {"MeanSquare": GPOS(4, 5) + 1.0,
                                         "MeanGrad": G32(4, 5) * 0.1, "Moment": G32(4, 5)},
                             _RMS_OUT, {"centered": True}),
    "adamax": _opt("adamax", {"Moment": G32(4, 5), "InfNorm": GPOS(4, 5),
                              "Beta1Pow": np.array([0.729], np.float32)},
                   ["ParamOut", "MomentOut", "InfNormOut"], {"beta1": 0.9, "beta2": 0.99}),
    "adadelta": _opt("adadelta", {"AvgSquaredGrad": GPOS(4, 5), "AvgSquaredUpdate": GPOS(4, 5)},
                     ["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"], {"rho": 0.9}),
    "lamb": _opt("lamb", _LAMB_IN, _ADAM_OUT, {"weight_decay": 0.01}),
    "lamb_no_decay": _opt("lamb", _LAMB_IN, _ADAM_OUT, {"epsilon": 1e-4}),
    "ftrl": _opt("ftrl", {"SquaredAccumulator": GPOS(4, 5), "LinearAccumulator": G32(4, 5)},
                 _FTRL_OUT, {"l1": 0.1, "l2": 0.2, "lr_power": -0.5}),
    "ftrl_power": _opt("ftrl", {"SquaredAccumulator": GPOS(4, 5),
                                "LinearAccumulator": G32(4, 5)}, _FTRL_OUT,
                       {"l1": 0.5, "lr_power": -0.3}),
    "lars_momentum": _opt("lars_momentum", {"Velocity": G32(4, 5)}, ["ParamOut", "VelocityOut"],
                          {"mu": 0.9, "lars_coeff": 0.01, "lars_weight_decay": 5e-4}),
    "lars_momentum_eps": _opt("lars_momentum", {"Velocity": G32(4, 5)},
                              ["ParamOut", "VelocityOut"],
                              {"lars_weight_decay": 0.1, "epsilon": 0.5}),
    "dpsgd_no_noise": _opt("dpsgd", {}, ["ParamOut"],
                           {"clip": 1.0, "sigma": 0.0, "batch_size": 4.0}),
    "proximal_gd": _opt("proximal_gd", {}, ["ParamOut"], {"l1": 0.5, "l2": 0.1}),
    "proximal_adagrad": _opt("proximal_adagrad", {"Moment": GPOS(4, 5)}, ["ParamOut", "MomentOut"],
                             {"l1": 0.2, "l2": 0.3}),
    "decayed_adagrad": _opt("decayed_adagrad", {"Moment": GPOS(4, 5)}, ["ParamOut", "MomentOut"],
                            {"decay": 0.9, "epsilon": 1e-5}),
}
SLICE14_CASES = (
    [(n, op_type, ins, attrs, outs, 1e-5) for n, (op_type, ins, attrs, outs) in OPT_CASES.items()]
    + [
        ("model_average_accum", "model_average_accum",
         {"Sum": G32(4, 5), "Count": np.array([2.0], np.float32), "Param": G32(4, 5)},
         {"max_average_window": 4}, ["SumOut"], 1e-6),
        ("model_average_accum_halve", "model_average_accum",
         {"Sum": G32(4, 5), "Count": np.array([3.0], np.float32), "Param": G32(4, 5)},
         {"max_average_window": 4}, ["SumOut"], 1e-6),
        ("model_average_count", "model_average_count", {"Count": np.array([3.0], np.float32)},
         {"max_average_window": 4}, ["CountOut"], 0.0),
        ("dgc_ramp", "dgc", {"Grad": G32(4, 8), "U": G32(4, 8), "V": G32(4, 8),
                             "CurrentStep": np.array([3.0], np.float32)},
         {"m": 0.9, "rampup_begin_step": 1.0, "rampup_step": 4.0, "sparsity": [0.75, 0.5]},
         ["GradOut", "UOut", "VOut"], 1e-6),
        ("dgc_before_ramp", "dgc", {"Grad": G32(4, 8), "U": G32(4, 8), "V": G32(4, 8),
                                    "CurrentStep": np.array([0.0], np.float32)},
         {"rampup_begin_step": 1.0, "sparsity": [0.75]}, ["GradOut", "UOut", "VOut"], 0.0),
        ("dgc_clip", "dgc", {"Grad": G32(4, 8) * 3, "U": G32(4, 8), "V": G32(4, 8),
                             "CurrentStep": np.array([5.0], np.float32)},
         {"clip_norm": 1.0, "sparsity": [0.9]}, ["GradOut", "UOut", "VOut"], 1e-6),
        ("select_input", "select_input", {"X": [G32(2, 3), G32(2, 3)],
                                          "Mask": np.array([1], np.int32)}, {}, ["Out"], 0.0),
        ("select_input_0", "select_input", {"X": [G32(2, 3), G32(2, 3)],
                                            "Mask": np.array([0], np.int32)}, {}, ["Out"], 0.0),
        ("sequence_softmax", "sequence_softmax", {"X": G32(3, 5), "XLod": LENS}, {}, ["Out"], 1e-6),
        ("sequence_softmax_3d", "sequence_softmax", {"X": G32(3, 5, 1), "XLod": LENS}, {}, ["Out"],
         1e-6),
        ("sequence_expand", "sequence_expand", {"X": G32(3, 4), "Y": G32(3, 5, 2), "YLod": LENS},
         {}, ["Out"], 0.0),
        ("sequence_expand_as", "sequence_expand_as",
         {"X": G32(3, 1, 4), "Y": G32(3, 5, 2), "YLod": LENS}, {}, ["Out"], 0.0),
        ("sequence_reverse", "sequence_reverse", {"X": G32(3, 5, 4), "XLod": LENS}, {}, ["Out"],
         0.0),
        ("sequence_pad", "sequence_pad", {"X": G32(3, 5, 4), "XLod": LENS,
                                          "PadValue": np.array([0.5], np.float32)},
         {"padded_length": 7, "out_dtypes": {"Length": "int64"}}, ["Out", "Length"], 0.0),
        ("sequence_pad_cut", "sequence_pad", {"X": G32(3, 5), "XLod": LENS,
                                              "PadValue": np.array([-1.0], np.float32)},
         {"padded_length": 4, "out_dtypes": {"Length": "int64"}}, ["Out", "Length"], 0.0),
        ("sequence_unpad", "sequence_unpad", {"X": G32(3, 5, 4), "Length": LENS.astype(np.int64)},
         {"out_dtypes": {"OutLod": "int32"}}, ["Out", "OutLod"], 0.0),
        ("sequence_concat", "sequence_concat",
         {"X": [G32(3, 4, 2), G32(3, 3, 2)], "XLod": [np.array([4, 1, 2], np.int32),
                                                    np.array([2, 3, 0], np.int32)]},
         {"out_dtypes": {"OutLod": "int32"}}, ["Out", "OutLod"], 0.0),
        ("sequence_slice", "sequence_slice",
         {"X": G32(3, 5, 4), "XLod": LENS, "Offset": np.array([[1], [0], [1]], np.int64),
          "Length": np.array([[3], [2], [1]], np.int64)},
         {"out_dtypes": {"OutLod": "int32"}}, ["Out", "OutLod"], 0.0),
        ("sequence_erase", "sequence_erase",
         {"X": r14.randint(0, 5, (3, 6)).astype(np.int32), "XLod": np.array([6, 3, 5], np.int32)},
         {"tokens": [1, 3], "out_dtypes": {"Out": "int32", "OutLod": "int32"}},
         ["Out", "OutLod"], 0.0),
        ("sequence_erase_3d", "sequence_erase",
         {"X": r14.randint(0, 5, (3, 6, 1)).astype(np.int32), "XLod": np.array([6, 3, 5], np.int32)},
         {"tokens": [0], "out_dtypes": {"Out": "int32", "OutLod": "int32"}}, ["Out", "OutLod"], 0.0),
        ("sequence_enumerate", "sequence_enumerate",
         {"X": r14.randint(0, 9, (3, 6)).astype(np.int32), "XLod": np.array([6, 3, 5], np.int32)},
         {"win_size": 3, "pad_value": 9, "out_dtypes": {"Out": "int32", "OutLod": "int32"}},
         ["Out", "OutLod"], 0.0),
        ("sequence_scatter", "sequence_scatter",
         {"X": G32(3, 6), "Ids": r14.randint(0, 6, (3, 4)).astype(np.int32),
          "IdsLod": np.array([4, 2, 3], np.int32), "Updates": G32(3, 4)}, {}, ["Out"], 1e-6),
        ("sequence_reshape", "sequence_reshape",
         {"X": G32(3, 4, 6), "XLod": np.array([4, 2, 3], np.int32)},
         {"new_dim": 3, "out_dtypes": {"OutLod": "int32"}}, ["Out", "OutLod"], 0.0),
        ("dynamic_gru", "dynamic_gru", {"Input": G32(3, 5, 12), "XLod": LENS,
                                        "Weight": G32(4, 12) * 0.5, "Bias": G32(1, 12)}, {},
         ["Hidden"], 1e-5),
        ("dynamic_gru_rev_origin_h0", "dynamic_gru",
         {"Input": G32(3, 5, 12), "XLod": LENS, "Weight": G32(4, 12) * 0.5, "Bias": G32(1, 12),
          "H0": G32(3, 4)}, {"is_reverse": True, "origin_mode": True}, ["Hidden"], 1e-5),
        ("dynamic_lstmp", "dynamic_lstmp",
         {"Input": G32(3, 5, 16), "XLod": LENS, "Weight": G32(3, 16) * 0.5,
          "ProjWeight": G32(4, 3) * 0.5, "Bias": G32(1, 28)}, {}, ["Projection", "Cell"], 1e-5),
        ("dynamic_lstmp_rev_identity", "dynamic_lstmp",
         {"Input": G32(3, 5, 16), "XLod": LENS, "Weight": G32(3, 16) * 0.5,
          "ProjWeight": G32(4, 3) * 0.5, "Bias": G32(1, 16)},
         {"use_peepholes": False, "is_reverse": True, "proj_activation": "identity"},
         ["Projection", "Cell"], 1e-5),
        ("cudnn_lstm", "cudnn_lstm",
         {"Input": G32(2, 4, 3), "W": G32(456) * 0.3, "InitH": G32(4, 2, 3),
          "InitC": G32(4, 2, 3)},
         {"hidden_size": 3, "num_layers": 2, "is_bidirec": True, "is_test": True},
         ["Out", "LastH", "LastC"], 1e-5),
        ("cudnn_lstm_1layer", "cudnn_lstm",
         {"Input": G32(2, 4, 3), "W": G32(96) * 0.3, "InitH": G32(1, 2, 3),
          "InitC": G32(1, 2, 3)}, {"hidden_size": 3}, ["Out", "LastH", "LastC"], 1e-5),
        ("gru_unit", "gru_unit", {"Input": G32(3, 12), "HiddenPrev": G32(3, 4),
                                  "Weight": G32(4, 12), "Bias": G32(1, 12)}, {},
         ["Hidden", "ResetHiddenPrev", "Gate"], 1e-6),
        ("gru_unit_origin", "gru_unit", {"Input": G32(3, 12), "HiddenPrev": G32(3, 4),
                                         "Weight": G32(4, 12)}, {"origin_mode": True},
         ["Hidden", "ResetHiddenPrev", "Gate"], 1e-6),
        ("lstm_unit", "lstm_unit", {"X": G32(3, 16), "C_prev": G32(3, 4)}, {"forget_bias": 0.5},
         ["C", "H"], 1e-6),
        ("warpctc", "warpctc",
         {"Logits": G32(3, 6, 5), "XLod": np.array([6, 4, 5], np.int32),
          "Label": r14.randint(1, 5, (3, 3)).astype(np.int32),
          "LabelLod": np.array([3, 1, 2], np.int32)}, {}, ["Loss"], 1e-5),
        ("warpctc_norm_repeat_empty", "warpctc",
         {"Logits": G32(3, 6, 5), "XLod": np.array([6, 4, 5], np.int32),
          "Label": np.array([[2, 2, 3], [1, 0, 0], [4, 1, 1]], np.int32),
          "LabelLod": np.array([3, 0, 3], np.int32)}, {"norm_by_times": True}, ["Loss"], 1e-5),
        ("linear_chain_crf", "linear_chain_crf",
         {"Emission": G32(3, 5, 4), "XLod": LENS, "Transition": G32(6, 4),
          "Label": r14.randint(0, 4, (3, 5)).astype(np.int32), "LabelLod": LENS}, {},
         ["LogLikelihood"], 1e-5),
        ("crf_decoding", "crf_decoding",
         {"Emission": G32(3, 5, 4), "XLod": LENS, "Transition": G32(6, 4)},
         {"out_dtype": "int64"}, ["ViterbiPath"], 0.0),
        ("crf_decoding_label", "crf_decoding",
         {"Emission": G32(3, 5, 4), "XLod": LENS, "Transition": G32(6, 4),
          "Label": r14.randint(0, 4, (3, 5)).astype(np.int32)},
         {"out_dtype": "int64"}, ["ViterbiPath"], 0.0),
    ]
)
CASES += SLICE14_CASES
GRAD_CASES += [
    ("sequence_softmax", "sequence_softmax", {"X": G32(3, 5), "XLod": LENS}, {}, ["Out"], ["X"]),
    ("sequence_expand", "sequence_expand", {"X": G32(3, 4), "Y": G32(3, 5, 2), "YLod": LENS}, {},
     ["Out"], ["X"]),
    ("sequence_reverse", "sequence_reverse", {"X": G32(3, 5, 4), "XLod": LENS}, {}, ["Out"],
     ["X"]),
    ("sequence_pad", "sequence_pad", {"X": G32(3, 5, 4), "XLod": LENS,
                                      "PadValue": np.array([0.5], np.float32)},
     {"padded_length": 7}, ["Out"], ["X"]),
    ("sequence_unpad", "sequence_unpad", {"X": G32(3, 5, 4), "Length": LENS.astype(np.int64)}, {},
     ["Out"], ["X"]),
    ("sequence_concat", "sequence_concat",
     {"X": [G32(3, 4, 2), G32(3, 3, 2)], "XLod": [np.array([4, 1, 2], np.int32),
                                                np.array([2, 3, 0], np.int32)]}, {}, ["Out"],
     ["X0", "X1"]),
    ("sequence_slice", "sequence_slice",
     {"X": G32(3, 5, 4), "XLod": LENS, "Offset": np.array([[1], [0], [1]], np.int64),
      "Length": np.array([[3], [2], [1]], np.int64)}, {}, ["Out"], ["X"]),
    ("sequence_scatter", "sequence_scatter",
     {"X": G32(3, 6), "Ids": r14.randint(0, 6, (3, 4)).astype(np.int32),
      "IdsLod": np.array([4, 2, 3], np.int32), "Updates": G32(3, 4)}, {}, ["Out"],
     ["X", "Updates"]),
    ("sequence_reshape", "sequence_reshape", {"X": G32(3, 4, 6), "XLod": np.array([4, 2, 3],
                                                                                  np.int32)},
     {"new_dim": 3}, ["Out"], ["X"]),
    ("dynamic_gru", "dynamic_gru", {"Input": G32(3, 5, 12), "XLod": LENS,
                                    "Weight": G32(4, 12) * 0.5, "Bias": G32(1, 12),
                                    "H0": G32(3, 4)}, {"is_reverse": True}, ["Hidden"],
     ["Input", "Weight", "Bias", "H0"]),
    ("dynamic_lstmp", "dynamic_lstmp",
     {"Input": G32(3, 5, 16), "XLod": LENS, "Weight": G32(3, 16) * 0.5,
      "ProjWeight": G32(4, 3) * 0.5, "Bias": G32(1, 28)}, {}, ["Projection", "Cell"],
     ["Input", "Weight", "ProjWeight", "Bias"]),
    ("cudnn_lstm", "cudnn_lstm",
     {"Input": G32(2, 4, 3), "W": G32(456) * 0.3, "InitH": G32(4, 2, 3), "InitC": G32(4, 2, 3)},
     {"hidden_size": 3, "num_layers": 2, "is_bidirec": True, "is_test": True},
     ["Out", "LastH", "LastC"], ["Input", "W", "InitH", "InitC"]),
    ("gru_unit", "gru_unit", {"Input": G32(3, 12), "HiddenPrev": G32(3, 4), "Weight": G32(4, 12),
                              "Bias": G32(1, 12)}, {}, ["Hidden", "ResetHiddenPrev", "Gate"],
     ["Input", "HiddenPrev", "Weight", "Bias"]),
    ("lstm_unit", "lstm_unit", {"X": G32(3, 16), "C_prev": G32(3, 4)}, {"forget_bias": 0.5},
     ["C", "H"], ["X", "C_prev"]),
    ("warpctc", "warpctc",
     {"Logits": G32(3, 6, 5), "XLod": np.array([6, 4, 5], np.int32),
      "Label": np.array([[2, 2, 3], [1, 0, 0], [4, 1, 1]], np.int32),
      "LabelLod": np.array([3, 1, 2], np.int32)}, {"norm_by_times": True}, ["Loss"], ["Logits"]),
    ("linear_chain_crf", "linear_chain_crf",
     {"Emission": G32(3, 5, 4), "XLod": LENS, "Transition": G32(6, 4),
      "Label": r14.randint(0, 4, (3, 5)).astype(np.int32), "LabelLod": LENS}, {},
     ["LogLikelihood"], ["Emission", "Transition"]),
    ("select_input", "select_input", {"X": [G32(2, 3), G32(2, 3)],
                                      "Mask": np.array([1], np.int32)}, {}, ["Out"], ["X0", "X1"]),
]


# the nn and host ops of the detection slice (ROADMAP A8.6): paddle_tpu_torch/models/detection_cases.py
SLICE15_CASES = _cases.NN_CASES
H32, r15 = _cases.H32, _cases.r15
CASES += SLICE15_CASES
GRAD_CASES += [
    ("depthwise_conv2d", "depthwise_conv2d", {"Input": H32(2, 4, 7, 7), "Filter": H32(4, 1, 3, 3)},
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1], "groups": 4}, ["Output"],
     ["Input", "Filter"]),
    ("conv2d_transpose", "conv2d_transpose", {"Input": H32(2, 4, 5, 6), "Filter": H32(4, 3, 3, 2)},
     {"strides": [1, 2], "paddings": [2, 0], "dilations": [2, 1], "groups": 2}, ["Output"],
     ["Input", "Filter"]),
    ("conv3d_transpose", "conv3d_transpose", {"Input": H32(1, 2, 3, 4, 3), "Filter": H32(2, 3, 2, 3, 2)},
     {"strides": [2, 1, 2], "paddings": [0, 1, 0], "dilations": [1, 1, 1], "groups": 1},
     ["Output"], ["Input", "Filter"]),
    ("bilinear_interp", "bilinear_interp", {"X": H32(2, 3, 5, 7)},
     {"out_h": 8, "out_w": 11, "align_corners": False, "align_mode": 1}, ["Out"], ["X"]),
    ("nearest_interp", "nearest_interp", {"X": H32(2, 3, 5, 7)},
     {"out_h": 10, "out_w": 14, "align_corners": True}, ["Out"], ["X"]),
    ("group_norm", "group_norm", {"X": H32(2, 6, 4, 5), "Scale": H32(6), "Bias": H32(6)},
     {"groups": 3}, ["Y"], ["X", "Scale", "Bias"]),
    ("instance_norm", "instance_norm", {"X": H32(2, 3, 4, 5), "Scale": H32(3), "Bias": H32(3)}, {},
     ["Y"], ["X", "Scale", "Bias"]),
    ("prelu_channel", "prelu", {"X": H32(2, 3, 4, 4), "Alpha": H32(3)}, {"mode": "channel"},
     ["Out"], ["X", "Alpha"]),
    ("log_softmax", "log_softmax", {"X": H32(3, 7)}, {"axis": -1}, ["Out"], ["X"]),
    ("pad2d_reflect", "pad2d", {"X": H32(2, 3, 4, 5)}, {"paddings": [2, 1, 3, 1], "mode": "reflect"},
     ["Out"], ["X"]),
    ("crop", "crop", {"X": H32(3, 5, 6)}, {"offsets": [1, 0, 2], "shape": [2, 4, 3]}, ["Out"], ["X"]),
    ("huber_loss", "huber_loss", {"X": H32(6, 1) * 2, "Y": H32(6, 1) * 2}, {"delta": 1.0},
     ["Out"], ["X", "Y"]),
    ("deformable_conv", "deformable_conv",
     {"Input": H32(2, 4, 6, 6), "Offset": H32(2, 2 * 2 * 9, 6, 6) * 1.5,
      "Mask": r15.rand(2, 2 * 9, 6, 6).astype(np.float32), "Filter": H32(6, 2, 3, 3)},
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1], "groups": 2,
      "deformable_groups": 2}, ["Output"], ["Input", "Offset", "Mask", "Filter"]),
]


# the last op files (models/tail_cases.py, which chip_smoke's tail_parity
# shares); the random ones are held by their moments in test_torch_tail_models.py
MISC18_CASES, TAIL18_CASES = _tail.MISC_CASES, _tail.TAIL_CASES
CASES += MISC18_CASES + TAIL18_CASES
_BY_ID18 = {c[0]: c for c in MISC18_CASES + TAIL18_CASES}
GRAD_CASES += [(name,) + _BY_ID18[name][1:4] + (_BY_ID18[name][4][:1], wrt) for name, wrt in (
    ("hinge_loss", ["Logits"]), ("log_loss", ["Predicted"]), ("rank_loss", ["Left", "Right"]),
    ("margin_rank_loss", ["X1", "X2"]), ("bpr_loss", ["X"]), ("kldiv_none", ["X"]),
    ("modified_huber_loss", ["X"]), ("selu", ["X"]), ("lrn", ["X"]), ("maxout", ["X"]),
    ("affine_channel", ["X", "Scale", "Bias"]), ("reverse", ["X"]), ("diag", ["Diagonal"]),
    ("conv3d", ["Input", "Filter"]), ("pool3d_max", ["X"]), ("pool3d_avg_exclusive", ["X"]),
    ("affine_grid", ["Theta"]), ("grid_sampler", ["X", "Grid"]), ("spectral_norm", ["Weight"]),
    ("row_conv", ["X", "Filter"]), ("im2sequence", ["X"]),
    ("nce_custom_negs", ["Input", "Weight", "Bias"]), ("hsigmoid", ["X", "W", "Bias"]),
    ("tree_conv", ["NodesVector", "Filter"]), ("brelu", ["X"]), ("soft_relu", ["X"]),
    ("thresholded_relu", ["X"]), ("cos_sim", ["X", "Y"]), ("smooth_l1", ["X", "Y"]),
    ("teacher_student", ["X"]), ("pixel_shuffle", ["X"]), ("shuffle_channel", ["X"]),
    ("temporal_shift", ["X"]), ("fsp", ["X", "Y"]), ("unfold", ["X"]),
    ("adaptive_pool2d_max", ["X"]), ("adaptive_pool2d_avg", ["X"]),
    ("add_position_encoding", ["X"]), ("bilinear_tensor_product", ["X", "Y", "Weight", "Bias"]),
    ("cvm", ["X"]), ("data_norm", ["X"]))]
# lookup_table_v2 (the lookup_table lowering, no trailing 1 on the ids), dense
# and is_sparse (its gradient a SelectedRows, fetched dense)
_rv2 = np.random.RandomState(22)
_V2_IDS, _V2_W = _rv2.randint(0, 10, (3, 5)), _rv2.randn(10, 4).astype(np.float32)
CASES += [("lookup_v2", "lookup_table_v2", {"W": _V2_W, "Ids": _V2_IDS}, {}, ["Out"], 0.0),
          ("lookup_v2_pad", "lookup_table_v2", {"W": _V2_W, "Ids": _V2_IDS},
           {"padding_idx": 3}, ["Out"], 0.0)]
GRAD_CASES += [("lookup_v2", "lookup_table_v2", {"W": _V2_W, "Ids": _V2_IDS},
                {"padding_idx": 3}, ["Out"], ["W"]),
               ("lookup_v2_sparse", "lookup_table_v2", {"W": _V2_W, "Ids": _V2_IDS},
                {"is_sparse": True}, ["Out"], ["W"])]

# contrib/mixed_precision: update_loss_scaling's state machine (growth after
# incr_every_n_steps finite steps, growth to inf keeping the old scale, decay
# floored at 1.0, the int32 counters), and the update ops with FoundInf wired
# (set: every output state is its input; clear: the step)
_ULS = {"incr_every_n_steps": 1000, "decr_every_n_nan_or_inf": 2, "incr_ratio": 2.0,
        "decr_ratio": 0.5, "out_dtypes": {"GoodStepsOut": "int32", "BadStepsOut": "int32"}}
_ULS_OUT = ["LossScalingOut", "GoodStepsOut", "BadStepsOut"]


def _uls(found, scale, good, bad):
    return {"FoundInf": np.array([found]), "LossScaling": np.array([scale], np.float32),
            "GoodSteps": np.array([good], np.int32), "BadSteps": np.array([bad], np.int32)}


_ADAM_IN = dict(CASES[[c[0] for c in CASES].index("adam")][2])
CASES += [
    ("uls_finite_step", "update_loss_scaling", _uls(False, 32768.0, 3, 1), _ULS, _ULS_OUT, 0.0),
    ("uls_growth", "update_loss_scaling", _uls(False, 32768.0, 999, 0), _ULS, _ULS_OUT, 0.0),
    ("uls_growth_to_inf_keeps_scale", "update_loss_scaling", _uls(False, 3e38, 999, 0), _ULS,
     _ULS_OUT, 0.0),
    ("uls_first_overflow", "update_loss_scaling", _uls(True, 32768.0, 5, 0), _ULS, _ULS_OUT, 0.0),
    ("uls_decay", "update_loss_scaling", _uls(True, 32768.0, 0, 1), _ULS, _ULS_OUT, 0.0),
    ("uls_decay_floored", "update_loss_scaling", _uls(True, 1.5, 0, 1), _ULS, _ULS_OUT, 0.0),
    ("adam_found_inf_set", "adam", dict(_ADAM_IN, FoundInf=np.array([True])),
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
     ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"], 0.0),
    ("adam_found_inf_clear", "adam", dict(_ADAM_IN, FoundInf=np.array([False])),
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
     ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"], 1e-6),
    ("momentum_found_inf_set", "momentum",
     {"Param": F32(4, 6), "Grad": F32(4, 6), "Velocity": F32(4, 6),
      "LearningRate": np.array([0.1], np.float32), "FoundInf": np.array([True])}, {"mu": 0.9},
     ["ParamOut", "VelocityOut"], 0.0),
]


# the fake-quantize family (contrib/slim's QAT ops), float32 and bf16: OutScale
# is computed in X's dtype while the rule declares float32, in both packages.
# Bit for bit, save the moving average: XLA's CPU backend contracts its
# float32 scale update (one ulp), and keeps a bf16 product in float32 where
# the update widens to float32 (up to half a bf16 step of the scale)
_qr = np.random.RandomState(22)
_QF32 = lambda *s: _qr.randn(*s).astype("float32")  # noqa: E731
_QBF16 = lambda *s: _qr.randn(*s).astype(ml_dtypes.bfloat16)  # noqa: E731
_FQ_OUT = ["Out", "OutScale"]
FAKE_QUANT_CASES = [
    ("fq_abs_max", "fake_quantize_abs_max", {"X": _QF32(4, 6)}, {"bit_length": 8}, _FQ_OUT, 0.0),
    ("fq_abs_max_4bit", "fake_quantize_abs_max", {"X": _QF32(3, 5)}, {"bit_length": 4}, _FQ_OUT,
     0.0),
    ("fq_abs_max_bf16", "fake_quantize_abs_max", {"X": _QBF16(4, 6)},
     {"bit_length": 8, "out_dtype": "bfloat16"}, _FQ_OUT, 0.0),
    ("fq_channel_conv", "fake_channel_wise_quantize_abs_max", {"X": _QF32(5, 3, 2, 2)},
     {"bit_length": 8, "quant_axis": 0}, _FQ_OUT, 0.0),
    ("fq_channel_mul_axis1", "fake_channel_wise_quantize_abs_max", {"X": _QF32(6, 7)},
     {"bit_length": 8, "quant_axis": 1}, _FQ_OUT, 0.0),
    ("fq_channel_bf16", "fake_channel_wise_quantize_abs_max", {"X": _QBF16(6, 7)},
     {"bit_length": 8, "quant_axis": 1, "out_dtype": "bfloat16"}, _FQ_OUT, 0.0),
    ("fq_moving_average", "fake_quantize_moving_average_abs_max",
     {"X": _QF32(4, 6), "InScale": np.array([1.5], np.float32)},
     {"bit_length": 8, "moving_rate": 0.9}, _FQ_OUT, 1e-6),
    ("fq_moving_average_first", "fake_quantize_moving_average_abs_max",
     {"X": _QF32(4, 6) * 3, "InScale": np.array([0.0], np.float32)}, {"bit_length": 8},
     _FQ_OUT, 1e-6),
    ("fq_moving_average_clipped", "fake_quantize_moving_average_abs_max",
     {"X": _QF32(4, 6) * 3, "InScale": np.array([0.5], np.float32)}, {"moving_rate": 0.5},
     _FQ_OUT, 1e-6),
    ("fq_moving_average_bf16", "fake_quantize_moving_average_abs_max",
     {"X": _QBF16(4, 6), "InScale": np.array([1.0], np.float32)}, {"bit_length": 8},
     _FQ_OUT, 2e-3),  # half a bf16 step of 0.1 * max|X| (max|X| < 4)
    ("fdq_max_abs", "fake_dequantize_max_abs",
     {"X": np.round(_QF32(4, 6) * 40), "Scale": np.array([0.3], np.float32)},
     {"max_range": 127.0}, ["Out"], 0.0),
    ("fdq_max_abs_bf16", "fake_dequantize_max_abs",
     {"X": _QBF16(4, 6), "Scale": np.array([0.3], np.float32)}, {"max_range": 15.0}, ["Out"],
     0.0),
]
CASES += FAKE_QUANT_CASES
# the straight-through gradient (and OutScale's, through max |X|)
GRAD_CASES += [(c[0],) + c[1:5] + (["X"],) for c in FAKE_QUANT_CASES
               if "bf16" not in c[0] and not c[0].startswith("fdq")]
GRAD_CASES += [("fdq_max_abs", "fake_dequantize_max_abs",
                {"X": _QF32(4, 6) * 40, "Scale": np.array([0.3], np.float32)},
                {"max_range": 127.0}, ["Out"], ["X", "Scale"])]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    """Same fetches, and the same declared output shapes and dtypes (the
    build-time inference rules), in both packages."""
    _, op_type, inputs, attrs, out_slots, atol = case
    before = dict(ck.LAUNCHES)
    j_decl, t_decl = {}, {}
    want = _run(jfluid, op_type, inputs, attrs, out_slots, j_decl)
    got = _run(tfluid, op_type, inputs, attrs, out_slots, t_decl)
    assert ck.LAUNCHES == before
    assert t_decl == j_decl
    for (slot, _), w, g in zip(_out_names(out_slots), want, got):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)  # bfloat16 too: ml_dtypes in both
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), atol=atol, rtol=0,
                                   err_msg=f"{op_type} {slot}")


def _grads(fluid, op_type, inputs, attrs, out_slots, wrt, weights):
    """d/d(wrt inputs) of sum_k mean(out_k * weights_k) through
    `append_backward`, fetching each `in_<slot>@GRAD`."""
    prog, feed = _build(fluid, op_type, inputs, attrs, out_slots)
    names = [n for _, n in _out_names(out_slots)]
    with fluid.program_guard(prog, fluid.Program()):
        block = prog.global_block()
        parts = []
        for n, w in zip(names, weights):
            wv = block.create_var(f"w_{n}", shape=w.shape, dtype="float32", is_data=True)
            feed[wv.name] = w
            prod = fluid.layers.elementwise_mul(block.var(n), wv)
            parts.append(fluid.layers.mean(prod))
        loss = parts[0] if len(parts) == 1 else fluid.layers.sums(parts)
        grads = fluid.append_backward(loss, parameter_list=[f"in_{s}" for s in wrt])
    exe = fluid.Executor(fluid.CPUPlace())
    return exe.run(prog, feed=feed, fetch_list=[g.name for _, g in grads], scope=fluid.Scope())


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_op_gradient_matches_jax(case):
    """The gradient of each differentiable op through `append_backward`,
    against the JAX package's vjp: sum_k mean(out_k * w_k) with fixed random
    weights w_k, so a permuted or misplaced gradient shows; within
    1e-5 * (1 + max|ref|) in float32."""
    _, op_type, inputs, attrs, out_slots, wrt = case
    outs = _run(jfluid, op_type, inputs, attrs, out_slots)
    wr = np.random.RandomState(1)
    weights = [np.asarray(wr.randn(*np.shape(o)), np.float32) for o in outs]
    want = _grads(jfluid, op_type, inputs, attrs, out_slots, wrt, weights)
    got = _grads(tfluid, op_type, inputs, attrs, out_slots, wrt, weights)
    for slot, w, g in zip(wrt, want, got):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=0,
                                   atol=1e-5 * (1 + np.abs(w).max()), err_msg=f"{op_type} {slot}")


def test_long_attention_takes_plain_path_on_cpu():
    """Beyond 1024 positions, the old whole-row limit, the CPU runs the plain
    attention, as at every length (on the card the flash kernels take it):
    the fused_attention op at Lq = Lk = 1100 against the JAX composite, full
    at dh 4 and causal at dh 8."""
    q = F32(1, 1, 1100, 4)
    want = _run(jfluid, "fused_attention", {"Q": q, "K": q, "V": q}, {}, ["Out"])[0]
    got = _run(tfluid, "fused_attention", {"Q": q, "K": q, "V": q}, {}, ["Out"])[0]
    np.testing.assert_allclose(got, want, atol=1e-5)
    qkv = {n: F32(1, 2, 1100, 8) for n in ("Q", "K", "V")}
    want = _run(jfluid, "fused_attention", qkv, {"causal": True}, ["Out"])[0]
    got = _run(tfluid, "fused_attention", qkv, {"causal": True}, ["Out"])[0]
    assert got.shape == (1, 2, 1100, 8)
    np.testing.assert_allclose(got, want, atol=1e-5)


# the standard normal truncated to [-2, 2] has std 0.8796
@pytest.mark.parametrize("op_type,attrs,mean,std", [
    ("gaussian_random", {"mean": 1.0, "std": 2.0}, 1.0, 2.0),
    ("uniform_random", {"min": -1.0, "max": 3.0}, 1.0, 4.0 / np.sqrt(12.0)),
    ("truncated_gaussian_random", {"mean": 1.0, "std": 2.0}, 1.0, 2.0 * 0.87962566),
])
def test_random_ops_by_moments(op_type, attrs, mean, std):
    attrs = dict(attrs, shape=[400, 250], dtype="float32")
    for fluid in (jfluid, tfluid):
        out = _run(fluid, op_type, {}, attrs, ["Out"])[0]
        assert out.shape == (400, 250)
        assert abs(out.mean() - mean) < 0.02 * std * 5
        assert abs(out.std() - std) < 0.02 * std
    pinned = dict(attrs, seed=7)
    a = _run(tfluid, op_type, {}, pinned, ["Out"])[0]
    b = _run(tfluid, op_type, {}, pinned, ["Out"])[0]
    np.testing.assert_array_equal(a, b)


def test_training_mode_dropout_is_not_ported():
    """The name dates from when training-mode dropout was refused; it is
    ported now.  The two packages' random streams differ; the kept share and
    the upscaled values agree."""
    x = np.ones((300, 200), np.float32)
    attrs = {"is_test": False, "dropout_prob": 0.25, "dropout_implementation": "upscale_in_train"}
    for fluid in (jfluid, tfluid):
        out, mask = _run(fluid, "dropout", {"X": x}, attrs, ["Out", "Mask"])
        assert abs(mask.mean() - 0.75) < 0.01
        np.testing.assert_allclose(out, mask / 0.75, rtol=1e-6)


def test_unknown_op_names_close_matches():
    """The executor's verifier (FLAGS_verify_program, on by default) refuses
    an op without a lowering before the program runs, naming close matches,
    with the JAX package's error class; with the verifier off the lowering
    lookup itself names them."""
    from paddle_tpu.core.analysis import ProgramVerificationError as JError
    from paddle_tpu_torch.core.analysis import ProgramVerificationError as TError

    with pytest.raises(JError, match="layer_norm"):
        _run(jfluid, "layer_nrom", {"X": F32(2, 2)}, {}, ["Y"])
    with pytest.raises(TError, match="layer_norm"):
        _run(tfluid, "layer_nrom", {"X": F32(2, 2)}, {}, ["Y"])
    tfluid.set_flags({"FLAGS_verify_program": "off"})
    try:
        with pytest.raises(NotImplementedError, match="layer_norm"):
            _run(tfluid, "layer_nrom", {"X": F32(2, 2)}, {}, ["Y"])
    finally:
        tfluid.set_flags({"FLAGS_verify_program": "structural"})


def test_xshape_is_built_only_when_read():
    from paddle_tpu_torch.core.lowering import LoweringContext, lower_one

    prog = tfluid.Program()
    op = prog.global_block().append_op("reshape2", inputs={"X": ["x"]},
                                       outputs={"Out": ["y"], "XShape": ["xs"]},
                                       attrs={"shape": [-1]})
    gen = torch.Generator()
    for fetch, present in (((), False), (("xs",), True)):
        env = {"x": torch.zeros(2, 3)}
        lower_one(LoweringContext(gen, torch.device("cpu"), fetch_names=fetch), op, env)
        assert ("xs" in env) == present


def test_py_func_runs_the_callable_on_host_copies():
    """py_func (ops/control_flow_ops.py) against the JAX package's: the same
    callable registered in each package's registry runs on host copies of X
    and its outputs take the declared dtypes; backward_func is refused."""
    from paddle_tpu.ops.control_flow_ops import register_py_func as j_reg
    from paddle_tpu_torch.ops.control_flow_ops import register_py_func as t_reg

    def fn(a, b):
        return (a * 2 + b).tolist(), np.arange(a.shape[0])  # a list (float64) and int64

    x, y = H32(3, 4), H32(3, 4)
    outs = {}
    for fluid, reg in ((jfluid, j_reg), (tfluid, t_reg)):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            block = prog.global_block()
            for n in ("x", "y"):
                block.create_var(n, shape=(3, 4), dtype="float32", is_data=True)
            block.create_var("o1", shape=(3, 4), dtype="float32")
            block.create_var("o2", shape=(3,), dtype="int32")
            block.append_op("py_func", inputs={"X": ["x", "y"]}, outputs={"Out": ["o1", "o2"]},
                            attrs={"func_id": reg(fn), "out_shapes": [[3, 4], [3]],
                                   "out_dtypes": ["float32", "int32"]})
        outs[fluid] = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={"x": x, "y": y}, fetch_list=["o1", "o2"], scope=fluid.Scope())
    for w, g in zip(outs[jfluid], outs[tfluid]):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(NotImplementedError, match="backward_func"):
        tfluid.layers.py_func(fn, None, None, backward_func=fn)
