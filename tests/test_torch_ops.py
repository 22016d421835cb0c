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
from paddle_tpu_torch.ops import cuda_kernels as ck


def _run(fluid, op_type, inputs, attrs, out_slots):
    """Build {slot: array or [arrays]} -> one op -> fetch out_slots, on the CPU.  The
    output vars take attrs' `out_dtype`, or per slot `out_dtypes` (not an
    attr of the op)."""
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
                block.create_var(name, shape=arr.shape, dtype=j_canon(arr.dtype), is_data=True)
                feed[name] = arr
                in_io[slot].append(name)
        out_io = {}
        for slot in out_slots:
            block.create_var(f"out_{slot}",
                             dtype=out_dtypes.get(slot, attrs.get("out_dtype", "float32")))
            out_io[slot] = [f"out_{slot}"]
        block.append_op(op_type, inputs=in_io, outputs=out_io, attrs=dict(attrs))
    exe = fluid.Executor(fluid.CPUPlace())
    return exe.run(prog, feed=feed, fetch_list=[f"out_{s}" for s in out_slots], scope=fluid.Scope())


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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op_type, inputs, attrs, out_slots, atol = case
    before = dict(ck.LAUNCHES)
    want = _run(jfluid, op_type, inputs, attrs, out_slots)
    got = _run(tfluid, op_type, inputs, attrs, out_slots)
    assert ck.LAUNCHES == before
    for slot, w, g in zip(out_slots, want, got):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)  # bfloat16 too: ml_dtypes in both
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), atol=atol, rtol=0,
                                   err_msg=f"{op_type} {slot}")


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


@pytest.mark.parametrize("op_type,attrs,mean,std", [
    ("gaussian_random", {"mean": 1.0, "std": 2.0}, 1.0, 2.0),
    ("uniform_random", {"min": -1.0, "max": 3.0}, 1.0, 4.0 / np.sqrt(12.0)),
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
