"""Metric layers (counterpart of paddle_tpu/layers/metric.py): `accuracy`,
`mean_iou` and `auc`."""
from __future__ import annotations

from ..core.initializer import ConstantInitializer
from ..core.layer_helper import LayerHelper
from ..core.param_attr import ParamAttr
from . import nn


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy: the `top_k` of `input`, then the `accuracy` op."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = nn.topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32", shape=(1,))
    if correct is None:
        correct = helper.create_variable_for_type_inference("int32", shape=(1,))
    if total is None:
        total = helper.create_variable_for_type_inference("int32", shape=(1,))
    helper.append_op(
        "accuracy",
        inputs={"Out": [topk_out.name], "Indices": [topk_indices.name], "Label": [label.name]},
        outputs={"Accuracy": [acc_out.name], "Correct": [correct.name], "Total": [total.name]},
    )
    return acc_out


def mean_iou(input, label, num_classes):
    """Mean Intersection-over-Union (reference metric_op.py mean_iou /
    operators/metrics/mean_iou_op).  Returns (mean_iou [1], out_wrong [C],
    out_correct [C])."""
    helper = LayerHelper("mean_iou")
    iou = helper.create_variable_for_type_inference("float32", shape=(1,))
    wrong = helper.create_variable_for_type_inference("int32", shape=(num_classes,))
    correct = helper.create_variable_for_type_inference("int32", shape=(num_classes,))
    helper.append_op(
        "mean_iou",
        inputs={"Predictions": [input.name], "Labels": [label.name]},
        outputs={"OutMeanIou": [iou.name], "OutWrong": [wrong.name],
                 "OutCorrect": [correct.name]},
        attrs={"num_classes": num_classes},
    )
    return iou, wrong, correct


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    """Streaming ROC-AUC (reference metric_op.py auc / operators/metrics/
    auc_op.cc): persistable positive/negative histograms bucketed by
    predicted probability accumulate across batches; AUC is the trapezoid
    integral over thresholds.  Returns (auc_out, [batch stats unsupported —
    single global accumulator, the reference's slide_steps=0 mode])."""
    if curve != "ROC":
        raise NotImplementedError("auc: only curve='ROC'")
    helper = LayerHelper("auc")
    stat_pos = helper.create_parameter(
        ParamAttr(name=helper.name + ".stat_pos", trainable=False,
                  initializer=ConstantInitializer(0.0)),
        [num_thresholds + 1], "int64")
    stat_neg = helper.create_parameter(
        ParamAttr(name=helper.name + ".stat_neg", trainable=False,
                  initializer=ConstantInitializer(0.0)),
        [num_thresholds + 1], "int64")
    stat_pos.stop_gradient = True
    stat_neg.stop_gradient = True
    auc_out = helper.create_variable_for_type_inference("float32", shape=(1,))
    helper.append_op(
        "auc",
        inputs={"Predict": [input.name], "Label": [label.name],
                "StatPos": [stat_pos.name], "StatNeg": [stat_neg.name]},
        outputs={"AUC": [auc_out.name], "StatPosOut": [stat_pos.name],
                 "StatNegOut": [stat_neg.name]},
        attrs={"num_thresholds": num_thresholds},
    )
    return auc_out
