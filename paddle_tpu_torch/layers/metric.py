"""Metric layers (counterpart of paddle_tpu/layers/metric.py): `accuracy`."""
from __future__ import annotations

from ..core.layer_helper import LayerHelper
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
