"""fluid.layers-compatible namespace: the builders of the ported slices."""
from .io import data  # noqa: F401
from .metric import accuracy  # noqa: F401
from .nn import (  # noqa: F401
    batch_norm,
    conv2d,
    dropout,
    elementwise_add,
    embedding,
    fc,
    fused_attention,
    layer_norm,
    matmul,
    mean,
    pool2d,
    reduce_sum,
    reshape,
    scale,
    sigmoid,
    sigmoid_cross_entropy_with_logits,
    softmax,
    softmax_with_cross_entropy,
    square,
    topk,
    transpose,
)
from .tensor import cast  # noqa: F401
