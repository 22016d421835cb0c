"""fluid.layers-compatible namespace: the builders of the ported slices."""
from .control_flow import While, increment, less_than  # noqa: F401
from .io import data  # noqa: F401
from .learning_rate_scheduler import noam_decay  # noqa: F401
from .metric import accuracy  # noqa: F401
from .nn import (  # noqa: F401
    batch_norm,
    conv2d,
    dropout,
    elementwise_add,
    elementwise_div,
    elementwise_min,
    embedding,
    fc,
    fused_attention,
    label_smooth,
    layer_norm,
    matmul,
    mean,
    one_hot,
    pool2d,
    pow,
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
from .misc import beam_search, beam_search_decode, expand, key_padding_bias, logical_and  # noqa: F401
from .sequence import attention_bias, position_encoding, sequence_mask, sequence_pool  # noqa: F401
from .tensor import assign, cast  # noqa: F401
