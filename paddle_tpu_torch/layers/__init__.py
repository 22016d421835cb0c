"""fluid.layers-compatible namespace: the builders of the ported slices."""
from .control_flow import While, increment, less_than  # noqa: F401
from .io import data  # noqa: F401
from .learning_rate_scheduler import noam_decay  # noqa: F401
from .metric import accuracy  # noqa: F401
from .nn import (  # noqa: F401
    batch_norm,
    clip,
    clip_by_norm,
    conv2d,
    cross_entropy,
    dropout,
    elementwise_add,
    elementwise_div,
    elementwise_max,
    elementwise_min,
    elementwise_mul,
    elementwise_sub,
    embedding,
    fc,
    fused_attention,
    gelu,
    label_smooth,
    layer_norm,
    matmul,
    mean,
    mul,
    one_hot,
    pool2d,
    pow,
    reduce_sum,
    relu,
    reshape,
    scale,
    sigmoid,
    sigmoid_cross_entropy_with_logits,
    softmax,
    softmax_with_cross_entropy,
    sqrt,
    square,
    square_error_cost,
    topk,
    transpose,
)
from .misc import beam_search, beam_search_decode, expand, key_padding_bias, logical_and  # noqa: F401
from .sequence import attention_bias, position_encoding, sequence_mask, sequence_pool  # noqa: F401
from .tail import gaussian_random, sign, uniform_random  # noqa: F401
from .tensor import assign, cast, fill_constant, sums  # noqa: F401
