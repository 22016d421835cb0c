"""Composite network helpers (counterpart of paddle_tpu/nets.py; reference
python/paddle/fluid/nets.py): simple_img_conv_pool, img_conv_group,
sequence_conv_pool, glu and scaled_dot_product_attention."""
from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size, pool_stride,
                         pool_padding=0, pool_type="max", global_pooling=False,
                         conv_stride=1, conv_padding=0, conv_dilation=1,
                         conv_groups=1, param_attr=None, bias_attr=None,
                         act=None, use_cudnn=True):
    conv = layers.conv2d(input, num_filters=num_filters, filter_size=filter_size,
                         stride=conv_stride, padding=conv_padding,
                         dilation=conv_dilation, groups=conv_groups,
                         param_attr=param_attr, bias_attr=bias_attr, act=act)
    return layers.pool2d(conv, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """VGG-style conv block stack + one pool (reference nets.py:163)."""
    tmp = input
    for i, nf in enumerate(conv_num_filter):
        local_act = conv_act if not conv_with_batchnorm else None
        tmp = layers.conv2d(tmp, num_filters=nf, filter_size=conv_filter_size,
                            padding=conv_padding, param_attr=param_attr,
                            act=local_act)
        if conv_with_batchnorm:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate:
                tmp = layers.dropout(tmp, dropout_prob=conv_batchnorm_drop_rate)
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv = layers.sequence_conv(input, num_filters=num_filters,
                                filter_size=filter_size, param_attr=param_attr,
                                act=act)
    return layers.sequence_pool(conv, pool_type)


def glu(input, dim=-1):
    """Gated linear unit: split in half along dim, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Attention over [b, T, d] (reference nets.py:404): heads split on the
    feature dim, scaled by the PER-HEAD width, merged back after."""
    d = int(queries.shape[-1])
    if num_heads > 1:
        if d % num_heads:
            raise ValueError(f"d_model {d} not divisible by num_heads {num_heads}")
        hd = d // num_heads

        def split(x):
            b, t = x.shape[0], x.shape[1]
            x = layers.reshape(x, [0, 0, num_heads, hd])
            return layers.transpose(x, [0, 2, 1, 3])  # [b, H, T, hd]

        queries, keys, values = split(queries), split(keys), split(values)
    else:
        hd = d
    scaled_q = layers.scale(queries, scale=float(hd) ** -0.5)
    logits = layers.matmul(scaled_q, keys, transpose_y=True)
    weights = layers.softmax(logits)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    out = layers.matmul(weights, values)
    if num_heads > 1:
        out = layers.transpose(out, [0, 2, 1, 3])
        out = layers.reshape(out, [0, 0, d])
    return out
