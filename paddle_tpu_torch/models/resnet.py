"""ResNet (counterpart of paddle_tpu/models/resnet.py): conv_bn_layer /
shortcut / bottleneck or basic blocks, ResNet-50 = bottlenecks [3, 4, 6, 3].

`build` emits the same program as the JAX package's builder (same ops,
names and attrs under the same unique-name guard).  dtype="bfloat16" casts
the input to bf16 (master weights stay float32, the loss float32); the
space-to-depth stem is NCHW only.  The builder records NHWC as the JAX
package does, but the port's lowerings run NCHW only (ROADMAP A3).
"""
from __future__ import annotations

from .. import layers, optimizer
from ..core.program import Program, program_guard


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu", is_test=False,
                  data_format="NCHW"):
    conv = layers.conv2d(input, num_filters=ch_out, filter_size=filter_size, stride=stride,
                         padding=padding, bias_attr=False, data_format=data_format)
    return layers.batch_norm(conv, act=act, is_test=is_test, data_layout=data_format)


def shortcut(input, ch_out, stride, is_test=False, data_format="NCHW"):
    ch_in = input.shape[1] if data_format == "NCHW" else input.shape[3]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None, is_test=is_test,
                             data_format=data_format)
    return input


def bottleneck(input, ch_out, stride, is_test=False, data_format="NCHW"):
    short = shortcut(input, ch_out * 4, stride, is_test=is_test, data_format=data_format)
    conv1 = conv_bn_layer(input, ch_out, 1, 1, 0, is_test=is_test, data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, stride, 1, is_test=is_test, data_format=data_format)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None, is_test=is_test,
                          data_format=data_format)
    return layers.elementwise_add(short, conv3, act="relu")


def basicblock(input, ch_out, stride, is_test=False, data_format="NCHW"):
    short = shortcut(input, ch_out, stride, is_test=is_test, data_format=data_format)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test, data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test,
                          data_format=data_format)
    return layers.elementwise_add(short, conv2, act="relu")


def layer_warp(block_fn, input, ch_out, count, stride, is_test=False, data_format="NCHW"):
    res = block_fn(input, ch_out, stride, is_test=is_test, data_format=data_format)
    for _ in range(1, count):
        res = block_fn(res, ch_out, 1, is_test=is_test, data_format=data_format)
    return res


_DEPTH = {
    18: (basicblock, [2, 2, 2, 2]),
    34: (basicblock, [3, 4, 6, 3]),
    50: (bottleneck, [3, 4, 6, 3]),
    101: (bottleneck, [3, 4, 23, 3]),
    152: (bottleneck, [3, 8, 36, 3]),
}


def _s2d_stem(input, is_test=False):
    """Space-to-depth stem (NCHW): 224^2 x 3 -> 112^2 x 12 by reshape and
    transpose (channel = c*4 + dy*2 + dx), then a 4x4 stride-1 conv with the
    asymmetric padding [2, 1, 2, 1], which gives the 112^2 output positions
    of the 7x7 stride-2 stem."""
    b, c, h, w = input.shape
    x6 = layers.reshape(input, [-1, c, h // 2, 2, w // 2, 2])   # b c j dy i dx
    x6 = layers.transpose(x6, [0, 1, 3, 5, 2, 4])               # b c dy dx j i
    s2d = layers.reshape(x6, [-1, c * 4, h // 2, w // 2])
    conv = layers.conv2d(s2d, num_filters=64, filter_size=4, stride=1,
                         padding=[2, 1, 2, 1], bias_attr=False)
    return layers.batch_norm(conv, act="relu", is_test=is_test)


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False, data_format="NCHW",
                    stem="conv7"):
    block_fn, stages = _DEPTH[depth]
    if stem == "space_to_depth":
        if data_format != "NCHW":
            raise ValueError("space_to_depth stem is NCHW-only")
        conv = _s2d_stem(input, is_test=is_test)
    else:
        conv = conv_bn_layer(input, 64, 7, 2, 3, is_test=is_test, data_format=data_format)
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max",
                         data_format=data_format)
    res = pool
    for i, count in enumerate(stages):
        res = layer_warp(block_fn, res, 64 * (2 ** i), count, 1 if i == 0 else 2,
                         is_test=is_test, data_format=data_format)
    pool2 = layers.pool2d(res, pool_type="avg", global_pooling=True, data_format=data_format)
    flat_ch = pool2.shape[1] if data_format == "NCHW" else pool2.shape[3]
    flat = layers.reshape(pool2, [-1, int(flat_ch)])
    return layers.fc(flat, size=class_dim)


def build(depth=50, class_dim=1000, image_shape=None, learning_rate=0.1,
          momentum=0.9, with_optimizer=True, dtype="float32", is_test=False,
          data_format="NCHW", stem="conv7"):
    """Returns (main, startup, feeds, fetches) for ImageNet-style training
    with Momentum(learning_rate, momentum).minimize(loss)."""
    if image_shape is None:
        image_shape = (3, 224, 224) if data_format == "NCHW" else (224, 224, 3)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", list(image_shape), dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        net_in = layers.cast(img, dtype) if dtype != "float32" else img
        logits = resnet_imagenet(net_in, class_dim=class_dim, depth=depth, is_test=is_test,
                                 data_format=data_format, stem=stem)
        logits = layers.cast(logits, "float32") if dtype != "float32" else logits
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        if with_optimizer:
            optimizer.Momentum(learning_rate=learning_rate, momentum=momentum).minimize(loss)
    return main, startup, {"img": img, "label": label}, {"loss": loss, "acc": acc, "logits": logits}
