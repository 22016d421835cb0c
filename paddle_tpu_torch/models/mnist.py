"""MNIST CNN (counterpart of paddle_tpu/models/mnist.py): conv-pool x2, a
fc stack, softmax cross-entropy loss, Adam."""
from __future__ import annotations

from .. import layers, optimizer
from ..core.program import Program, program_guard


def conv_pool(input, num_filters, filter_size, pool_size, pool_stride, act):
    conv = layers.conv2d(input, num_filters=num_filters, filter_size=filter_size, act=act)
    return layers.pool2d(conv, pool_size=pool_size, pool_stride=pool_stride)


def build(batch_size=None, learning_rate=1e-3, with_optimizer=True):
    """Returns (main, startup, feeds, fetches) for the LeNet-5-ish model."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", [1, 28, 28], dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        c1 = conv_pool(img, 20, 5, 2, 2, "relu")
        c2 = conv_pool(c1, 50, 5, 2, 2, "relu")
        flat = layers.reshape(c2, [-1, 50 * 4 * 4])
        hidden = layers.fc(flat, size=500, act="relu")
        logits = layers.fc(hidden, size=10)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        if with_optimizer:
            optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    return main, startup, {"img": img, "label": label}, {"loss": loss, "acc": acc, "logits": logits}
