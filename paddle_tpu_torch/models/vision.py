"""The fluid_benchmark model builders (counterpart of
paddle_tpu/models/vision.py): VGG-16, SE-ResNeXt-50, the stacked dynamic
LSTM (reference benchmark/fluid/models/{vgg,se_resnext,
stacked_dynamic_lstm}.py, the fluid_benchmark model list), the word2vec
N-gram model (book/test_word2vec.py) with a softmax, NCE or hierarchical
sigmoid head, and a CRF sequence tagger scored by chunk_eval."""
from __future__ import annotations

from .. import layers, nets, optimizer
from ..core.param_attr import ParamAttr
from ..core.program import Program, program_guard


# --- VGG-16 (benchmark/fluid/models/vgg.py) ---------------------------------

def vgg16(input, class_dim=1000, is_test=False):
    def block(x, nf, n):
        return nets.img_conv_group(
            x, conv_num_filter=[nf] * n, pool_size=2, conv_padding=1,
            conv_filter_size=3, conv_act="relu", conv_with_batchnorm=True,
            pool_stride=2, pool_type="max")

    x = block(input, 64, 2)
    x = block(x, 128, 2)
    x = block(x, 256, 3)
    x = block(x, 512, 3)
    x = block(x, 512, 3)
    flat_dim = 512 * (input.shape[2] // 32) * (input.shape[3] // 32)
    x = layers.reshape(x, [-1, int(flat_dim)])
    x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    x = layers.fc(x, 512, act=None)
    x = layers.batch_norm(x, act="relu", is_test=is_test)
    x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    x = layers.fc(x, 512, act=None)
    return layers.fc(x, class_dim)


def build_vgg(class_dim=10, image_shape=(3, 32, 32), learning_rate=0.01,
              with_optimizer=True, is_test=False):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", list(image_shape), dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        logits = vgg16(img, class_dim=class_dim, is_test=is_test)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        if with_optimizer:
            optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    return main, startup, {"img": img, "label": label}, {"loss": loss, "acc": acc}


# --- SE-ResNeXt-50 (benchmark/fluid/models/se_resnext.py) -------------------

def _squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = layers.pool2d(input, pool_type="avg", global_pooling=True)
    pool = layers.reshape(pool, [-1, num_channels])
    squeeze = layers.fc(pool, num_channels // reduction_ratio, act="relu")
    excitation = layers.fc(squeeze, num_channels, act="sigmoid")
    excitation = layers.reshape(excitation, [-1, num_channels, 1, 1])
    return layers.elementwise_mul(input, excitation, axis=0)


def _conv_bn(input, num_filters, filter_size, stride=1, groups=1, act=None,
             is_test=False):
    conv = layers.conv2d(input, num_filters=num_filters, filter_size=filter_size,
                         stride=stride, padding=(filter_size - 1) // 2,
                         groups=groups, bias_attr=False)
    return layers.batch_norm(conv, act=act, is_test=is_test)


def _se_bottleneck(input, num_filters, stride, cardinality=32, is_test=False):
    ch_in = input.shape[1]
    conv0 = _conv_bn(input, num_filters, 1, act="relu", is_test=is_test)
    conv1 = _conv_bn(conv0, num_filters, 3, stride=stride, groups=cardinality,
                     act="relu", is_test=is_test)
    conv2 = _conv_bn(conv1, num_filters * 2, 1, is_test=is_test)
    scaled = _squeeze_excitation(conv2, num_filters * 2)
    if ch_in != num_filters * 2 or stride != 1:
        short = _conv_bn(input, num_filters * 2, 1, stride=stride, is_test=is_test)
    else:
        short = input
    return layers.elementwise_add(short, scaled, act="relu")


def se_resnext50(input, class_dim=1000, is_test=False):
    x = _conv_bn(input, 64, 7, stride=2, act="relu", is_test=is_test)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max")
    for filters, blocks, stride in ((128, 3, 1), (256, 4, 2), (512, 6, 2), (1024, 3, 2)):
        for i in range(blocks):
            x = _se_bottleneck(x, filters, stride if i == 0 else 1, is_test=is_test)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    flat = layers.reshape(pool, [-1, int(pool.shape[1])])
    drop = layers.dropout(flat, dropout_prob=0.2, is_test=is_test)
    return layers.fc(drop, class_dim)


def build_se_resnext(class_dim=1000, image_shape=(3, 224, 224), learning_rate=0.1,
                     with_optimizer=True, is_test=False):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", list(image_shape), dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        logits = se_resnext50(img, class_dim=class_dim, is_test=is_test)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        if with_optimizer:
            optimizer.Momentum(learning_rate=learning_rate, momentum=0.9).minimize(loss)
    return main, startup, {"img": img, "label": label}, {"loss": loss}


# --- stacked dynamic LSTM (benchmark/fluid/models/stacked_dynamic_lstm.py) --

def build_stacked_dynamic_lstm(vocab_size=5000, emb_dim=64, hidden_dim=64,
                               stacked_num=3, class_dim=2, learning_rate=0.002,
                               with_optimizer=True):
    """IMDB-style sentiment classifier: embedding -> N stacked dynamic LSTMs
    -> last-step pool -> fc (ragged inputs end to end)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        label = layers.data("label", [1], dtype="int64")
        emb = layers.embedding(words, size=[vocab_size, emb_dim])
        h = emb
        for i in range(stacked_num):
            proj = layers.fc(h, 4 * hidden_dim, num_flatten_dims=2,
                             param_attr=ParamAttr(name=f"sl{i}.proj.w"))
            h, _ = layers.dynamic_lstm(
                proj, size=4 * hidden_dim, use_peepholes=False,
                param_attr=ParamAttr(name=f"sl{i}.lstm.w"),
                bias_attr=ParamAttr(name=f"sl{i}.lstm.b"))
        last = layers.sequence_last_step(h)
        logits = layers.fc(last, class_dim)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        if with_optimizer:
            optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    return main, startup, {"words": words, "label": label}, {"loss": loss, "acc": acc}


# --- word2vec (book test: test_word2vec.py N-gram model) --------------------

def build_word2vec(dict_size=1000, embed_size=32, hidden_size=64, n=4,
                   learning_rate=0.01, with_optimizer=True, head="softmax", num_neg_samples=5,
                   custom_neg_classes=None):
    """N-gram language model: (n-1) context words -> the next word
    (reference book/test_word2vec.py network).  `head`: "softmax" (the
    builder of the JAX package), "nce" (noise-contrastive estimation with
    `num_neg_samples` uniform negatives, or `custom_neg_classes`) or
    "hsigmoid" (the hierarchical sigmoid over the default tree)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        words = [layers.data(f"w{i}", [1], dtype="int64") for i in range(n - 1)]
        target = layers.data("target", [1], dtype="int64")
        embs = [layers.embedding(w, size=[dict_size, embed_size],
                                 param_attr=ParamAttr(name="w2v_emb"))
                for w in words]
        concat = layers.concat(embs, axis=1)
        hidden = layers.fc(concat, hidden_size, act="sigmoid")
        if head == "softmax":
            cost = layers.softmax_with_cross_entropy(layers.fc(hidden, dict_size), target)
        elif head == "nce":
            cost = layers.nce(hidden, target, dict_size, num_neg_samples=num_neg_samples,
                              custom_neg_classes=custom_neg_classes)
        elif head == "hsigmoid":
            cost = layers.hsigmoid(hidden, target, dict_size)
        else:
            raise ValueError(f"build_word2vec: head {head!r} is not softmax, nce or hsigmoid")
        loss = layers.mean(cost)
        if with_optimizer:
            optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    feeds = {f"w{i}": w for i, w in enumerate(words)}
    feeds["target"] = target
    return main, startup, feeds, {"loss": loss}


def build_crf_tagger(feature_dim=16, num_chunk_types=2, learning_rate=0.05):
    """A sequence tagger (reference label_semantic_roles' tail): fc
    emissions over ragged token features, the linear-chain CRF loss trained
    by Adam, and the Viterbi path scored by chunk_eval against the labels
    (IOB tags: 2 num_chunk_types + 1).  chunk_eval counts on the host, so
    the executor captures no graph of its step."""
    num_tags = 2 * num_chunk_types + 1
    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", [feature_dim], dtype="float32", lod_level=1)
        label = layers.data("label", [1], dtype="int64", lod_level=1)
        emis = layers.fc(x, num_tags, num_flatten_dims=2)
        crf = ParamAttr(name="crfw")
        loss = layers.mean(layers.linear_chain_crf(emis, label, param_attr=crf))
        optimizer.Adam(learning_rate=learning_rate).minimize(loss)
        path = layers.crf_decoding(emis, param_attr=crf)
        from ..layers.sequence import _lod_of

        precision, recall, f1, n_infer, n_label, n_correct = layers.chunk_eval(
            path, label, "IOB", num_chunk_types, seq_info=_lod_of(x))
    return main, startup, {"x": x, "label": label}, {
        "loss": loss, "precision": precision, "recall": recall, "f1": f1,
        "num_infer": n_infer, "num_label": n_label, "num_correct": n_correct}
