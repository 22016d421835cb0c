"""DeepFM CTR model (counterpart of paddle_tpu/models/deepfm.py, without
its `ep` table sharding): sparse categorical fields through `is_sparse`
embedding tables into a deep MLP, plus the first-order (wide) and the
factorization-machine terms.  The tables' gradients are SelectedRows slabs
(core/selected_rows.py)."""
from __future__ import annotations

from .. import layers, optimizer
from ..core.param_attr import ParamAttr
from ..core.program import Program, program_guard


def deepfm_net(feat_ids, num_fields, vocab_size, embed_dim=8, mlp_dims=(64, 32),
               is_sparse=True):
    """feat_ids: [B, F] int64; returns (logit [B,1], prediction [B,1])."""
    # first-order (wide) term: a V x 1 table
    w_emb = layers.embedding(feat_ids, size=[vocab_size, 1], is_sparse=is_sparse,
                             param_attr=ParamAttr(name="deepfm_w"))  # [B, F, 1]
    first_order = layers.reduce_sum(w_emb, dim=[1, 2], keep_dim=False)  # [B]

    # second-order FM term over shared V x K factors
    v_emb = layers.embedding(feat_ids, size=[vocab_size, embed_dim], is_sparse=is_sparse,
                             param_attr=ParamAttr(name="deepfm_v"))  # [B, F, K]
    sum_v = layers.reduce_sum(v_emb, dim=[1])           # [B, K]
    sum_sq = layers.square(sum_v)                        # (sum v)^2
    sq_sum = layers.reduce_sum(layers.square(v_emb), dim=[1])  # sum v^2
    fm = layers.reduce_sum(sum_sq - sq_sum, dim=[1]) * 0.5     # [B]

    # deep part: the field embeddings through an MLP
    deep = layers.reshape(v_emb, [-1, num_fields * embed_dim])
    for d in mlp_dims:
        deep = layers.fc(deep, size=d, act="relu")
    deep = layers.fc(deep, size=1)                       # [B, 1]

    logit = layers.reshape(first_order + fm, [-1, 1]) + deep
    return logit, layers.sigmoid(logit)


def build(num_fields=8, vocab_size=1000, embed_dim=8, mlp_dims=(64, 32),
          learning_rate=0.05, is_sparse=True, with_optimizer=True,
          opt="adagrad"):
    """Returns (main, startup, feeds, fetches) for CTR training with a
    sigmoid cross-entropy loss; `opt` is adagrad, adam or sgd."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        feat_ids = layers.data("feat_ids", [num_fields], dtype="int64")
        label = layers.data("label", [1], dtype="float32")
        logit, pred = deepfm_net(feat_ids, num_fields, vocab_size, embed_dim,
                                 mlp_dims, is_sparse=is_sparse)
        loss = layers.mean(layers.sigmoid_cross_entropy_with_logits(logit, label))
        if with_optimizer:
            opt_cls = {"adagrad": optimizer.Adagrad, "adam": optimizer.Adam,
                       "sgd": optimizer.SGD}[opt]
            opt_cls(learning_rate=learning_rate).minimize(loss)
    return main, startup, {"feat_ids": feat_ids, "label": label}, \
        {"loss": loss, "prediction": pred}
