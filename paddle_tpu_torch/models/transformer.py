"""BERT-style encoder (counterpart of paddle_tpu/models/transformer.py).

`build_bert` emits the same program as the JAX package's builder (same
ops, names and attrs under the same unique-name guard), so a model built,
trained or saved by either package trains or serves in the other.
"""
from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..core.initializer import NormalInitializer
from ..core.param_attr import ParamAttr
from ..core.program import Program, program_guard


def _attr(name):
    return ParamAttr(name=name, initializer=NormalInitializer(0.0, 0.02))


def multi_head_attention(x, seq_len, d_model, n_heads, prefix, dropout_prob=0.1, is_test=False,
                         use_ring_attention=False, causal=False, kv=None, bias=None,
                         use_fused_attention=False, score_dtype=None):
    """Self- or cross-attention over [b, T, d]; `kv` switches to
    cross-attention, `bias` is an additive [b, 1, Tq, Tk] pre-softmax mask."""
    if use_ring_attention:
        raise NotImplementedError("ring attention is not ported yet")
    d_head = d_model // n_heads
    kv_in = kv if kv is not None else x
    q = layers.fc(x, d_model, num_flatten_dims=2, param_attr=_attr(f"{prefix}.q.w"), bias_attr=_attr(f"{prefix}.q.b"))
    k = layers.fc(kv_in, d_model, num_flatten_dims=2, param_attr=_attr(f"{prefix}.k.w"), bias_attr=_attr(f"{prefix}.k.b"))
    v = layers.fc(kv_in, d_model, num_flatten_dims=2, param_attr=_attr(f"{prefix}.v.w"), bias_attr=_attr(f"{prefix}.v.b"))

    def split_heads(t):
        t = layers.reshape(t, [0, 0, n_heads, d_head])
        return layers.transpose(t, [0, 2, 1, 3])  # (B, H, L, dh)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if use_fused_attention:
        # attention-prob dropout cannot run inside the fused kernel; the
        # equivalent regularization goes on the attention output
        ctx = layers.fused_attention(q, k, v, bias=bias, causal=causal, score_dtype=score_dtype)
        if dropout_prob and not is_test:
            ctx = layers.dropout(ctx, dropout_prob, is_test=is_test,
                                 dropout_implementation="upscale_in_train")
    else:
        scores = layers.matmul(q, k, transpose_y=True, alpha=1.0 / np.sqrt(d_head))
        if bias is not None:
            scores = layers.elementwise_add(scores, bias)
        attn = layers.softmax(scores)
        if dropout_prob and not is_test:
            attn = layers.dropout(attn, dropout_prob, is_test=is_test,
                                  dropout_implementation="upscale_in_train")
        ctx = layers.matmul(attn, v)  # (B, H, L, dh)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, d_model])
    return layers.fc(ctx, d_model, num_flatten_dims=2,
                     param_attr=_attr(f"{prefix}.out.w"), bias_attr=_attr(f"{prefix}.out.b"))


def encoder_layer(x, seq_len, d_model, n_heads, d_ff, prefix, dropout_prob=0.1, is_test=False,
                  use_ring_attention=False, causal=False, use_fused_attention=False,
                  score_dtype=None):
    attn_out = multi_head_attention(x, seq_len, d_model, n_heads, f"{prefix}.attn",
                                    dropout_prob, is_test, use_ring_attention, causal,
                                    use_fused_attention=use_fused_attention,
                                    score_dtype=score_dtype)
    x = layers.layer_norm(layers.elementwise_add(x, attn_out), begin_norm_axis=2,
                          param_attr=_attr(f"{prefix}.ln1.w"), bias_attr=_attr(f"{prefix}.ln1.b"))
    ffn1 = layers.fc(x, d_ff, num_flatten_dims=2, act="gelu",
                     param_attr=_attr(f"{prefix}.ffn1.w"), bias_attr=_attr(f"{prefix}.ffn1.b"))
    ffn2 = layers.fc(ffn1, d_model, num_flatten_dims=2,
                     param_attr=_attr(f"{prefix}.ffn2.w"), bias_attr=_attr(f"{prefix}.ffn2.b"))
    if dropout_prob and not is_test:
        ffn2 = layers.dropout(ffn2, dropout_prob, is_test=is_test,
                              dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, ffn2), begin_norm_axis=2,
                             param_attr=_attr(f"{prefix}.ln2.w"), bias_attr=_attr(f"{prefix}.ln2.b"))


def build_bert(
    vocab_size=30522,
    seq_len=128,
    d_model=768,
    n_layers=12,
    n_heads=12,
    d_ff=3072,
    dropout_prob=0.1,
    learning_rate=1e-4,
    with_optimizer=True,
    is_test=False,
    use_ring_attention=False,
    causal=False,
    use_fused_attention=False,
    dtype="float32",
    attention_score_dtype=None,
):
    """BERT-base-style masked-LM pretraining program.

    feeds: ids (B,L) int64, labels (B,L) int64 (-100 = ignored), pos_ids (B,L).
    dtype="bfloat16" runs the encoder and LM head in bf16 with float32
    master weights; LayerNorm statistics and the loss stay float32.
    with_optimizer=True appends Adam(learning_rate).minimize(loss).
    Returns (main, startup, feeds {name: Variable}, fetches {"loss": Variable})."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        ids = layers.data("ids", [seq_len], dtype="int64")
        labels = layers.data("labels", [seq_len], dtype="int64")
        tok = layers.embedding(ids, size=[vocab_size, d_model], param_attr=_attr("bert.tok_emb"))
        pos_ids = layers.data("pos_ids", [seq_len], dtype="int64")
        pos = layers.embedding(pos_ids, size=[seq_len, d_model], param_attr=_attr("bert.pos_emb"))
        x = layers.elementwise_add(tok, pos)
        x = layers.layer_norm(x, begin_norm_axis=2, param_attr=_attr("bert.emb_ln.w"),
                              bias_attr=_attr("bert.emb_ln.b"))
        if dtype != "float32":
            x = layers.cast(x, dtype)
        for i in range(n_layers):
            x = encoder_layer(x, seq_len, d_model, n_heads, d_ff, f"bert.l{i}",
                              dropout_prob, is_test, use_ring_attention, causal,
                              use_fused_attention=use_fused_attention,
                              score_dtype=attention_score_dtype)
        logits = layers.fc(x, vocab_size, num_flatten_dims=2,
                           param_attr=_attr("bert.lm_head.w"), bias_attr=_attr("bert.lm_head.b"))
        flat_logits = layers.reshape(logits, [-1, vocab_size])
        flat_labels = layers.reshape(labels, [-1, 1])
        loss_per = layers.softmax_with_cross_entropy(flat_logits, flat_labels, ignore_index=-100)
        loss = layers.mean(loss_per)
        if with_optimizer:
            optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    return main, startup, {"ids": ids, "labels": labels, "pos_ids": pos_ids}, {"loss": loss}


def make_fake_batch(batch_size, seq_len, vocab_size, rng=None, mask_frac=0.15):
    rng = rng or np.random.RandomState(0)
    ids = rng.randint(0, vocab_size, size=(batch_size, seq_len))
    labels = np.where(rng.rand(batch_size, seq_len) < mask_frac, ids, -100)
    pos = np.tile(np.arange(seq_len), (batch_size, 1))
    return {"ids": ids, "labels": labels, "pos_ids": pos}
