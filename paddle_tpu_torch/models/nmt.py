"""Transformer-base NMT on the ragged (LoD) path (counterpart of
paddle_tpu/models/nmt.py).

The builders emit the same program as the JAX package's (same ops, names
and attrs under the same unique-name guard), so a program or a state
trained by either package runs in the other.  Ragged src / tgt feed as
`LoDTensor`s; every mask and bias derives inside the program from the
lengths companions (layers.attention_bias).  Time dims are dynamic at build
time (-1), so one build serves every bucket.

`build_beam_decode` decodes with the whole beam search in the program: the
encoder once, then a `While` whose body runs the full decoder and one
`beam_search` step over static [b, k, L] state.  `beam_search_decode` is
the host-loop form of the same search over `build_nmt_infer`'s program.
"""
from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..core.program import Program, program_guard
from ..layers.nn import _keep_lod
from ..lod import LoDTensor
from .transformer import _attr, multi_head_attention


def _mha(q_in, kv_in, bias, d_model, n_heads, prefix, dropout=0.1, is_test=False):
    return multi_head_attention(q_in, None, d_model, n_heads, prefix, dropout_prob=dropout,
                                is_test=is_test, kv=None if kv_in is q_in else kv_in, bias=bias)


def _ffn(x, d_model, d_ff, prefix, dropout=0.1, is_test=False):
    h = layers.fc(x, d_ff, num_flatten_dims=2, act="relu",
                  param_attr=_attr(f"{prefix}.fc1.w"), bias_attr=_attr(f"{prefix}.fc1.b"))
    if dropout and not is_test:
        h = layers.dropout(h, dropout, is_test=is_test, dropout_implementation="upscale_in_train")
    return layers.fc(h, d_model, num_flatten_dims=2,
                     param_attr=_attr(f"{prefix}.fc2.w"), bias_attr=_attr(f"{prefix}.fc2.b"))


def _add_norm(x, y, prefix, dropout=0.1, is_test=False):
    if dropout and not is_test:
        y = layers.dropout(y, dropout, is_test=is_test, dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, y), begin_norm_axis=2,
                             param_attr=_attr(f"{prefix}.ln.w"), bias_attr=_attr(f"{prefix}.ln.b"))


def _embed(ids, vocab, d_model, prefix, dropout=0.1, is_test=False):
    # the lengths companion carries through each of these (layers.nn._keep_lod)
    emb = layers.embedding(ids, size=[vocab, d_model], param_attr=_attr(f"{prefix}.emb"))
    emb = layers.scale(emb, scale=float(d_model) ** 0.5)
    emb = layers.position_encoding(emb)
    if dropout and not is_test:
        emb = layers.dropout(emb, dropout, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return emb


def build_transformer_nmt(src_vocab=1000, tgt_vocab=1000, d_model=256, n_layers=2, n_heads=4,
                          d_ff=1024, dropout=0.1, label_smooth_eps=0.1, learning_rate=2.0,
                          warmup_steps=400, with_optimizer=True, is_test=False, dtype="float32"):
    """Returns (main, startup, feeds, fetches {"loss", "logits"}).

    Feeds: src_word, trg_word (the decoder input, <bos>-shifted) and
    lbl_word (the targets), each [b, T, 1] int64 and ragged.  The loss is
    the label-smoothed cross entropy summed over each row's valid tokens
    and divided by the batch's token count.  dtype="bfloat16" casts the
    activations once after each embedding (float32 master weights, float32
    logits for the loss).  with_optimizer appends Adam(noam_decay(d_model,
    warmup_steps, learning_rate), beta2 0.997, epsilon 1e-9).minimize(loss)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data("src_word", [1], dtype="int64", lod_level=1)
        tgt = layers.data("trg_word", [1], dtype="int64", lod_level=1)
        lbl = layers.data("lbl_word", [1], dtype="int64", lod_level=1)

        enc = _embed(src, src_vocab, d_model, "src", dropout, is_test)
        enc_bias = layers.attention_bias(enc, enc, causal=False)

        def _to_compute(v):
            return v if dtype == "float32" else _keep_lod(v, layers.cast(v, dtype))

        enc = _to_compute(enc)
        for i in range(n_layers):
            p = f"enc{i}"
            enc = _add_norm(enc, _mha(enc, enc, enc_bias, d_model, n_heads, f"{p}.attn", dropout,
                                      is_test), f"{p}.a", dropout, is_test)
            enc = _add_norm(enc, _ffn(enc, d_model, d_ff, f"{p}.ffn", dropout, is_test),
                            f"{p}.f", dropout, is_test)

        dec = _embed(tgt, tgt_vocab, d_model, "tgt", dropout, is_test)
        self_bias = layers.attention_bias(dec, dec, causal=True)
        cross_bias = layers.attention_bias(dec, enc, causal=False)
        dec = _to_compute(dec)
        for i in range(n_layers):
            p = f"dec{i}"
            dec = _add_norm(dec, _mha(dec, dec, self_bias, d_model, n_heads, f"{p}.self",
                                      dropout, is_test), f"{p}.s", dropout, is_test)
            dec = _add_norm(dec, _mha(dec, enc, cross_bias, d_model, n_heads, f"{p}.cross",
                                      dropout, is_test), f"{p}.c", dropout, is_test)
            dec = _add_norm(dec, _ffn(dec, d_model, d_ff, f"{p}.ffn", dropout, is_test),
                            f"{p}.f", dropout, is_test)

        logits = layers.fc(dec, tgt_vocab, num_flatten_dims=2,
                           param_attr=_attr("proj.w"), bias_attr=_attr("proj.b"))
        if dtype != "float32":
            logits = _keep_lod(logits, layers.cast(logits, "float32"))

        if label_smooth_eps:
            smooth = layers.label_smooth(layers.one_hot(lbl, tgt_vocab), epsilon=label_smooth_eps)
            ce = layers.softmax_with_cross_entropy(logits, smooth, soft_label=True)
        else:
            ce = layers.softmax_with_cross_entropy(logits, lbl)
        # ce carries the target side's lengths; the sum pool masks past them
        per_sent = layers.sequence_pool(ce, "sum")  # [b, 1]
        total = layers.reduce_sum(per_sent)
        ntok = layers.reduce_sum(layers.cast(tgt._lod_ref, "float32"))
        loss = layers.elementwise_div(total, ntok)

        if with_optimizer:
            lr = layers.noam_decay(d_model, warmup_steps, learning_rate)
            optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997, epsilon=1e-9).minimize(loss)

    feeds = {"src_word": src, "trg_word": tgt, "lbl_word": lbl}
    return main, startup, feeds, {"loss": loss, "logits": logits}


def make_fake_nmt_batch(lengths_src, lengths_tgt, src_vocab, tgt_vocab, seed=0):
    """A ragged batch of random ids in [1, vocab): the feed dict of LoDTensors."""
    rng = np.random.RandomState(seed)
    src = [rng.randint(1, src_vocab, (n, 1)).astype("int64") for n in lengths_src]
    tgt = [rng.randint(1, tgt_vocab, (n, 1)).astype("int64") for n in lengths_tgt]
    lbl = [rng.randint(1, tgt_vocab, (n, 1)).astype("int64") for n in lengths_tgt]
    return {"src_word": LoDTensor(src), "trg_word": LoDTensor(tgt), "lbl_word": LoDTensor(lbl)}


def build_nmt_infer(**kw):
    """The inference program (no optimizer, no dropout, no label smoothing);
    fetches logits [b, Tt, V].  beam_search_decode runs it."""
    kw.update(with_optimizer=False, is_test=True, dropout=0.0, label_smooth_eps=0.0)
    return build_transformer_nmt(**kw)


def beam_search_decode(exe, infer_program, logits_var, scope, src_rows, bos=1, eos=2,
                       beam_size=4, max_len=12, length_penalty=0.0):
    """Beam search with the bookkeeping on the host: each step runs the
    decoder program over the whole [b*k, t] prefix and extends the beams in
    numpy.  src_rows: one [Ls, 1] int64 array per batch row.  Returns
    (sequences [b, max_len] int64, scores [b]), the best beam of each row;
    beam_size=1 is greedy decoding."""
    b, k = len(src_rows), beam_size
    src_beam = [src_rows[i // k] for i in range(b * k)]  # row-major [b*k]
    seqs = np.full((b, k, max_len), eos, dtype="int64")
    seqs[:, :, 0] = bos
    scores = np.full((b, k), -1e9, dtype="float64")
    scores[:, 0] = 0.0  # only beam 0 is alive at t=0 (the beams start identical)
    finished = np.zeros((b, k), dtype=bool)

    for t in range(1, max_len):
        trg = LoDTensor([row.reshape(-1, 1) for row in seqs.reshape(b * k, max_len)[:, :t]])
        feed = {"src_word": LoDTensor(src_beam), "trg_word": trg, "lbl_word": trg}
        (logits,) = exe.run(infer_program, feed=feed, fetch_list=[logits_var], scope=scope)
        step_logits = np.asarray(logits)[:, t - 1, :].reshape(b, k, -1)
        m = step_logits.max(-1, keepdims=True)
        logp = step_logits - m - np.log(np.exp(step_logits - m).sum(-1, keepdims=True))
        V = logp.shape[-1]
        # a finished beam extends only with EOS, at no cost
        logp_f = np.full_like(logp, -1e9)
        logp_f[:, :, eos] = 0.0
        logp = np.where(finished[:, :, None], logp_f, logp)
        flat = (scores[:, :, None] + logp).reshape(b, k * V)
        top = np.argsort(-flat, axis=1, kind="stable")[:, :k]
        new_scores = np.take_along_axis(flat, top, axis=1)
        parent, token = top // V, top % V
        seqs = np.take_along_axis(seqs, parent[:, :, None], axis=1)
        seqs[:, :, t] = token
        finished = np.take_along_axis(finished, parent, axis=1) | (token == eos)
        scores = new_scores
        if finished.all():
            break

    if length_penalty:
        scores = scores / ((seqs != eos).sum(-1) ** length_penalty)
    best = np.argmax(scores, axis=1)
    rows = np.arange(b)
    return seqs[rows, best], scores[rows, best]


def build_beam_decode(src_vocab=1000, tgt_vocab=1000, d_model=256, n_layers=2, n_heads=4,
                      d_ff=1024, batch_size=4, src_len=16, beam_size=4, max_len=12, bos=1, eos=2,
                      length_penalty=0.0):
    """The whole beam-search decode as one program: the encoder once, then a
    `While` whose body runs the full decoder over the [b*k, max_len] beams
    and one `beam_search` step, until every beam has finished or max_len.

    Parameter names match build_transformer_nmt's, so its trained scope
    decodes directly (run no startup: every decode var is assigned in the
    program).  Feeds: src_word [b, src_len] int64 (0-padded), src_len_vec
    [b] int32.  Fetches: out_ids [b, max_len], out_scores [b]."""
    b, k, L, Ts = batch_size, beam_size, max_len, src_len
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data("src_word", [Ts], dtype="int64")
        src_lens = layers.data("src_len_vec", [], dtype="int32")

        mask = layers.sequence_mask(src_lens, Ts, dtype="float32")  # [b, Ts]
        enc_bias = layers.key_padding_bias(mask)                   # [b, 1, 1, Ts]
        enc = _embed(src, src_vocab, d_model, "src", 0.0, True)
        for i in range(n_layers):
            p = f"enc{i}"
            enc = _add_norm(enc, _mha(enc, enc, enc_bias, d_model, n_heads, f"{p}.attn", 0.0,
                                      True), f"{p}.a", 0.0, True)
            enc = _add_norm(enc, _ffn(enc, d_model, d_ff, f"{p}.ffn", 0.0, True), f"{p}.f",
                            0.0, True)

        # the encoder output and the cross bias repeat per beam (row-major [b*k])
        enc4 = layers.expand(layers.reshape(enc, [-1, 1, Ts, d_model]), [1, k, 1, 1])
        enc_rep = layers.reshape(enc4, [-1, Ts, d_model])                  # [bk, Ts, d]
        cb4 = layers.expand(layers.reshape(enc_bias, [-1, 1, 1, Ts]), [1, k, 1, 1])
        cross_bias = layers.reshape(cb4, [-1, 1, 1, Ts])                   # [bk, 1, 1, Ts]

        seqs0 = np.full((b, k, L), eos, dtype="int64")
        seqs0[:, :, 0] = bos
        scores0 = np.full((b, k), -1e9, dtype="float32")
        scores0[:, 0] = 0.0
        seqs = layers.assign(seqs0)
        scores = layers.assign(scores0)
        finished = layers.assign(np.zeros((b, k), dtype="bool"))
        t = layers.assign(np.asarray([1], dtype="int32"))
        max_t = layers.assign(np.asarray([L], dtype="int32"))
        bk_total = layers.assign(np.asarray([float(b * k)], dtype="float32"))
        causal = np.triu(np.full((L, L), -1e9, np.float32), k=1).reshape(1, 1, L, L)
        self_bias = layers.assign(causal)

        cond = layers.less_than(t, max_t)
        w = layers.While(cond)
        with w.block():
            trg = layers.reshape(seqs, [-1, L])                                # [bk, L]
            dec = _embed(trg, tgt_vocab, d_model, "tgt", 0.0, True)
            for i in range(n_layers):
                p = f"dec{i}"
                dec = _add_norm(dec, _mha(dec, dec, self_bias, d_model, n_heads, f"{p}.self",
                                          0.0, True), f"{p}.s", 0.0, True)
                dec = _add_norm(dec, _mha(dec, enc_rep, cross_bias, d_model, n_heads,
                                          f"{p}.cross", 0.0, True), f"{p}.c", 0.0, True)
                dec = _add_norm(dec, _ffn(dec, d_model, d_ff, f"{p}.ffn", 0.0, True),
                                f"{p}.f", 0.0, True)
            logits = layers.fc(dec, tgt_vocab, num_flatten_dims=2,
                               param_attr=_attr("proj.w"), bias_attr=_attr("proj.b"))
            layers.beam_search(logits, seqs, scores, finished, t, beam_size=k, end_id=eos)
            layers.increment(t, value=1)
            # go on while t < L and some beam is alive
            n_done = layers.reduce_sum(layers.cast(finished, "float32"))
            still_t = layers.less_than(t, max_t)
            alive = layers.less_than(layers.reshape(n_done, [1]), bk_total)
            layers.logical_and(still_t, alive, out=cond)

        out_ids, out_scores = layers.beam_search_decode(seqs, scores, end_id=eos,
                                                        length_penalty=length_penalty)

    feeds = {"src_word": src, "src_len_vec": src_lens}
    return main, startup, feeds, {"out_ids": out_ids, "out_scores": out_scores}
