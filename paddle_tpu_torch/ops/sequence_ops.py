"""Sequence (ragged) lowerings over padded batches [batch, time, *feature]
and int32 lengths [batch] (counterpart of paddle_tpu/ops/sequence_ops.py):
masks derived from the lengths take the place of the reference's walks over
offset tables.  The ops: sequence_pool, sequence_mask, attention_bias,
position_encoding, sequence_conv, sequence_softmax, sequence_expand / _as,
sequence_reverse, sequence_pad / _unpad, sequence_concat, sequence_slice,
sequence_erase, sequence_enumerate, sequence_scatter, sequence_reshape, the
recurrences dynamic_lstm, dynamic_lstmp, dynamic_gru and cudnn_lstm, the
one-step gru_unit and lstm_unit, the losses warpctc and linear_chain_crf,
crf_decoding, and dynamic_rnn (DynamicRNN / StaticRNN), whose sub-block
runs once a time step.

Every recurrence is a Python loop over the padded time axis in which rows
past their length freeze their state and emit 0: nothing is read on the
host, so a plan that holds one replays as one CUDA graph.  Where the JAX
package scans in reverse it flips the sequence; here the loop runs t
downwards, which is the same arithmetic."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import canon_dtype, first

NEG_INF_BIAS = -1e9


def _mask(lens, T, extra_dims=0):
    """[b, T] + `extra_dims` trailing singleton axes; True where t < len."""
    m = torch.arange(T, device=lens.device)[None, :] < lens[:, None]
    return m.reshape(tuple(m.shape) + (1,) * extra_dims)


@register_op("sequence_pool")
def _sequence_pool(ctx, op, ins):
    x = first(ins, "X")  # [b, T, *f]
    lens = first(ins, "XLod")
    ptype = op.attr("pooltype", "AVERAGE").upper()
    T = x.shape[1]
    m = _mask(lens, T, x.dim() - 2)
    lensf = torch.clamp_min(lens, 1).to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 2))
    masked_sum = torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum(1)
    if ptype == "SUM":
        return {"Out": masked_sum}
    if ptype == "AVERAGE":
        return {"Out": masked_sum / lensf}
    if ptype == "SQRT":
        return {"Out": masked_sum / torch.sqrt(lensf)}
    if ptype == "MAX":
        low = torch.finfo(x.dtype).min if x.is_floating_point() else torch.iinfo(x.dtype).min
        vals, idx = torch.where(m, x, torch.full((), low, dtype=x.dtype, device=x.device)).max(1)
        return {"Out": vals, "MaxIndex": idx.to(torch.int32)}
    if ptype == "LAST":
        idx = torch.clamp_min(lens.long() - 1, 0).reshape((-1, 1) + (1,) * (x.dim() - 2))
        return {"Out": torch.take_along_dim(x, idx.expand((x.shape[0], 1) + x.shape[2:]), 1)[:, 0]}
    if ptype == "FIRST":
        return {"Out": x[:, 0]}
    raise NotImplementedError(f"sequence_pool pooltype {ptype}")


@register_op("sequence_mask")
def _sequence_mask(ctx, op, ins):
    lens = first(ins, "X").reshape(-1)
    m = torch.arange(int(op.attr("maxlen")), device=lens.device)[None, :] < lens[:, None]
    return {"Y": m.to(canon_dtype(op.attr("out_dtype", "int64")))}


@register_op("attention_bias")
def _attention_bias(ctx, op, ins):
    """Additive attention bias [b, 1, Tq, Tk], float32, from the key side's
    lengths (and the causal triangle): 0 where a query may attend, -1e9
    where it may not (a padded key that is also in the future clamps to
    -1e9, as in the JAX package)."""
    q = first(ins, "Q")  # the shapes' source only
    k = first(ins, "K")
    klens = first(ins, "KLod")
    b, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
    neg = torch.full((), NEG_INF_BIAS, dtype=torch.float32, device=klens.device)
    zero = torch.zeros((), dtype=torch.float32, device=klens.device)
    m = torch.arange(Tk, device=klens.device)[None, :] < klens[:, None]  # [b, Tk]
    bias = torch.where(m, zero, neg)[:, None, None, :].expand(b, 1, Tq, Tk)
    if op.attr("causal", False):
        tri = (torch.arange(Tq, device=klens.device)[:, None]
               >= torch.arange(Tk, device=klens.device)[None, :])
        bias = bias + torch.where(tri, zero, neg)[None, None]
    return {"Out": torch.maximum(bias, neg)}


@register_op("position_encoding")
def _position_encoding(ctx, op, ins):
    """x + the sinusoid table [1, T, d] (sin over the first half of d, cos
    over the second), computed in float32 and added in x's dtype."""
    x = first(ins, "X")  # [b, T, d]
    T, d = x.shape[1], x.shape[2]
    pos = torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=x.device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * i / d)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    if pe.shape[-1] < d:  # odd d
        pe = torch.nn.functional.pad(pe, (0, d - pe.shape[-1]))
    return {"Out": x + pe[None].to(x.dtype)}


@register_op("sequence_conv")
def _sequence_conv(ctx, op, ins):
    """Context-window projection (reference sequence_conv_op.cc): for each
    step t, x[t+start : t+start+length] concatenated (zero outside the
    row's length) times Filter [length * d, num_filters]; padded steps
    give 0."""
    x = first(ins, "X")  # [b, T, d]
    lens = first(ins, "XLod")
    w = first(ins, "Filter")
    length = op.attr("contextLength", 3)
    start = op.attr("contextStart", None)
    if start is None:  # the reference layer's -(filter_size // 2)
        start = -(length // 2)
    T = x.shape[1]
    m = _mask(lens, T, 1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xz = torch.where(m, x, zero)
    t = torch.arange(T, device=x.device)
    cols = []
    for k in range(length):
        idx = t + (start + k)
        g = xz[:, idx.clamp(0, T - 1), :]
        valid = (idx[None, :] >= 0) & (idx[None, :] < lens[:, None])
        cols.append(torch.where(valid[:, :, None], g, zero))
    out = torch.cat(cols, dim=-1) @ w.to(x.dtype)
    return {"Out": torch.where(m, out, zero)}


def _steps(T, is_reverse):
    return range(T - 1, -1, -1) if is_reverse else range(T)


def _lstm(x, lens, w, bias, use_peepholes, is_reverse, h0=None, c0=None, w_proj=None,
          proj_act=None):
    """The LSTM time loop of the JAX package's _lstm_scan: gate blocks
    {c, i, f, o}, peepholes {W_ic, W_fc, W_oc} in the bias tail, and past
    each row's length the memories freeze and the outputs are 0.  With
    `w_proj` (lstmp) the recurrent state is proj_act(h @ w_proj).  A Python
    loop over the padded time axis: no host read, so a plan that holds it
    can be captured as a CUDA graph."""
    D = w_proj.shape[0] if w_proj is not None else w.shape[0]
    rdim = w_proj.shape[1] if w_proj is not None else D
    b, T = x.shape[0], x.shape[1]
    bias = bias.reshape(-1)
    gate_bias = bias[:4 * D]
    if use_peepholes:
        w_ic, w_fc, w_oc = bias[4 * D:5 * D], bias[5 * D:6 * D], bias[6 * D:7 * D]
    h = h0 if h0 is not None else torch.zeros((b, rdim), dtype=x.dtype, device=x.device)
    c = c0 if c0 is not None else torch.zeros((b, D), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    hs, cs = [None] * T, [None] * T
    for t in _steps(T, is_reverse):
        gates = x[:, t] + h @ w + gate_bias
        gc, gi, gf, go = gates[:, :D], gates[:, D:2 * D], gates[:, 2 * D:3 * D], gates[:, 3 * D:]
        if use_peepholes:
            gi = gi + w_ic * c
            gf = gf + w_fc * c
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gc)
        if use_peepholes:
            go = go + w_oc * c_new
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        if w_proj is not None:
            h_new = h_new @ w_proj
            if proj_act is not None:
                h_new = proj_act(h_new)
        active = (lens > t).reshape(b, 1)
        h = torch.where(active, h_new, h)
        c = torch.where(active, c_new, c)
        hs[t] = torch.where(active, h, zero)
        cs[t] = torch.where(active, c, zero)
    return torch.stack(hs, 1), torch.stack(cs, 1)


@register_op("dynamic_lstm")
def _dynamic_lstm(ctx, op, ins):
    """Fused LSTM over the padded time axis (reference lstm_op.cc):
    Input [b, T, 4D] already projected, Weight [D, 4D], Bias [1, 4D] or
    with peepholes [1, 7D], optional H0 / C0 [b, D]."""
    hs, cs = _lstm(first(ins, "Input"), first(ins, "XLod"), first(ins, "Weight"),
                   first(ins, "Bias"), op.attr("use_peepholes", True),
                   op.attr("is_reverse", False), first(ins, "H0"), first(ins, "C0"))
    return {"Hidden": hs, "Cell": cs}


@register_op("dynamic_lstmp")
def _dynamic_lstmp(ctx, op, ins):
    """Projection LSTM: Weight [P, 4D], ProjWeight [D, P]; the recurrent
    state is proj_activation(h @ ProjWeight) (tanh by default)."""
    proj_act = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "relu": torch.relu,
                "identity": None}[op.attr("proj_activation", "tanh")]
    rs, cs = _lstm(first(ins, "Input"), first(ins, "XLod"), first(ins, "Weight"),
                   first(ins, "Bias"), op.attr("use_peepholes", True), op.attr("is_reverse", False),
                   w_proj=first(ins, "ProjWeight"), proj_act=proj_act)
    return {"Projection": rs, "Cell": cs}


@register_op("dynamic_gru")
def _dynamic_gru(ctx, op, ins):
    """GRU over the padded time axis: Input [b, T, 3D] projected, Weight
    [D, 3D] with the update and reset gates in [:, :2D] and the candidate in
    [:, 2D:], Bias [1, 3D]; h = (1-u) h_prev + u cand (origin_mode flips the
    combination)."""
    x = first(ins, "Input")
    lens = first(ins, "XLod")
    w = first(ins, "Weight")
    bias = first(ins, "Bias").reshape(-1)
    h0 = first(ins, "H0")
    origin_mode = op.attr("origin_mode", False)
    D = w.shape[0]
    b, T = x.shape[0], x.shape[1]
    w_ur, w_c = w[:, :2 * D], w[:, 2 * D:]
    h = h0 if h0 is not None else torch.zeros((b, D), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    hs = [None] * T
    for t in _steps(T, op.attr("is_reverse", False)):
        xt = x[:, t]
        ur = torch.sigmoid(xt[:, :2 * D] + h @ w_ur + bias[:2 * D])
        u, r = ur[:, :D], ur[:, D:]
        cand = torch.tanh(xt[:, 2 * D:] + (r * h) @ w_c + bias[2 * D:])
        h_new = u * h + (1.0 - u) * cand if origin_mode else (1.0 - u) * h + u * cand
        active = (lens > t).reshape(b, 1)
        h = torch.where(active, h_new, h)
        hs[t] = torch.where(active, h, zero)
    return {"Hidden": torch.stack(hs, 1)}


@register_op("cudnn_lstm")
def _cudnn_lstm(ctx, op, ins):
    """Multi-layer, optionally bidirectional LSTM over dense [b, T, I] input:
    the JAX package's formulation, not a call into cuDNN.  W is flat: per
    layer, then per direction, [Wx (4D, in), Wh (4D, D), bx (4D), bh (4D)],
    gate order (i, f, c, o); the second direction runs reversed; dropout
    between layers draws from the run's generator."""
    x = first(ins, "Input")
    w = first(ins, "W").reshape(-1)
    init_h = first(ins, "InitH")
    init_c = first(ins, "InitC")
    D = op.attr("hidden_size")
    L = op.attr("num_layers", 1)
    dirs = 2 if op.attr("is_bidirec", False) else 1
    dropout = op.attr("dropout_prob", 0.0)
    I = x.shape[2]
    off = 0

    def take(shape):
        nonlocal off
        n = 1
        for d in shape:
            n *= d
        out = w[off:off + n].reshape(shape)
        off += n
        return out

    out = x
    last_h, last_c = [], []
    for layer in range(L):
        in_dim = I if layer == 0 else D * dirs
        outs = []
        for d in range(dirs):
            wx, wh, bx, bh = take((4 * D, in_dim)), take((4 * D, D)), take((4 * D,)), take((4 * D,))
            pre = out @ wx.t() + bx + bh  # [b, T, 4D]
            h, c = init_h[layer * dirs + d], init_c[layer * dirs + d]
            hs = [None] * pre.shape[1]
            for t in _steps(pre.shape[1], d == 1):
                gates = pre[:, t] + h @ wh.t()
                i, f = torch.sigmoid(gates[:, :D]), torch.sigmoid(gates[:, D:2 * D])
                g, o = torch.tanh(gates[:, 2 * D:3 * D]), torch.sigmoid(gates[:, 3 * D:])
                c = f * c + i * g
                h = o * torch.tanh(c)
                hs[t] = h
            outs.append(torch.stack(hs, 1))
            last_h.append(h)
            last_c.append(c)
        out = torch.cat(outs, -1) if dirs > 1 else outs[0]
        if dropout > 0 and not op.attr("is_test", False) and layer < L - 1:
            keep = 1.0 - dropout
            mask = torch.rand(out.shape, generator=ctx.generator, device=out.device) < keep
            out = torch.where(mask, out / keep, torch.zeros((), dtype=out.dtype, device=out.device))
    return {"Out": out, "LastH": torch.stack(last_h), "LastC": torch.stack(last_c)}


@register_op("gru_unit")
def _gru_unit(ctx, op, ins):
    """One GRU step over the projected input [b, 3D] and the previous hidden
    [b, D]; gate order (u, r, c)."""
    x = first(ins, "Input")
    h = first(ins, "HiddenPrev")
    w = first(ins, "Weight")
    bias = first(ins, "Bias")
    d = h.shape[1]
    xb = x + bias if bias is not None else x
    ur = torch.sigmoid(xb[:, :2 * d] + h @ w[:, :2 * d])
    u, r = ur[:, :d], ur[:, d:]
    c = torch.tanh(xb[:, 2 * d:] + (r * h) @ w[:, 2 * d:])
    hn = u * h + (1 - u) * c if op.attr("origin_mode", False) else (1 - u) * h + u * c
    return {"Hidden": hn, "ResetHiddenPrev": r * h, "Gate": torch.cat([u, r, c], 1)}


@register_op("lstm_unit")
def _lstm_unit(ctx, op, ins):
    """C = sigmoid(f + forget_bias) * C_prev + sigmoid(i) * tanh(c);
    H = sigmoid(o) * tanh(C); X packs (i, f, c, o)."""
    x = first(ins, "X")
    c_prev = first(ins, "C_prev")
    d = c_prev.shape[1]
    i, f, c, o = x[:, :d], x[:, d:2 * d], x[:, 2 * d:3 * d], x[:, 3 * d:]
    new_c = torch.sigmoid(f + op.attr("forget_bias", 0.0)) * c_prev + torch.sigmoid(i) * torch.tanh(c)
    return {"C": new_c, "H": torch.sigmoid(o) * torch.tanh(new_c)}


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _gather_time(x, idx):
    """x[i, idx[i, t]] for a [b, T'] index into x's time axis."""
    idx = idx.long().reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return torch.take_along_dim(x, idx.expand(tuple(idx.shape[:2]) + tuple(x.shape[2:])), 1)


@register_op("sequence_softmax")
def _sequence_softmax(ctx, op, ins):
    x = first(ins, "X")  # [b, T] or [b, T, 1]
    m = _mask(first(ins, "XLod"), x.shape[1], x.dim() - 2)
    z = torch.where(m, x, torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device))
    return {"Out": torch.where(m, torch.softmax(z, 1), _zero(x))}


@register_op("sequence_expand")
def _sequence_expand(ctx, op, ins):
    """One row of X per batch item ([b, *f] or [b, 1, *f]) broadcast along
    Y's time axis and masked to Y's lengths (the JAX package's form: an
    encoder vector over decoder steps)."""
    x = first(ins, "X")
    T = first(ins, "Y").shape[1]
    if x.dim() >= 3 and x.shape[1] == 1:
        x = x[:, 0]
    out = x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
    return {"Out": torch.where(_mask(first(ins, "YLod"), T, out.dim() - 2), out, _zero(x))}


register_op("sequence_expand_as")(_sequence_expand)


@register_op("sequence_reverse")
def _sequence_reverse(ctx, op, ins):
    x = first(ins, "X")
    lens = first(ins, "XLod")
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    idx = torch.where(t < lens[:, None], lens[:, None] - 1 - t, t)
    return {"Out": _gather_time(x, idx)}


@register_op("sequence_pad")
def _sequence_pad(ctx, op, ins):
    """The carrier is padded already: re-pad the time axis to padded_length
    and write PadValue past each length."""
    x = first(ins, "X")
    lens = first(ins, "XLod")
    T_out = op.attr("padded_length", -1)
    T = x.shape[1]
    if T_out is None or T_out < 0:
        T_out = T
    if T_out > T:
        x = torch.nn.functional.pad(x, [0, 0] * (x.dim() - 2) + [0, T_out - T])
    elif T_out < T:
        x = x[:, :T_out]
    pad_value = first(ins, "PadValue").to(x.dtype).reshape(())
    return {"Out": torch.where(_mask(lens, T_out, x.dim() - 2), x, pad_value),
            "Length": lens.to(canon_dtype("int64"))}


@register_op("sequence_unpad")
def _sequence_unpad(ctx, op, ins):
    x = first(ins, "X")
    lens = first(ins, "Length").reshape(-1).to(torch.int32)
    return {"Out": torch.where(_mask(lens, x.shape[1], x.dim() - 2), x, _zero(x)), "OutLod": lens}


@register_op("sequence_concat")
def _sequence_concat(ctx, op, ins):
    """Row by row, x1[i, :l1] ++ x2[i, :l2] ++ ..., repacked from the left."""
    xs = ins["X"]
    lens_list = ins["XLod"]
    T_out = sum(x.shape[1] for x in xs)
    b = xs[0].shape[0]
    t = torch.arange(T_out, device=xs[0].device)[None, :]
    out = torch.zeros((b, T_out) + tuple(xs[0].shape[2:]), dtype=xs[0].dtype, device=xs[0].device)
    offset = torch.zeros((b, 1), dtype=torch.int32, device=xs[0].device)
    for x, lens in zip(xs, lens_list):
        local = t - offset
        valid = (local >= 0) & (local < lens[:, None])
        g = _gather_time(x, torch.clamp(local, 0, x.shape[1] - 1))
        out = torch.where(valid.reshape(tuple(valid.shape) + (1,) * (x.dim() - 2)), g, out)
        offset = offset + lens[:, None]
    return {"Out": out, "OutLod": sum(lens_list).to(torch.int32)}


@register_op("sequence_slice")
def _sequence_slice(ctx, op, ins):
    x = first(ins, "X")
    offset = first(ins, "Offset").reshape(-1).to(torch.int32)
    length = first(ins, "Length").reshape(-1).to(torch.int32)
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    g = _gather_time(x, torch.clamp(t + offset[:, None], 0, T - 1))
    return {"Out": torch.where(_mask(length, T, x.dim() - 2), g, _zero(x)), "OutLod": length}


@register_op("sequence_erase")
def _sequence_erase(ctx, op, ins):
    """Drop the ids in `tokens` and repack each row from the left (a stable
    partition: kept ids keep their order)."""
    x = first(ins, "X")
    lens = first(ins, "XLod")
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    xs = x[..., 0] if squeeze else x
    T = xs.shape[1]
    tokens = ctx.constant(("erase_tokens", tuple(op.attr("tokens", [])), str(x.dtype), str(x.device)),
                          lambda: torch.tensor(list(op.attr("tokens", [])), dtype=x.dtype,
                                               device=x.device))
    keep = _mask(lens, T) & ~torch.isin(xs, tokens)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    packed = torch.take_along_dim(xs, order, 1)
    new_lens = keep.sum(1).to(torch.int32)
    packed = torch.where(_mask(new_lens, T), packed, _zero(packed))
    return {"Out": packed[..., None] if squeeze else packed, "OutLod": new_lens}


@register_op("sequence_enumerate")
def _sequence_enumerate(ctx, op, ins):
    """out[i, t, k] = ids[i, t+k] where t+k < len, else pad_value."""
    x = first(ins, "X")
    lens = first(ins, "XLod")
    win = op.attr("win_size", 2)
    pad = torch.full((), op.attr("pad_value", 0), dtype=x.dtype, device=x.device)
    xs = x[..., 0] if x.dim() == 3 and x.shape[-1] == 1 else x
    T = xs.shape[1]
    t = torch.arange(T, device=x.device)
    outs = [torch.where((t[None, :] + k) < lens[:, None], xs[:, torch.clamp(t + k, max=T - 1)], pad)
            for k in range(win)]
    out = torch.where(_mask(lens, T, 1), torch.stack(outs, -1), pad)
    return {"Out": out, "OutLod": lens}


@register_op("sequence_scatter")
def _sequence_scatter(ctx, op, ins):
    """Out[i] = X[i] with Updates[i, :len] added at the columns Ids[i, :len];
    padding slots go to a dropped extra column."""
    x = first(ins, "X")
    ids = first(ins, "Ids").to(torch.int64)
    if ids.dim() == 3:
        ids = ids[..., 0]
    upd = first(ins, "Updates")
    if upd.dim() == 3 and upd.shape[-1] == 1:
        upd = upd[..., 0]
    b, D = x.shape
    valid = _mask(first(ins, "IdsLod"), ids.shape[1])
    tgt = torch.where(valid, ids, torch.full((), D, dtype=ids.dtype, device=ids.device))
    padded = torch.cat([x, torch.zeros((b, 1), dtype=x.dtype, device=x.device)], 1)
    out = padded.scatter_add(1, tgt, torch.where(valid, upd.to(x.dtype), _zero(x)))
    return {"Out": out[:, :D]}


@register_op("sequence_reshape")
def _sequence_reshape(ctx, op, ins):
    """Each row's len x D payload re-cut into new_dim columns: the valid
    tokens are a contiguous prefix, so a per-row reshape keeps them."""
    x = first(ins, "X")
    nd = int(op.attr("new_dim"))
    b, t, d = x.shape
    return {"Out": x.reshape(b, t * d // nd, nd), "OutLod": (first(ins, "XLod") * d) // nd}


NEG_LOG = -1e30


def _shift(a, k):
    """a shifted right by k along axis 1, NEG_LOG filling the front."""
    return torch.cat([torch.full((a.shape[0], k), NEG_LOG, dtype=a.dtype, device=a.device),
                      a[:, :-k]], 1)


@register_op("warpctc")
def _warpctc(ctx, op, ins):
    """CTC loss as the log-alpha recursion over the extended label sequence
    (blank, l1, blank, l2, ..., blank), frozen past each row's logit length;
    its gradient is autograd's through the loop.  Logits [b, T, C] + XLod,
    Label [b, L] (or [b, L, 1]) + LabelLod; Loss [b, 1] float32."""
    logits = first(ins, "Logits")
    logit_lens = first(ins, "XLod")
    labels = first(ins, "Label").long()
    if labels.dim() == 3 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    label_lens = first(ins, "LabelLod")
    blank = op.attr("blank", 0)
    b, T, _ = logits.shape
    L = labels.shape[1]
    S = 2 * L + 1
    logp = torch.log_softmax(logits.float(), -1)
    ext = torch.full((b, S), blank, dtype=torch.long, device=logits.device)
    ext[:, 1::2] = labels
    skip_ok = torch.zeros((b, S), dtype=torch.bool, device=logits.device)
    if L > 1:
        skip_ok[:, 3::2] = labels[:, 1:] != labels[:, :-1]
    neg = torch.full((), NEG_LOG, dtype=torch.float32, device=logits.device)
    alpha = torch.full((b, S), NEG_LOG, dtype=torch.float32, device=logits.device)
    first_emit = torch.gather(logp[:, 0], 1, ext[:, :2] if L > 0 else ext[:, :1])
    alpha = torch.cat([first_emit, alpha[:, first_emit.shape[1]:]], 1)
    for t in range(1, T):
        merged = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1)),
                                 torch.where(skip_ok, _shift(alpha, 2) if S > 2 else neg, neg))
        new = merged + torch.gather(logp[:, t], 1, ext)
        alpha = torch.where((logit_lens > t).reshape(b, 1), new, alpha)
    idx_last = (2 * label_lens).long()
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp_min(idx_last - 1, 0)[:, None])[:, 0]
    loglik = torch.where(label_lens > 0, torch.logaddexp(a_last, a_prev), a_last)
    loss = -loglik
    if op.attr("norm_by_times", False):
        loss = loss / torch.clamp_min(logit_lens.float(), 1.0)
    return {"Loss": loss.reshape(b, 1)}


def _crf_inputs(ins):
    x = first(ins, "Emission").float()
    w = first(ins, "Transition").float()
    return x, first(ins, "XLod"), w[0], w[1], w[2:]


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx, op, ins):
    """Linear-chain CRF negative log-likelihood: Transition [D+2, D] (row 0
    start, row 1 end, rows 2.. tag to tag); the log partition by the
    logsumexp alpha recursion frozen past each length, minus the labelled
    path's score; 0 for an empty row.  LogLikelihood [b, 1]."""
    x, lens, w_start, w_end, w_trans = _crf_inputs(ins)
    label = first(ins, "Label").long()
    if label.dim() == 3 and label.shape[-1] == 1:
        label = label[..., 0]
    b, T, _ = x.shape
    alpha = w_start[None, :] + x[:, 0, :]
    for t in range(1, T):
        new = torch.logsumexp(alpha[:, :, None] + w_trans[None], 1) + x[:, t, :]
        alpha = torch.where((lens > t).reshape(b, 1), new, alpha)
    log_z = torch.logsumexp(alpha + w_end[None, :], 1)
    t_idx = torch.arange(T, device=x.device)[None, :]
    emit = torch.gather(x, 2, label[:, :, None])[..., 0]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    emit_sum = torch.where(t_idx < lens[:, None], emit, zero).sum(1)
    if T > 1:
        trans = w_trans[label[:, :-1], label[:, 1:]]
        trans_sum = torch.where(t_idx[:, 1:] < lens[:, None], trans, zero).sum(1)
    else:
        trans_sum = torch.zeros((b,), dtype=torch.float32, device=x.device)
    last = torch.gather(label, 1, torch.clamp_min(lens.long() - 1, 0)[:, None])[:, 0]
    score = w_start[label[:, 0]] + emit_sum + trans_sum + w_end[last]
    return {"LogLikelihood": torch.where(lens > 0, log_z - score, zero).reshape(b, 1)}


@register_op("crf_decoding")
def _crf_decoding(ctx, op, ins):
    """Viterbi decode: the max-product recursion with argmax tracks, then the
    backtrack from each row's last position; int64 paths, 0 past each
    length.  With Label, the per-position 0/1 agreement of label and path."""
    x, lens, w_start, w_end, w_trans = _crf_inputs(ins)
    b, T, D = x.shape
    alpha = w_start[None, :] + x[:, 0, :]
    tracks = [torch.zeros((b, D), dtype=torch.long, device=x.device)]
    for t in range(1, T):
        best, track = torch.max(alpha[:, :, None] + w_trans[None], 1)
        active = (lens > t).reshape(b, 1)
        alpha = torch.where(active, best + x[:, t, :], alpha)
        tracks.append(torch.where(active, track, torch.zeros_like(track)))
    best_end = torch.argmax(alpha + w_end[None, :], 1)
    last = lens.long() - 1
    cur = torch.zeros((b,), dtype=torch.long, device=x.device)
    path = [None] * T
    for t in range(T - 1, -1, -1):
        from_track = torch.gather(tracks[min(t + 1, T - 1)], 1, cur[:, None])[:, 0]
        tag = torch.where(last == t, best_end, torch.where(t < last, from_track,
                                                           torch.zeros_like(from_track)))
        path[t] = cur = tag
    path = torch.stack(path, 1)
    m = torch.arange(T, device=x.device)[None, :] < lens[:, None]
    path = torch.where(m, path, torch.zeros_like(path))
    label = first(ins, "Label")
    if label is not None:
        label = label.long()
        if label.dim() == 3 and label.shape[-1] == 1:
            label = label[..., 0]
        path = torch.where(m, (label == path).long(), torch.zeros_like(path))
    return {"ViterbiPath": path.to(canon_dtype("int64"))}


@register_op("dynamic_rnn")
def _dynamic_rnn(ctx, op, ins):
    """DynamicRNN / StaticRNN: the sub-block runs once a time step, over the
    env of the enclosing block (ctx.env: the parameters the body reads, as
    leaves of the backward region when one runs), with the step inputs'
    rows at t and the memories bound.  Past each row's length the memories
    freeze and the outputs are 0; without a lengths input (StaticRNN)
    every row runs the whole padded length.  is_reverse runs t downwards."""
    from ..core.lowering import run_ops

    sub_ops = [o for o in op.block.program.blocks[op.attr("sub_block")].ops
               if o.type not in ("feed", "fetch")]
    xs = ins.get("X", [])
    b, T = xs[0].shape[0], xs[0].shape[1]
    lens = first(ins, "XLod")
    if lens is None:
        lens = torch.full((b,), T, dtype=torch.int32, device=xs[0].device)
    step_names = op.attr("step_vars")
    mem_names = op.attr("mem_vars")
    update_names = op.attr("mem_updates")
    out_names = op.attr("out_vars")
    mem_values = op.attr("mem_values", [0.0] * len(mem_names))
    inits = iter(ins.get("MemInit", []))
    mems = []
    for j, has_init in enumerate(op.attr("mem_has_init")):
        if has_init:
            mems.append(next(inits))
        else:
            mems.append(torch.full((b,) + tuple(op.attr("mem_shapes")[j]), mem_values[j],
                                   dtype=canon_dtype(op.attr("mem_dtypes")[j]),
                                   device=xs[0].device))
    outer = dict(ctx.env)
    ys = [[None] * T for _ in out_names]
    for t in _steps(T, op.attr("is_reverse", False)):
        env = dict(outer)
        env.update(zip(step_names, (x[:, t] for x in xs)))
        env.update(zip(mem_names, mems))
        run_ops(ctx, sub_ops, env)
        active = lens > t
        mems = [torch.where(active.reshape((b,) + (1,) * (old.dim() - 1)), env[un], old)
                for un, old in zip(update_names, mems)]
        for k, n in enumerate(out_names):
            o = env[n]
            ys[k][t] = torch.where(active.reshape((b,) + (1,) * (o.dim() - 1)), o, _zero(o))
    return {"Out": [torch.stack(y, 1) for y in ys], "FinalMem": mems}


# --- build-time shape/dtype inference (core/analysis.py), as the JAX
# package registers it next to the same lowerings.  The other ops of this
# module have no rule there either.

from ..core import analysis as _A


def _infer_sequence_pool(ctx):
    """[b, T, *f] pooled over the time axis -> [b, *f] (+ MaxIndex for MAX
    pooling, same shape, int32)."""
    xs = ctx.in_shape("X")
    if xs is None or len(xs) < 2:
        return
    out = (xs[0],) + tuple(xs[2:])
    ctx.set_out("Out", out, ctx.in_dtype("X"))
    ctx.set_out("MaxIndex", out, "int32")


_A.register_rule(["sequence_pool"], _infer_sequence_pool)


def _infer_attention_bias(ctx):
    """[b, 1, Tq, Tk] additive bias from the Q/K ragged carriers."""
    qs = ctx.in_shape("Q")
    ks = ctx.in_shape("K")
    if qs is None or ks is None or len(qs) < 2 or len(ks) < 2:
        return
    ctx.set_out("Out", (qs[0], 1, qs[1], ks[1]), "float32")


_A.register_rule(["attention_bias"], _infer_attention_bias)

# position_encoding adds a sinusoid table to X: Out mirrors X
_A.register_unary_infer("position_encoding")



# --- static cost rules (core/resource_plan.py) ------------------------------
# The JAX package's (paddle_tpu/ops/sequence_ops.py).

from ..core import resource_plan as _RP


def _cost_sequence_pool(ctx):
    return float(ctx.in_elems("X") * 2), ctx.io_bytes()


_RP.register_cost(["sequence_pool", "sequence_softmax"], _cost_sequence_pool)
_RP.register_elementwise_cost("position_encoding", "attention_bias",
                              flops_per_elem=4.0)
_RP.register_bytes_cost("sequence_mask", "sequence_expand",
                        "sequence_expand_as", "sequence_reverse",
                        "sequence_pad", "sequence_unpad", "sequence_concat",
                        "sequence_slice", "dynamic_rnn")
