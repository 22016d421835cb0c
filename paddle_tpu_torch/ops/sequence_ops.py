"""Sequence (ragged) lowerings over padded batches [batch, time, *feature]
and int32 lengths [batch] (counterpart of paddle_tpu/ops/sequence_ops.py):
masks derived from the lengths take the place of the reference's walks over
offset tables.  The ops: sequence_pool, sequence_mask, attention_bias,
position_encoding, sequence_conv and dynamic_lstm."""
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


def _lstm(x, lens, w, bias, use_peepholes, is_reverse, h0=None, c0=None):
    """The LSTM time loop of the JAX package's _lstm_scan without a
    projection: gate blocks {c, i, f, o}, peepholes {W_ic, W_fc, W_oc} in
    the bias tail, and past each row's length the memories freeze and the
    outputs are 0.  A Python loop over the padded time axis: no host read,
    so a plan that holds it can be captured as a CUDA graph."""
    D = w.shape[0]
    b, T = x.shape[0], x.shape[1]
    bias = bias.reshape(-1)
    gate_bias = bias[:4 * D]
    if use_peepholes:
        w_ic, w_fc, w_oc = bias[4 * D:5 * D], bias[5 * D:6 * D], bias[6 * D:7 * D]
    h = h0 if h0 is not None else torch.zeros((b, D), dtype=x.dtype, device=x.device)
    c = c0 if c0 is not None else torch.zeros((b, D), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    hs, cs = [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        gates = x[:, t] + h @ w + gate_bias
        gc, gi, gf, go = gates[:, :D], gates[:, D:2 * D], gates[:, 2 * D:3 * D], gates[:, 3 * D:]
        if use_peepholes:
            gi = gi + w_ic * c
            gf = gf + w_fc * c
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gc)
        if use_peepholes:
            go = go + w_oc * c_new
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
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


# --- build-time shape/dtype inference (core/analysis.py), as the JAX
# package registers it next to the same lowerings.  sequence_mask,
# sequence_conv and dynamic_lstm have no rule there either.

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
