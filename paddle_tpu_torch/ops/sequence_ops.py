"""Sequence (ragged) lowerings over padded batches [batch, time, *feature]
and int32 lengths [batch] (counterpart of paddle_tpu/ops/sequence_ops.py):
masks derived from the lengths take the place of the reference's walks over
offset tables."""
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


# --- build-time shape/dtype inference (core/analysis.py), as the JAX
# package registers it next to the same lowerings.  sequence_mask has no
# rule there either.

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
