"""The lowerings of paddle_tpu/ops/tail_ops.py the other slices left:
activations with attrs, logic and boolean reductions, the tail losses, the
shape shufflers, adaptive pooling, the batch-size-like fillers, sampling,
`data_norm` and the SelectedRows helpers (`sequence_reshape`, `gru_unit`,
`lstm_unit` and `decayed_adagrad` live in sequence_ops and
optimizer_ops).  Random draws come from the run's generator."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import analysis as _A
from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from .common import canon_dtype, first


@register_op("brelu")
def _brelu(ctx, op, ins):
    return {"Out": torch.clamp(first(ins, "X"), op.attr("t_min", 0.0), op.attr("t_max", 24.0))}


@register_op("soft_relu")
def _soft_relu(ctx, op, ins):
    t = op.attr("threshold", 40.0)
    return {"Out": torch.log1p(torch.exp(torch.clamp(first(ins, "X"), -t, t)))}


@register_op("thresholded_relu")
def _thresholded_relu(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": torch.where(x > op.attr("threshold", 1.0), x, torch.zeros_like(x))}


@register_op("logical_xor")
def _logical_xor(ctx, op, ins):
    return {"Out": torch.logical_xor(first(ins, "X"), first(ins, "Y"))}


_A.register_elementwise_infer("logical_xor", out_dtype="bool")


def _bool_reduce(fn):
    def lower(ctx, op, ins):
        x = first(ins, "X").bool()
        dim, keep = op.attr("dim", None), op.attr("keep_dim", False)
        if not dim:
            out = fn(x)
            return {"Out": out.reshape((1,) * x.dim()) if keep else out}
        return {"Out": fn(x, dim=tuple(d % x.dim() for d in dim), keepdim=keep)}
    return lower


register_op("reduce_all")(_bool_reduce(torch.all))
register_op("reduce_any")(_bool_reduce(torch.any))


@register_op("has_inf")
def _has_inf(ctx, op, ins):
    return {"Out": torch.isinf(first(ins, "X")).any().reshape(1)}


@register_op("has_nan")
def _has_nan(ctx, op, ins):
    return {"Out": torch.isnan(first(ins, "X")).any().reshape(1)}


@register_op("is_empty")
def _is_empty(ctx, op, ins):
    return {"Out": torch.full((1,), first(ins, "X").numel() == 0, dtype=torch.bool,
                              device=ctx.device)}


@register_op("cos_sim")
def _cos_sim(ctx, op, ins):
    """Per-row cosine; Y may be one row [1, D], broadcast."""
    x, y = first(ins, "X"), first(ins, "Y")
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    dot = torch.sum(x * y, dim=-1, keepdim=True)
    return {"Out": dot / torch.clamp_min(xn * yn, 1e-12), "XNorm": xn, "YNorm": yn}


@register_op("smooth_l1_loss")
def _smooth_l1_loss(ctx, op, ins):
    """Huber with sigma^2 scaling and inside / outside weights, summed per
    row into [N, 1]."""
    x, y = first(ins, "X"), first(ins, "Y")
    s2 = op.attr("sigma", 1.0) ** 2
    inw = first(ins, "InsideWeight")
    outw = first(ins, "OutsideWeight")
    d = (x - y) * (inw if inw is not None else 1.0)
    ad = torch.abs(d)
    el = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if outw is not None:
        el = el * outw
    return {"Out": torch.sum(el.reshape(x.shape[0], -1), dim=1, keepdim=True), "Diff": d}


@register_op("teacher_student_sigmoid_loss")
def _ts_sigmoid_loss(ctx, op, ins):
    """Label encoding: z < -1 no teacher q, click 0; [-1, 0) no q, click 1;
    [0, 1) q = z, click 0; >= 1 q = z - 1, click 1."""
    x = first(ins, "X").reshape(-1)
    z = first(ins, "Label").reshape(-1).to(x.dtype)
    base = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
    out = torch.where(z < -1.0, base,
                      torch.where(z < 0.0, base - x,
                                  torch.where(z < 1.0, base + base - x * z,
                                              base - x + base - x * (z - 1.0))))
    return {"Y": out.reshape(-1, 1)}


@register_op("pixel_shuffle")
def _pixel_shuffle(ctx, op, ins):
    """[N, C r^2, H, W] -> [N, C, H r, W r]."""
    x = first(ins, "X")
    r = int(op.attr("upscale_factor"))
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": x.reshape(n, c // (r * r), h * r, w * r)}


@register_op("shuffle_channel")
def _shuffle_channel(ctx, op, ins):
    x = first(ins, "X")
    g = int(op.attr("group", 1))
    n, c, h, w = x.shape
    return {"Out": x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w)}


@register_op("temporal_shift")
def _temporal_shift(ctx, op, ins):
    """The first shift_ratio of the channels one step back in time, the next
    one step forward, the rest in place (zeros at the ends)."""
    x = first(ins, "X")  # [N T, C, H, W]
    t = int(op.attr("seg_num"))
    ratio = op.attr("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    v = x.reshape(nt // t, t, c, h, w)
    back = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], dim=1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]], dim=1)
    return {"Out": torch.cat([back, fwd, v[:, :, c2:]], dim=2).reshape(nt, c, h, w)}


@register_op("fsp")
def _fsp(ctx, op, ins):
    """[b, c1, h, w] x [b, c2, h, w] -> [b, c1, c2] / (h w)."""
    x, y = first(ins, "X"), first(ins, "Y")
    h, w = x.shape[2], x.shape[3]
    return {"Out": torch.einsum("bchw,bdhw->bcd", x, y) / (h * w)}


@register_op("unfold")
def _unfold(ctx, op, ins):
    """im2col: [N, C, H, W] -> [N, C kh kw, L], (C, kh, kw)-major."""
    x = first(ins, "X")
    pads = op.attr("paddings", [0, 0, 0, 0])
    if len(pads) == 2:
        pads = [pads[0], pads[1], pads[0], pads[1]]
    xp = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    return {"Y": F.unfold(xp, tuple(op.attr("kernel_sizes")),
                          dilation=tuple(op.attr("dilations", [1, 1])),
                          stride=tuple(op.attr("strides", [1, 1])))}


def _adaptive_masks(in_size, out_size):
    """Window i of an adaptive pool covers [floor(i H / out), ceil((i + 1) H
    / out)): a [out, in] mask and the windows' sizes, as numpy."""
    starts = [int(np.floor(i * in_size / out_size)) for i in range(out_size)]
    ends = [int(np.ceil((i + 1) * in_size / out_size)) for i in range(out_size)]
    m = np.zeros((out_size, in_size), bool)
    for i, (s, e) in enumerate(zip(starts, ends)):
        m[i, s:e] = True
    return m, np.asarray([e - s for s, e in zip(starts, ends)], np.float32)


def _adaptive_pool(ctx, x, out_sizes, ptype):
    out = x.float()
    for d, (insz, outsz) in enumerate(zip(x.shape[2:], out_sizes)):
        m, cnt = (ctx.constant(("adaptive_pool", insz, outsz, i), lambda i=i: torch.as_tensor(
            _adaptive_masks(insz, outsz)[i], device=ctx.device)) for i in range(2))
        axis = 2 + d
        out = torch.movedim(out, axis, -1)[..., None, :]
        if ptype == "max":
            out = torch.where(m, out, torch.full_like(out, torch.finfo(torch.float32).min)).amax(-1)
        else:
            out = torch.where(m, out, torch.zeros_like(out)).sum(-1) / cnt
        out = torch.movedim(out, -1, axis)
    return out


@register_op("adaptive_pool2d")
def _adaptive_pool2d(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": _adaptive_pool(ctx, x, op.attr("pooled_size"),
                                  op.attr("pooling_type", "max")).to(x.dtype)}


register_op("adaptive_pool3d")(_adaptive_pool2d)


def _batch_size_like_shape(op, ins):
    shape = list(op.attr("shape"))
    shape[op.attr("output_dim_idx", 0)] = first(ins, "Input").shape[op.attr("input_dim_idx", 0)]
    return tuple(int(s) for s in shape)


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ctx, op, ins):
    return {"Out": torch.full(_batch_size_like_shape(op, ins), op.attr("value", 0.0),
                              dtype=canon_dtype(op.attr("dtype", "float32")), device=ctx.device)}


@register_op("uniform_random_batch_size_like")
def _uniform_random_bsl(ctx, op, ins):
    lo, hi = op.attr("min", -1.0), op.attr("max", 1.0)
    u = torch.rand(_batch_size_like_shape(op, ins), generator=ctx.generator, device=ctx.device)
    return {"Out": (u * (hi - lo) + lo).to(canon_dtype(op.attr("dtype", "float32")))}


@register_op("gaussian_random_batch_size_like")
def _gaussian_random_bsl(ctx, op, ins):
    z = torch.randn(_batch_size_like_shape(op, ins), generator=ctx.generator, device=ctx.device)
    out = z * op.attr("std", 1.0) + op.attr("mean", 0.0)
    return {"Out": out.to(canon_dtype(op.attr("dtype", "float32")))}


@register_op("sampling_id")
def _sampling_id(ctx, op, ins):
    """One column index a row, drawn with probability proportional to the
    row's (clamped) values: the inverse CDF of a uniform draw."""
    cdf = torch.cumsum(torch.clamp_min(first(ins, "X").float(), 1e-20), dim=-1)
    u = torch.rand(cdf.shape[:-1] + (1,), generator=ctx.generator, device=ctx.device)
    ids = torch.searchsorted(cdf, u * cdf[..., -1:])[..., 0]
    return {"Out": torch.clamp(ids, max=cdf.shape[-1] - 1).to(torch.int32)}


def _position_table(t, d):
    half = d // 2
    pos = np.arange(t, dtype=np.float32)[:, None]
    i = np.arange(half, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, i / half)
    return np.concatenate([np.sin(angle), np.cos(angle)], axis=1)


@register_op("add_position_encoding")
def _add_position_encoding(ctx, op, ins):
    """alpha x + beta enc, enc[p, i < D/2] = sin(p / 10000^(i / (D/2))), the
    upper half the cosines."""
    x = first(ins, "X")
    t, d = x.shape[1], x.shape[2]
    enc = ctx.constant(("position_encoding", t, d), lambda: torch.as_tensor(
        _position_table(t, d), device=ctx.device))
    return {"Out": op.attr("alpha", 1.0) * x + op.attr("beta", 1.0) * enc.to(x.dtype)[None]}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, op, ins):
    """out[n, k] = x[n] W[k] y[n]^T (+ b)."""
    out = torch.einsum("nd,kde,ne->nk", first(ins, "X"), first(ins, "Weight"), first(ins, "Y"))
    bias = first(ins, "Bias")
    return {"Out": out + bias if bias is not None else out}


@register_op("cvm")
def _cvm(ctx, op, ins):
    """use_cvm: the leading (show, click) columns become (log(show + 1),
    log(click + 1) - log(show + 1)); otherwise they are dropped."""
    x = first(ins, "X")
    if op.attr("use_cvm", True):
        show = torch.log(x[:, 0:1] + 1.0)
        return {"Y": torch.cat([show, torch.log(x[:, 1:2] + 1.0) - show, x[:, 2:]], dim=1)}
    return {"Y": x[:, 2:]}


@register_op("data_norm")
def _data_norm(ctx, op, ins):
    """Normalize by the accumulated statistics (count, sum, square sum),
    then add the batch into them."""
    x = first(ins, "X").float()
    size, xsum, sqs = first(ins, "BatchSize"), first(ins, "BatchSum"), first(ins, "BatchSquareSum")
    eps = op.attr("epsilon", 1e-4)
    mean = xsum / size
    scale = torch.sqrt(size / torch.clamp_min(sqs - size * mean * mean + eps * size, eps))
    return {"Y": (x - mean) * scale, "Means": mean, "Scales": scale,
            "BatchSizeOut": size + x.shape[0], "BatchSumOut": xsum + torch.sum(x, dim=0),
            "BatchSquareSumOut": sqs + torch.sum(torch.square(x), dim=0)}


@register_op("get_tensor_from_selected_rows")
def _get_tensor_from_selected_rows(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": x.values if isinstance(x, SelectedRows) else x}


@register_op("merge_selected_rows")
def _merge_selected_rows(ctx, op, ins):
    """Rows of a SelectedRows merged (their values summed), a dense value as
    it is.  The merge calls torch.unique_consecutive, which waits for the
    card: the executor captures no graph of a step with this op."""
    x = first(ins, "X")
    return {"Out": x.merged() if isinstance(x, SelectedRows) else x}


@register_op("random_crop")
def _random_crop(ctx, op, ins):
    """A window of `shape` (the trailing dims) at a random offset, the same
    for every leading index; the offsets stay on the device (index_select)."""
    x = first(ins, "X")
    shape = list(op.attr("shape"))
    lead = x.dim() - len(shape)
    out = x
    for i, s in enumerate(shape):
        limit = max(x.shape[lead + i] - s, 0)
        start = torch.randint(0, limit + 1, (1,), generator=ctx.generator, device=ctx.device)
        idx = start + torch.arange(s, device=ctx.device)
        out = out.index_select(lead + i, idx)
    return {"Out": out}



# --- static cost rules (core/resource_plan.py) ------------------------------
# The JAX package's (paddle_tpu/ops/tail_ops.py).

from ..core import resource_plan as _RP  # noqa: E402

_RP.register_elementwise_cost("logical_xor")
_RP.register_elementwise_cost("add_position_encoding", flops_per_elem=4.0)
