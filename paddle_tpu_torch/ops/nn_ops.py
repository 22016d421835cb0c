"""NN lowerings: conv2d (and depthwise), the transposed convs, pool2d,
batch_norm (with the fused epilogue), group_norm, instance_norm,
lookup_table (with its sparse gradient tap), layer_norm (with the fused
residual), dropout, softmax, log_softmax, cross_entropy,
softmax_with_cross_entropy, sigmoid_cross_entropy_with_logits,
square_error_cost, huber_loss, fused_attention, top_k, arg_max / arg_min,
accuracy, auc, mean_iou, the interpolations, pad2d, crop, prelu, the
deformable convs and print, with their build-time inference rules
(counterpart of paddle_tpu/ops/nn_ops.py).

Layouts are NCHW only: the JAX package's channels-last paths (the
`data_format` / `data_layout` attrs, `_NHWC_LOWERING`) are TPU layout
levers, and the port picks its layout on the card's own evidence later
(ROADMAP A3).  `conv2d` and the pools are PyTorch's: the JAX package leaves
them to XLA outside any Pallas kernel."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import canon_dtype, first, flatten_lookup_ids, match_dtype
from .cuda_attention import fused_sdpa
from .cuda_kernels import bn_epilogue, fused_ln_residual, fused_softmax_xent

# paddle_tpu/ops/nn_ops.py: bf16 batch norm keeps its elementwise math in
# bf16 with float32 reduction accumulators, and takes its training
# statistics in one fused pass, E[x] and E[x^2]
_BN_BF16_COMPUTE = True
_BN_BF16_FUSED_DEFAULT = True


def _nchw_only(op_type, layout):
    if layout != "NCHW":
        raise NotImplementedError(
            f"{op_type}: layout {layout!r} is not ported; the port runs NCHW only until the "
            "card's own evidence picks a layout (ROADMAP A3)")


@register_op("conv2d")
def _conv2d(ctx, op, ins):
    """NCHW input, OIHW filter (cast to the input's dtype), with strides,
    dilations, groups, and paddings [ph, pw] or [top, bottom, left, right]."""
    x = first(ins, "Input")
    w = match_dtype(x, first(ins, "Filter"))
    _nchw_only("conv2d", op.attr("data_format", "NCHW"))
    pads = list(op.attr("paddings", [0, 0]))
    if len(pads) == 4:
        top, bottom, left, right = pads
        if (top, left) != (bottom, right):
            # F.conv2d pads symmetrically; F.pad takes (left, right, top, bottom)
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        pads = [top, left]
    return {"Output": F.conv2d(x, w, None, tuple(op.attr("strides", [1, 1])), tuple(pads),
                               tuple(op.attr("dilations", [1, 1])), op.attr("groups", 1) or 1)}


@register_op("pool2d")
def _pool2d(ctx, op, ins):
    """Max or average pooling with the JAX package's arithmetic: explicit
    padding, high-side padding for ceil_mode, and an exclusive average that
    divides each window by its count of valid elements."""
    x = first(ins, "X")
    _nchw_only("pool2d", op.attr("data_format", "NCHW"))
    ksize = list(op.attr("ksize", [2, 2]))
    strides = list(op.attr("strides", [1, 1]))
    pads = list(op.attr("paddings", [0, 0]))
    if op.attr("global_pooling", False):
        ksize, strides, pads = [x.shape[2], x.shape[3]], [1, 1], [0, 0]
    pad_hi = [pads[0], pads[1]]
    if op.attr("ceil_mode", False):
        # extra high-side padding so the window count rounds up
        for d in (0, 1):
            span = x.shape[2 + d] + 2 * pads[d] - ksize[d]
            pad_hi[d] += (-(-span // strides[d]) - span // strides[d]) * strides[d]
    pad4 = (pads[1], pad_hi[1], pads[0], pad_hi[0])  # F.pad order: W then H
    any_pad = any(pad4)
    if op.attr("pooling_type", "max") == "max":
        fill = float("-inf") if x.is_floating_point() else torch.iinfo(x.dtype).min
        return {"Out": F.max_pool2d(F.pad(x, pad4, value=fill) if any_pad else x, ksize, strides)}
    xp = F.pad(x, pad4) if any_pad else x
    if op.attr("exclusive", True) and any_pad:
        summed = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
        ones = F.pad(torch.ones_like(x[:1, :1]), pad4)
        return {"Out": summed / F.avg_pool2d(ones, ksize, strides, divisor_override=1)}
    return {"Out": F.avg_pool2d(xp, ksize, strides)}


@register_op("batch_norm")
def _batch_norm(ctx, op, ins):
    """paddle_tpu/ops/nn_ops.py _batch_norm over NCHW / NC*.

    Test mode and use_global_stats take the running statistics.  Training
    takes the batch's: bf16 in one fused pass (float32 sums of x and of its
    bf16 square, var = max(E[x^2] - mean^2, 0)), float32 in two (the mean,
    then the biased variance); MeanOut / VarianceOut move by `momentum`, and
    SavedMean / SavedVariance are written only when something reads them.
    Under plain data parallelism across a gang (`ctx.global_batch_stats`)
    the statistics are the global batch's (`_global_batch_stats`).  With a
    channel axis and spatial dims the normalization is the epilogue
    kernel (ops/cuda_kernels.py bn_epilogue) with float32 per-channel
    mul = rsqrt(var + eps) * scale and add = bias - mean * mul, built under
    autograd, so gradients reach x through the statistics too; the
    composite takes every other shape."""
    x = first(ins, "X")
    _nchw_only("batch_norm", op.attr("data_layout", "NCHW"))
    orig_dtype = x.dtype
    low = x.dtype in (torch.bfloat16, torch.float16)
    bf16_fast = _BN_BF16_COMPUTE and low
    if low and not bf16_fast:
        x = x.float()
    scale = first(ins, "Scale")
    bias = first(ins, "Bias")
    mean_in = first(ins, "Mean")
    var_in = first(ins, "Variance")
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    axes = [i for i in range(x.dim()) if i != 1]
    bshape = [1] * x.dim()
    bshape[1] = x.shape[1]
    training = not (op.attr("is_test", False) or op.attr("use_global_stats", False))
    # fp16 never takes the fused pass: its square overflows at |x| >= 256
    fused_pass = bf16_fast and x.dtype == torch.bfloat16 and _BN_BF16_FUSED_DEFAULT
    if not training:
        mean, var = mean_in, var_in
        mean_out, var_out = mean_in, var_in
    else:
        if ctx.global_batch_stats:
            mean, var = _global_batch_stats(x, axes)
        elif fused_pass:
            inv_n = 1.0 / math.prod(x.shape[i] for i in axes)
            mean = x.sum(axes, dtype=torch.float32) * inv_n
            var = torch.clamp_min(torch.square(x).sum(axes, dtype=torch.float32) * inv_n
                                  - torch.square(mean), 0.0)
        else:
            mean = x.mean(axes, dtype=torch.float32)
            if bf16_fast:  # fp16: the centered variance keeps the squares small
                centered = x - mean.to(x.dtype).reshape(bshape)
                var = torch.square(centered).mean(axes, dtype=torch.float32)
            else:
                var = x.var(axes, correction=0)
        mean_out = momentum * mean_in + (1.0 - momentum) * mean
        var_out = momentum * var_in + (1.0 - momentum) * var

    inv = torch.rsqrt(var.reshape(bshape) + eps)
    fuse_relu = op.attr("fuse_relu", False)  # core/passes.py fuse_bn_relu
    if x.dim() >= 3:
        mul_c = inv.reshape(-1) * scale.float()
        add_c = bias.float() - mean.reshape(-1) * mul_c
        y = bn_epilogue(x, mul_c, add_c, fuse_relu)
    else:
        sf = scale.float().reshape(bshape)
        if bf16_fast:
            # per-channel multipliers computed in float32, applied in bf16
            y = (x * (inv * sf).to(x.dtype)
                 + (bias.float().reshape(bshape) - mean.reshape(bshape) * inv * sf).to(x.dtype))
        else:
            y = (x - mean.reshape(bshape)) * inv * sf + bias.reshape(bshape)
        if fuse_relu:
            y = torch.relu(y)
    return {
        "Y": y.to(orig_dtype),
        "MeanOut": mean_out,
        "VarianceOut": var_out,
        "SavedMean": mean if ctx.wants(op, "SavedMean") else None,
        "SavedVariance": var if ctx.wants(op, "SavedVariance") else None,
    }


def _global_batch_stats(x, axes):
    """Batch norm's mean and biased variance over the gang's global batch
    (plain data parallelism across ranks, as the JAX package's GSPMD
    program normalizes over the global batch): the per-channel sum, the sum
    of squares and the count, in float32, all-reduced in one differentiable
    collective (its backward sums the cotangents over the gang), then
    var = max(E[x^2] - mean^2, 0)."""
    from ..parallel.distributed import AllReduceSum

    xf = x.float()
    count = torch.full((1,), float(math.prod(x.shape[i] for i in axes)), device=x.device)
    local = torch.cat([xf.sum(axes), torch.square(xf).sum(axes), count])
    total = AllReduceSum.apply(local)
    c = x.shape[1]
    mean = total[:c] / total[2 * c]
    var = torch.clamp_min(total[c:2 * c] / total[2 * c] - torch.square(mean), 0.0)
    return mean, var


@register_op("lookup_table")
def _lookup_table(ctx, op, ins):
    """ids carry a trailing dim of 1; padding_idx rows read as zeros.  Under
    is_sparse=True inside a backward region the output is tapped
    (core/lowering.py SparseTaps) before the padding mask, so the table's
    gradient is a SelectedRows slab and padded positions get none."""
    w = first(ins, "W")
    flat = flatten_lookup_ids(first(ins, "Ids"))
    out = w[flat]
    if ctx.sparse_taps is not None and op.attr("is_sparse", False):
        out = ctx.sparse_taps.tap(op.input("W")[0], flat, out)
    pad = op.attr("padding_idx", None)
    if pad is not None:
        real_pad = pad if pad >= 0 else w.shape[0] + pad
        out = out.masked_fill((flat == real_pad).unsqueeze(-1), 0.0)
    return {"Out": out}


register_op("lookup_table_v2")(_lookup_table)


def _ln_stats_consumed(ctx, op):
    """True when this layer_norm's Mean/Variance outputs are read or
    fetched -- the fused kernel does not produce them."""
    return ctx.wants(op, "Mean") or ctx.wants(op, "Variance")


@register_op("layer_norm")
def _layer_norm(ctx, op, ins):
    x = first(ins, "X")
    scale = first(ins, "Scale")
    bias = first(ins, "Bias")
    # optional residual folded in by core/passes.py fuse_ln_residual
    residual = first(ins, "Residual")
    if residual is not None:
        residual = match_dtype(x, residual)
    eps = op.attr("epsilon", 1e-5)
    begin = op.attr("begin_norm_axis", 1)
    if (begin == x.dim() - 1 and scale is not None and bias is not None
            and not _ln_stats_consumed(ctx, op)):
        # one pass: residual add + stats + affine; Mean/Variance stay unset
        return {"Y": fused_ln_residual(x, residual, scale, bias, float(eps))}
    if residual is not None:
        x = x + residual
    # statistics in float32 even for bf16 activations
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    axes = tuple(range(begin, x.dim()))
    mean = xf.mean(axes, keepdim=True)
    var = xf.var(axes, correction=0, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        y = y * match_dtype(y, scale).reshape(norm_shape)
    if bias is not None:
        y = y + match_dtype(y, bias).reshape(norm_shape)
    lead = tuple(x.shape[:begin])
    return {"Y": y, "Mean": mean.reshape(lead), "Variance": var.reshape(lead)}


@register_op("dropout")
def _dropout(ctx, op, ins):
    """Training: keep each element with probability 1 - p, drawn from the
    run's generator (or a generator seeded by the op's `seed` under
    fix_seed); upscale_in_train scales the kept ones by 1 / (1 - p).
    Inference: identity under upscale_in_train, x * (1 - p) under
    downgrade_in_infer.  The Mask slot is built only when something reads it."""
    x = first(ins, "X")
    p = op.attr("dropout_prob", 0.5)
    upscale = op.attr("dropout_implementation", "downgrade_in_infer") == "upscale_in_train"
    if op.attr("is_test", False) or ctx.is_test:
        out = x if upscale else x * (1.0 - p)
        mask = torch.ones_like(x) if ctx.wants(op, "Mask") else None
        return {"Out": out, "Mask": mask}
    if op.attr("fix_seed", False):  # the same mask every run: drawn once per plan
        seed = int(op.attr("seed", 0))
        keep = ctx.constant(("dropout", id(op), tuple(x.shape), seed), lambda: torch.rand(
            x.shape, generator=torch.Generator(device=x.device).manual_seed(seed),
            device=x.device) < (1.0 - p))
    else:
        keep = torch.rand(x.shape, generator=ctx.generator, device=x.device) < (1.0 - p)
    if upscale:
        out = torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))
    else:
        out = x * keep.to(x.dtype)
    mask = keep.to(x.dtype) if ctx.wants(op, "Mask") else None
    return {"Out": out, "Mask": mask}


@register_op("softmax")
def _softmax(ctx, op, ins):
    return {"Out": torch.softmax(first(ins, "X"), dim=op.attr("axis", -1))}


@register_op("cross_entropy")
def _cross_entropy(ctx, op, ins):
    """-log(x[label]) of a probability distribution x (x clipped to 1e-20),
    0 where the label equals ignore_index; with soft_label,
    -sum(label * log(x)) over the last axis."""
    x = first(ins, "X")
    label = first(ins, "Label")
    if op.attr("soft_label", False):
        return {"Y": -torch.sum(label * torch.log(torch.clamp(x, min=1e-20)), -1, keepdim=True)}
    idx = label if label.dim() == x.dim() and label.shape[-1] == 1 else label[..., None]
    # an ignored label may lie outside [0, V): gather a clamped index, masked below
    picked = torch.gather(x, -1, idx.long().clamp(0, x.shape[-1] - 1))
    loss = -torch.log(torch.clamp(picked, min=1e-20))
    ignore = op.attr("ignore_index", -100)
    return {"Y": torch.where(idx == ignore, torch.zeros((), dtype=loss.dtype, device=loss.device),
                             loss)}


@register_op("square_error_cost")
def _square_error_cost(ctx, op, ins):
    return {"Out": torch.square(first(ins, "X") - first(ins, "Y"))}


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, op, ins):
    """loss = lse(x) - x[label], reductions in float32.

    Hard labels over >= 2-D logits whose Softmax slot nothing reads take
    ops/cuda_kernels.py fused_softmax_xent (the kernel on the card, its plain
    version on the CPU).  Every other case, soft labels included, takes the
    composite, which builds Softmax only when it is read."""
    logits = first(ins, "Logits")
    label = first(ins, "Label")
    ignore = int(op.attr("ignore_index", -100))
    if not op.attr("soft_label", False) and logits.dim() >= 2 and not ctx.wants(op, "Softmax"):
        lab = label
        if lab.dim() == logits.dim() and lab.shape[-1] == 1:
            lab = lab[..., 0]
        lead = tuple(logits.shape[:-1])
        loss = fused_softmax_xent(logits.reshape(-1, logits.shape[-1]), lab.reshape(-1), ignore)
        return {"Loss": loss.reshape(lead + (1,))}
    # the max shift is a constant for autodiff, as jax.lax.stop_gradient
    m = logits.max(-1, keepdim=True).values.detach()
    shifted = (logits - m).float()
    sumexp = torch.exp(shifted).sum(-1, keepdim=True)
    lse = torch.log(sumexp) + m.float()
    softmax = (torch.exp(shifted) / sumexp).to(logits.dtype) if ctx.wants(op, "Softmax") else None
    if op.attr("soft_label", False):
        # -sum(label * (x - lse)) = lse*sum(label) - sum(label*x)
        wx = (label * logits).float().sum(-1, keepdim=True)
        loss = lse * label.float().sum(-1, keepdim=True) - wx
    else:
        idx = label if label.dim() == logits.dim() and label.shape[-1] == 1 else label[..., None]
        onehot = torch.arange(logits.shape[-1], device=logits.device) == idx
        picked = torch.where(onehot, logits, torch.zeros((), dtype=logits.dtype,
                                                         device=logits.device))
        loss = lse - picked.float().sum(-1, keepdim=True)
        loss = torch.where(idx == ignore, torch.zeros_like(loss), loss)
    return {"Loss": loss, "Softmax": softmax}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, op, ins):
    """max(x, 0) - x*z + log(1 + exp(-|x|)), 0 where the label equals
    ignore_index; with `normalize`, divided by the count of the other labels
    (at least 1)."""
    x = first(ins, "X")
    label = first(ins, "Label")
    loss = torch.clamp_min(x, 0.0) - x * label + torch.log1p(torch.exp(-torch.abs(x)))
    ignore = op.attr("ignore_index", -100)
    kept = label != ignore
    loss = torch.where(kept, loss, torch.zeros((), dtype=loss.dtype, device=loss.device))
    if op.attr("normalize", False):
        loss = loss / torch.clamp_min(kept.to(x.dtype).sum(), 1.0)
    return {"Out": loss}


@register_op("fused_attention")
def _fused_attention(ctx, op, ins):
    """Scaled-dot-product attention over (B, H, L, dh) at every length:
    ops/cuda_attention.py fused_sdpa (the flash kernels on the card, forward
    and backward; the plain versions on the CPU).  One contract, the JAX
    composite's, where the JAX package also sends kv >= 2048 to the stock
    flash kernel on a TPU (ROADMAP C: that kernel's bias and causal rules
    differ from the composite's).  score_dtype="bfloat16" takes the kernels'
    bf16-score variant (the composite's rounding, :680-684)."""
    q = first(ins, "Q")
    k = first(ins, "K")
    v = first(ins, "V")
    bias = first(ins, "Bias")
    causal = bool(op.attr("causal", False))
    scale = op.attr("scale", None)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    score_bf16 = op.attr("score_dtype", "float32") == "bfloat16"
    return {"Out": fused_sdpa(q, k, v, bias, causal, float(scale), score_bf16)}


@register_op("top_k")
def _top_k(ctx, op, ins):
    """The k largest along the last axis; indices int32 (the x32 rule)."""
    vals, idx = torch.topk(first(ins, "X"), op.attr("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx.to(canon_dtype("int64"))}


@register_op("accuracy")
def _accuracy(ctx, op, ins):
    """Share of rows whose label is among their top-k indices; Correct and
    Total int32 [1]."""
    indices = first(ins, "Indices")
    label = first(ins, "Label")
    correct = (indices == label.to(indices.dtype)).any(-1).sum(dtype=torch.int32)
    total = indices.shape[0]
    return {
        "Accuracy": (correct.float() / float(total)).reshape(1),
        "Correct": correct.reshape(1),
        "Total": torch.full((1,), total, dtype=torch.int32, device=indices.device),
    }


@register_op("label_smooth")
def _label_smooth(ctx, op, ins):
    """(1 - eps) * x + eps * prior, the prior uniform over the last axis
    unless PriorDist is given."""
    x = first(ins, "X")
    eps = op.attr("epsilon", 0.1)
    prior = first(ins, "PriorDist")
    if prior is not None:
        return {"Out": (1.0 - eps) * x + eps * prior}
    return {"Out": (1.0 - eps) * x + eps / x.shape[-1]}


register_op("depthwise_conv2d")(_conv2d)


def conv2d_transpose_math(x, w, strides=(1, 1), pads=(0, 0), dilations=(1, 1), groups=1):
    """Transposed conv, fluid filter layout (in, out / groups, kh, kw): the
    JAX package's lhs-dilated conv with the flipped kernel
    (conv2d_transpose_math) is F.conv_transpose2d with the same padding.
    Shared by the op lowering and the dygraph Conv2DTranspose layer."""
    return F.conv_transpose2d(x, w, None, tuple(strides), (pads[0], pads[1]), 0,
                              groups or 1, tuple(dilations))


def conv3d_transpose_math(x, w, strides=(1, 1, 1), pads=(0, 0, 0), dilations=(1, 1, 1),
                          groups=1):
    """3-D transposed conv, filter (in, out / groups, kd, kh, kw)
    (paddle_tpu/ops/nn_ops.py conv3d_transpose_math); shared as above."""
    return F.conv_transpose3d(x, w, None, tuple(strides), tuple(pads), 0, groups or 1,
                              tuple(dilations))


@register_op("conv2d_transpose")
@register_op("depthwise_conv2d_transpose")
def _conv2d_transpose(ctx, op, ins):
    x = first(ins, "Input")
    w = match_dtype(x, first(ins, "Filter"))
    return {"Output": conv2d_transpose_math(
        x, w, op.attr("strides", [1, 1]), list(op.attr("paddings", [0, 0])),
        op.attr("dilations", [1, 1]), op.attr("groups", 1))}


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, op, ins):
    return {"Output": conv3d_transpose_math(
        first(ins, "Input"), first(ins, "Filter"), op.attr("strides", [1, 1, 1]),
        op.attr("paddings", [0, 0, 0]), op.attr("dilations", [1, 1, 1]), op.attr("groups", 1))}


def _interp_2d(x, out_h, out_w, method, align_corners, align_mode=1):
    """Bilinear or nearest resize of NCHW by Fluid's rules
    (paddle_tpu/ops/nn_ops.py _interp_2d, reference interpolate_op.h):
    align_corners maps the corners onto each other; otherwise align_mode 0
    is the half-pixel rule (dst + 0.5) * scale - 0.5, align_mode 1 (Fluid's
    default) the plain scaling dst * scale, which F.interpolate has not."""
    n, c, h, w = x.shape
    dev = x.device
    f32 = torch.float32
    if method == "nearest":
        if align_corners:
            hi = torch.round(torch.linspace(0.0, h - 1.0, out_h, device=dev)).long()
            wi = torch.round(torch.linspace(0.0, w - 1.0, out_w, device=dev)).long()
        else:
            hi = torch.floor(torch.arange(out_h, device=dev, dtype=f32) * (h / out_h)).long()
            wi = torch.floor(torch.arange(out_w, device=dev, dtype=f32) * (w / out_w)).long()
        return x.index_select(2, hi).index_select(3, wi)

    def src(out_n, in_n):
        if align_corners and out_n > 1:
            return torch.linspace(0.0, in_n - 1.0, out_n, device=dev)
        if align_mode == 1:
            return torch.arange(out_n, device=dev, dtype=f32) * (in_n / out_n)
        return torch.clamp_min((torch.arange(out_n, device=dev, dtype=f32) + 0.5)
                               * (in_n / out_n) - 0.5, 0.0)

    ys, xs = src(out_h, h), src(out_w, w)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0).to(x.dtype).reshape(1, 1, out_h, 1)
    wx = (xs - x0).to(x.dtype).reshape(1, 1, 1, out_w)
    r0, r1 = x.index_select(2, y0), x.index_select(2, y1)
    top = r0.index_select(3, x0) * (1 - wx) + r0.index_select(3, x1) * wx
    bot = r1.index_select(3, x0) * (1 - wx) + r1.index_select(3, x1) * wx
    return top * (1 - wy) + bot * wy


def _interp_size(op, x):
    out_h, out_w = op.attr("out_h"), op.attr("out_w")
    scale = op.attr("scale", 0.0)
    if scale:
        out_h, out_w = int(x.shape[2] * scale), int(x.shape[3] * scale)
    return out_h, out_w


@register_op("bilinear_interp")
def _bilinear_interp(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": _interp_2d(x, *_interp_size(op, x), "bilinear",
                              op.attr("align_corners", True), op.attr("align_mode", 1))}


@register_op("nearest_interp")
def _nearest_interp(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": _interp_2d(x, *_interp_size(op, x), "nearest", op.attr("align_corners", True))}


@register_op("group_norm")
def _group_norm(ctx, op, ins):
    """Normalization within channel groups of [N, C, *], float32 statistics."""
    x = first(ins, "X")
    scale = first(ins, "Scale")
    bias = first(ins, "Bias")
    eps = op.attr("epsilon", 1e-5)
    groups = op.attr("groups", 1)
    n, c = x.shape[0], x.shape[1]
    xf = x.float().reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xf.dim()))
    mean = xf.mean(axes, keepdim=True)
    var = xf.var(axes, correction=0, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    cshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    return {"Y": y.to(x.dtype), "Mean": mean.reshape(n, groups), "Variance": var.reshape(n, groups)}


@register_op("instance_norm")
def _instance_norm(ctx, op, ins):
    """Per-(sample, channel) normalization, float32 statistics."""
    x = first(ins, "X")
    scale = first(ins, "Scale")
    bias = first(ins, "Bias")
    eps = op.attr("epsilon", 1e-5)
    xf = x.float()
    axes = tuple(range(2, x.dim()))
    mean = xf.mean(axes, keepdim=True)
    var = xf.var(axes, correction=0, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    cshape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    n, c = x.shape[0], x.shape[1]
    return {"Y": y.to(x.dtype), "SavedMean": mean.reshape(n, c), "SavedVariance": var.reshape(n, c)}


@register_op("prelu")
def _prelu(ctx, op, ins):
    """x where x > 0, else alpha * x; alpha one value, one a channel or one
    an element."""
    x = first(ins, "X")
    alpha = first(ins, "Alpha")
    mode = op.attr("mode", "all")
    if mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "element":
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    else:
        a = alpha.reshape(())
    return {"Out": torch.where(x > 0, x, a * x)}


@register_op("log_softmax")
def _log_softmax(ctx, op, ins):
    return {"Out": torch.log_softmax(first(ins, "X"), dim=op.attr("axis", -1))}


@register_op("arg_max")
def _arg_max(ctx, op, ins):
    """The first index of the max along `axis`, int32 (the x32 rule)."""
    return {"Out": torch.argmax(first(ins, "X"), op.attr("axis", -1)).to(canon_dtype("int64"))}


@register_op("arg_min")
def _arg_min(ctx, op, ins):
    return {"Out": torch.argmin(first(ins, "X"), op.attr("axis", -1)).to(canon_dtype("int64"))}


@register_op("pad2d")
def _pad2d(ctx, op, ins):
    """NCHW spatial padding [top, bottom, left, right]: constant (pad_value),
    reflect or edge."""
    x = first(ins, "X")
    p = list(op.attr("paddings", [0, 0, 0, 0]))
    mode = op.attr("mode", "constant")
    pad = (p[2], p[3], p[0], p[1])
    if mode == "constant":
        return {"Out": F.pad(x, pad, value=op.attr("pad_value", 0.0))}
    return {"Out": F.pad(x, pad, mode={"reflect": "reflect", "edge": "replicate"}[mode])}


@register_op("crop")
def _crop(ctx, op, ins):
    """Static offsets and shape."""
    x = first(ins, "X")
    idx = tuple(slice(o, o + n) for o, n in zip(op.attr("offsets"), op.attr("shape")))
    return {"Out": x[idx]}


@register_op("huber_loss")
def _huber_loss(ctx, op, ins):
    x = first(ins, "X")
    y = first(ins, "Y")
    d = op.attr("delta", 1.0)
    r = y - x
    a = torch.abs(r)
    return {"Out": torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d)), "Residual": r}


@register_op("mean_iou")
def _mean_iou(ctx, op, ins):
    """Per-class intersection over union over the batch (reference
    mean_iou_op.h); classes absent from both predictions and labels leave
    the mean.  Class counts by index_add_ over a fixed C (integer sums:
    the same in any order), ids outside [0, C) dropped as segment_sum
    drops them."""
    pred = first(ins, "Predictions").reshape(-1).long()
    label = first(ins, "Labels").reshape(-1).long()
    C = op.attr("num_classes")

    def count(ids, vals):
        ok = (ids >= 0) & (ids < C)
        return torch.zeros(C, dtype=torch.int32, device=ids.device).index_add_(
            0, torch.where(ok, ids, torch.zeros_like(ids)), torch.where(ok, vals, 0).to(torch.int32))

    ones = torch.ones_like(pred)
    correct = count(label, (pred == label).long())
    pred_cnt = count(pred, ones)
    label_cnt = count(label, ones)
    union = pred_cnt + label_cnt - correct
    valid = union > 0
    iou = torch.where(valid, correct / torch.clamp_min(union, 1), torch.zeros((), device=pred.device))
    mean = iou.sum() / torch.clamp_min(valid.sum(), 1)
    return {"OutMeanIou": mean.float().reshape(1),
            "OutWrong": (pred_cnt + label_cnt - 2 * correct).to(torch.int32),
            "OutCorrect": correct}


@register_op("auc")
def _auc(ctx, op, ins):
    """Streaming ROC AUC (reference auc_op.h): the positive-class
    probability bucketed into num_thresholds + 1 bins per label polarity,
    accumulated into the persistable StatPos / StatNeg (in place when the
    outputs name them; integer index_add_, the same in any order), the ROC
    integrated by trapezoid in integers, the ratio in float32."""
    predict = first(ins, "Predict")
    label = first(ins, "Label").reshape(-1)
    stat_pos = first(ins, "StatPos")
    stat_neg = first(ins, "StatNeg")
    T = op.attr("num_thresholds", 4095)
    p = predict[:, 1] if predict.dim() == 2 and predict.shape[1] == 2 else predict.reshape(-1)
    bucket = torch.clamp((p * T).to(torch.int32), 0, T).long()
    is_pos = (label > 0).to(stat_pos.dtype)
    # in place where the output names the state itself (the layer's), so
    # a captured graph keeps updating the scope's tensors
    same = (op.output("StatPosOut") == op.input("StatPos")
            and op.output("StatNegOut") == op.input("StatNeg"))
    pos_new = (stat_pos if same else stat_pos.clone()).index_add_(0, bucket, is_pos)
    neg_new = (stat_neg if same else stat_neg.clone()).index_add_(0, bucket, 1 - is_pos)
    tp = torch.flip(torch.cumsum(torch.flip(pos_new, [0]), 0), [0]).to(pos_new.dtype)
    fp = torch.flip(torch.cumsum(torch.flip(neg_new, [0]), 0), [0]).to(neg_new.dtype)
    zero = tp.new_zeros(1)
    tp_ext, fp_ext = torch.cat([tp, zero]), torch.cat([fp, zero])
    area2 = ((fp_ext[:-1] - fp_ext[1:]) * (tp_ext[:-1] + tp_ext[1:])).sum().to(tp.dtype)
    denom2 = 2 * tp[0] * fp[0]
    auc_v = torch.where(denom2 > 0, area2.float() / torch.clamp_min(denom2, 1).float(),
                        torch.zeros((), device=tp.device))
    return {"AUC": auc_v.reshape(1), "StatPosOut": pos_new, "StatNegOut": neg_new}


def _bilinear_sample_grid(img, ys, xs):
    """Bilinear samples of img [N, C, H, W] at ys, xs [N, Ho, Wo] -> [N, C,
    Ho, Wo]: each of the four corners contributes only inside the image
    (reference deformable_im2col_bilinear)."""
    N, _, H, W = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[:, None]
    y0i, x0i = y0.long(), x0.long()
    n = torch.arange(N, device=img.device)[:, None, None]

    def corner(yi, xi):
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        v = img[n, :, torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)].permute(0, 3, 1, 2)
        return torch.where(ok[:, None], v, torch.zeros((), device=img.device))

    return ((corner(y0i, x0i) * (1 - wx) + corner(y0i, x0i + 1) * wx) * (1 - wy)
            + (corner(y0i + 1, x0i) * (1 - wx) + corner(y0i + 1, x0i + 1) * wx) * wy)


@register_op("deformable_conv")
def _deformable_conv(ctx, op, ins):
    """Deformable convolution v1 / v2 (reference deformable_conv_op.cc,
    paddle_tpu/ops/nn_ops.py _deformable_conv): each kernel tap samples the
    input bilinearly at its position plus a learned offset, times the
    modulation mask (v2); the sampled patches contract with the filter per
    group.  float32; gradients by autograd."""
    x_in = first(ins, "Input")
    x = x_in.float()
    offset = first(ins, "Offset").float()
    mask = first(ins, "Mask")
    mask = mask.float() if mask is not None else None
    w = first(ins, "Filter").float()
    strides = op.attr("strides", [1, 1])
    pads = op.attr("paddings", [0, 0])
    dil = op.attr("dilations", [1, 1])
    groups = op.attr("groups", 1) or 1
    dg = op.attr("deformable_groups", 1) or 1
    N, C, H, W = x.shape
    O, _, kh, kw = w.shape
    Ho = (H + 2 * pads[0] - (dil[0] * (kh - 1) + 1)) // strides[0] + 1
    Wo = (W + 2 * pads[1] - (dil[1] * (kw - 1) + 1)) // strides[1] + 1
    base_y = (torch.arange(Ho, device=x.device) * strides[0] - pads[0])[None, :, None].float()
    base_x = (torch.arange(Wo, device=x.device) * strides[1] - pads[1])[None, None, :].float()
    cpg = C // dg
    cols = []
    for k in range(kh * kw):
        i, j = k // kw, k % kw
        taps = []
        for g in range(dg):
            ys = base_y + i * dil[0] + offset[:, 2 * (g * kh * kw + k)]
            xs = base_x + j * dil[1] + offset[:, 2 * (g * kh * kw + k) + 1]
            v = _bilinear_sample_grid(x[:, g * cpg:(g + 1) * cpg], ys, xs)
            if mask is not None:
                v = v * mask[:, g * kh * kw + k][:, None]
            taps.append(v)
        cols.append(torch.cat(taps, 1))
    patches = torch.stack(cols, 2)  # [N, C, K, Ho, Wo]
    cg, og = C // groups, O // groups
    wk = w.reshape(O, cg, kh * kw)
    outs = [torch.einsum("nckhw,ock->nohw", patches[:, g * cg:(g + 1) * cg],
                         wk[g * og:(g + 1) * og]) for g in range(groups)]
    out = torch.cat(outs, 1) if groups > 1 else outs[0]
    return {"Output": out.to(x_in.dtype)}


register_op("deformable_conv_v1")(_deformable_conv)


@register_op("print")
def _print(ctx, op, ins):
    """layers.Print (reference print_op.cc): the input passes through, and
    its value is printed at execution, at most first_n times a plan (the
    JAX package's callback counts per compiled program).  A host read: no
    graph captures it (core/executor.py _HOST_READ)."""
    x = first(ins, "X")
    first_n = op.attr("first_n", -1)
    count = ctx.constant(("print", id(op)), lambda: {"n": 0})
    if first_n < 0 or count["n"] < first_n:
        print(f"{op.attr('message', '')}{x.detach().cpu().numpy()}", flush=True)
        count["n"] += 1
    return {"Out": x}


# --- build-time shape/dtype inference (core/analysis.py), as the JAX
# package registers it next to the same lowerings.  fused_attention has no
# rule there either.

from ..core import analysis as _A

_A.register_unary_infer("softmax", "log_softmax", "label_smooth", "prelu",
                        "sigmoid_cross_entropy_with_logits")
_A.register_elementwise_infer("square_error_cost")


def _infer_dropout(ctx):
    # one rule for both outputs: set_infer replaces, so a rule per output
    # would leave the first one registered unchecked
    xs = ctx.in_shape("X")
    dt = ctx.in_dtype("X")
    ctx.set_out("Out", xs, dt)
    ctx.set_out("Mask", xs, dt)


_A.register_rule(["dropout"], _infer_dropout)


def _conv_dim(in_sz, k, stride, pad_lo, pad_hi, dil):
    if in_sz == _A.DYN or k == _A.DYN:
        return _A.DYN
    eff = (k - 1) * dil + 1
    return (in_sz + pad_lo + pad_hi - eff) // stride + 1


def _infer_conv2d(ctx):
    xs = ctx.in_shape("Input")
    ws = ctx.in_shape("Filter")
    if xs is None or ws is None or len(xs) != 4 or len(ws) != 4:
        return
    op = ctx.op
    strides = list(op.attr("strides", [1, 1]))
    pads = list(op.attr("paddings", [0, 0]))
    dil = list(op.attr("dilations", [1, 1]))
    groups = op.attr("groups", 1) or 1
    if len(pads) == 4:
        plo, phi = (pads[0], pads[2]), (pads[1], pads[3])
    else:
        plo = phi = (pads[0], pads[1])
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    n, h, w, c = (xs[0], xs[1], xs[2], xs[3]) if nhwc else (xs[0], xs[2], xs[3], xs[1])
    o, i_g, kh, kw = ws
    if c != _A.DYN and i_g != _A.DYN and c != i_g * groups:
        ctx.fail(f"input channels {c} != Filter in-channels*groups {i_g}*{groups}",
                 var=op.input("Input")[0])
    oh = _conv_dim(h, kh, strides[0], plo[0], phi[0], dil[0])
    ow = _conv_dim(w, kw, strides[1], plo[1], phi[1], dil[1])
    ctx.set_out("Output", (n, oh, ow, o) if nhwc else (n, o, oh, ow), ctx.in_dtype("Input"))


_A.register_rule(["conv2d", "depthwise_conv2d"], _infer_conv2d)


def _infer_pool2d(ctx):
    xs = ctx.in_shape("X")
    if xs is None or len(xs) != 4:
        return
    op = ctx.op
    cl = op.attr("data_format", "NCHW") == "NHWC"
    n = xs[0]
    h, w = (xs[1], xs[2]) if cl else (xs[2], xs[3])
    c = xs[3] if cl else xs[1]
    if op.attr("global_pooling", False):
        oh = ow = 1
    else:
        ksize = list(op.attr("ksize", [2, 2]))
        strides = list(op.attr("strides", [1, 1]))
        pads = list(op.attr("paddings", [0, 0]))
        ceil = op.attr("ceil_mode", False)

        def od(in_sz, k, s, p):
            if in_sz == _A.DYN:
                return _A.DYN
            if ceil:
                return -(-(in_sz + 2 * p - k) // s) + 1
            return (in_sz + 2 * p - k) // s + 1

        oh = od(h, ksize[0], strides[0], pads[0])
        ow = od(w, ksize[1], strides[1], pads[1])
    ctx.set_out("Out", (n, oh, ow, c) if cl else (n, c, oh, ow), ctx.in_dtype("X"))


_A.register_rule(["pool2d"], _infer_pool2d)


def _infer_batch_norm(ctx):
    xs = ctx.in_shape("X")
    if xs is None:
        return
    layout = ctx.op.attr("data_layout", "NCHW")
    ch = xs[1 if layout == "NCHW" else len(xs) - 1]
    for slot in ("Scale", "Bias", "Mean", "Variance"):
        s = ctx.in_shape(slot)
        if s is not None and ch != _A.DYN and _A.unify_shape(s, (ch,)) is None:
            ctx.fail(f"{slot} shape {tuple(s)} != (C,) = ({ch},)", var=ctx.op.input(slot)[0])
    ctx.set_out("Y", xs, ctx.in_dtype("X"))
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        ctx.set_out(slot, (ch,) if ch != _A.DYN else None)


_A.register_rule(["batch_norm"], _infer_batch_norm)


def _infer_layer_norm(ctx):
    xs = ctx.in_shape("X")
    if xs is None:
        return
    begin = ctx.op.attr("begin_norm_axis", 1)
    ctx.set_out("Y", xs, ctx.in_dtype("X"))
    ctx.set_out("Mean", tuple(xs[:begin]))
    ctx.set_out("Variance", tuple(xs[:begin]))


_A.register_rule(["layer_norm"], _infer_layer_norm)


def _label_rank_match(logits, label):
    """label is index-shaped: logits' rank with a trailing 1, or one less."""
    return (len(label) == len(logits) and label[-1] == 1) or len(label) == len(logits) - 1


def _infer_softmax_ce(ctx):
    ls = ctx.in_shape("Logits")
    lab = ctx.in_shape("Label")
    if ls is None:
        return
    if lab is not None and not ctx.op.attr("soft_label", False):
        if not (_label_rank_match(ls, lab)
                and _A.unify_shape(tuple(ls[:-1]), tuple(lab[:len(ls) - 1])) is not None):
            ctx.fail(f"Label shape {tuple(lab)} does not index Logits{tuple(ls)} (want "
                     f"{tuple(ls[:-1])} or {tuple(ls[:-1]) + (1,)})",
                     var=ctx.op.input("Label")[0])
    ctx.set_out("Loss", tuple(ls[:-1]) + (1,))
    ctx.set_out("Softmax", ls, ctx.in_dtype("Logits"))


_A.register_rule(["softmax_with_cross_entropy"], _infer_softmax_ce)


def _infer_cross_entropy(ctx):
    xs = ctx.in_shape("X")
    if xs is None:
        return
    ctx.set_out("Y", tuple(xs[:-1]) + (1,), ctx.in_dtype("X"))


_A.register_rule(["cross_entropy"], _infer_cross_entropy)


def _infer_lookup_table(ctx):
    ws = ctx.in_shape("W")
    ids = ctx.in_shape("Ids")
    if ws is None or ids is None or not ids:
        return
    if ids[-1] == _A.DYN:
        return  # cannot tell whether the trailing dim-1 strip applies
    base = tuple(ids[:-1]) if ids[-1] == 1 else tuple(ids)
    ctx.set_out("Out", base + tuple(ws[1:]), ctx.in_dtype("W"))


_A.register_rule(["lookup_table", "lookup_table_v2"], _infer_lookup_table)


def _infer_top_k(ctx):
    xs = ctx.in_shape("X")
    if xs is None:
        return
    k = ctx.op.attr("k", 1)
    if xs[-1] != _A.DYN and k > xs[-1]:
        ctx.fail(f"k={k} > last dim of X{tuple(xs)}", var=ctx.op.input("X")[0])
    out = tuple(xs[:-1]) + (k,)
    ctx.set_out("Out", out, ctx.in_dtype("X"))
    ctx.set_out("Indices", out, "int64")


_A.register_rule(["top_k"], _infer_top_k)


def _infer_accuracy(ctx):
    ind = ctx.in_shape("Indices")
    lab = ctx.in_shape("Label")
    if ind is not None and lab is not None and _A.unify_dim(ind[0], lab[0]) is None:
        ctx.fail(f"Indices batch {ind[0]} != Label batch {lab[0]}", var=ctx.op.input("Label")[0])
    ctx.set_out("Accuracy", (1,))
    ctx.set_out("Correct", (1,))
    ctx.set_out("Total", (1,))


_A.register_rule(["accuracy"], _infer_accuracy)


def _infer_arg_extreme(ctx):
    xs = ctx.in_shape("X")
    if xs is None:
        return
    axis = ctx.op.attr("axis", -1) % len(xs)
    ctx.set_out("Out", tuple(d for i, d in enumerate(xs) if i != axis), "int64")


_A.register_rule(["arg_max", "arg_min"], _infer_arg_extreme)


# --- static cost rules (core/resource_plan.py) ------------------------------
# The JAX package's (paddle_tpu/ops/nn_ops.py).  They price what the JAX
# package prices, also where a kernel of the port does other work (ROADMAP
# C lists where they part).  `ring_attention`'s rule comes with its op
# (ROADMAP A10).

from ..core import resource_plan as _RP

_RP.register_elementwise_cost("square_error_cost", "label_smooth",
                              flops_per_elem=3.0)
_RP.register_elementwise_cost("dropout", flops_per_elem=2.0)
_RP.register_elementwise_cost("softmax", "log_softmax", "sigmoid_cross_entropy_with_logits",
                              flops_per_elem=8.0)
_RP.register_elementwise_cost("batch_norm", flops_per_elem=6.0)
_RP.register_elementwise_cost("layer_norm", flops_per_elem=10.0)
_RP.register_elementwise_cost("cross_entropy", flops_per_elem=8.0)


def _cost_softmax_ce(ctx):
    """Fused logsumexp formulation: the [N, V] logits stream once plus the
    Label and the [N, 1] Loss.  The [N, V] Softmax slot is not written
    when it is not fetched, so the default io_bytes would charge the
    dominant stream twice."""
    b = 0
    for slot in ("Logits", "Label"):
        n = ctx.in_name(slot)
        if n is not None:
            b += ctx.env.nbytes(n)
    n = ctx.out_name("Loss")
    if n is not None:
        b += ctx.env.nbytes(n)
    return 8.0 * ctx.in_elems("Logits"), float(b)


_RP.register_cost(["softmax_with_cross_entropy"], _cost_softmax_ce)
_RP.register_elementwise_cost("accuracy", "arg_max", "arg_min",
                              flops_per_elem=2.0)
_RP.register_elementwise_cost("top_k", flops_per_elem=6.0)


def _elems_xs(shape):
    n = 1
    for d in shape:
        n *= max(int(d), 1)
    return n


def _cost_conv2d(ctx):
    """2 * out_elems * (Cin/groups * kh * kw): the MACs of the implicit
    GEMM; traffic = img + filter + out."""
    out = ctx.out_shape("Output") or ctx.out_shape("Out")
    filt = ctx.in_shape("Filter")
    if out is None or filt is None:
        return float(ctx.out_elems_total()), ctx.io_bytes()
    cout = max(filt[0], 1)
    per_out = 1
    for d in filt:
        per_out *= max(int(d), 1)
    per_out //= cout  # Cin/groups * kh * kw
    n = 1
    for d in out:
        n *= max(int(d), 1)
    return 2.0 * n * per_out, ctx.io_bytes()


_RP.register_cost(["conv2d", "depthwise_conv2d"], _cost_conv2d)


def _cost_pool2d(ctx):
    k = ctx.attr("ksize", [1, 1]) or [1, 1]
    kk = 1
    for d in (k if isinstance(k, (list, tuple)) else [k]):
        kk *= max(int(d), 1)
    if ctx.attr("global_pooling", False):
        xs = ctx.in_shape("X")
        kk = _elems_xs(xs[2:]) if xs and len(xs) > 2 else kk
    out = ctx.out_elems("Out")
    return float(out * kk), ctx.io_bytes()


_RP.register_cost(["pool2d"], _cost_pool2d)


def _cost_lookup_table(ctx):
    """Row gather: traffic = gathered rows in + out plus the ids; the full
    table is not streamed (the default io_bytes would charge it)."""
    out_b = 0
    for n in ctx.op.output_arg_names:
        out_b += ctx.env.nbytes(n)
    ids_b = ctx.env.nbytes(ctx.in_name("Ids")) if ctx.in_name("Ids") else 0
    return 0.0, float(2 * out_b + ids_b)


_RP.register_cost(["lookup_table", "lookup_table_v2"], _cost_lookup_table)


def _cost_fused_attention(ctx):
    """QK^T + PV: 4 * B*H*Lq*Lk*dh FLOPs (2 products of 2 FLOPs a MAC),
    with no causal discount; the [B,H,Lq,Lk] scores never reach memory, so
    traffic is Q/K/V/Bias in + Out."""
    qs, ks = ctx.in_shape("Q"), ctx.in_shape("K")
    if qs is None or ks is None or len(qs) < 4 or len(ks) < 3:
        return float(ctx.out_elems_total()), ctx.io_bytes()
    b, h, lq, dh = qs[0], qs[1], qs[2], qs[3]
    lk = ks[2]
    return 4.0 * _elems_xs((b, h, lq, lk, dh)), ctx.io_bytes()


_RP.register_cost(["fused_attention"], _cost_fused_attention)
