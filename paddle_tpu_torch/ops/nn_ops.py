"""NN lowerings: conv2d, pool2d, batch_norm (with the fused epilogue),
lookup_table (with its sparse gradient tap), layer_norm (with the fused
residual), dropout, softmax, cross_entropy, softmax_with_cross_entropy,
sigmoid_cross_entropy_with_logits, square_error_cost, fused_attention, top_k
and accuracy, with their build-time inference rules (counterpart of
paddle_tpu/ops/nn_ops.py).

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
    With a channel axis and spatial dims the normalization is the epilogue
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
        if fused_pass:
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
    differ from the composite's)."""
    q = first(ins, "Q")
    k = first(ins, "K")
    v = first(ins, "V")
    bias = first(ins, "Bias")
    causal = bool(op.attr("causal", False))
    scale = op.attr("scale", None)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if op.attr("score_dtype", "float32") == "bfloat16":
        raise NotImplementedError("fused_attention score_dtype='bfloat16' is not ported yet")
    return {"Out": fused_sdpa(q, k, v, bias, causal, float(scale))}


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


# --- build-time shape/dtype inference (core/analysis.py), as the JAX
# package registers it next to the same lowerings.  fused_attention has no
# rule there either.

from ..core import analysis as _A

_A.register_unary_infer("softmax", "label_smooth", "sigmoid_cross_entropy_with_logits")
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


_A.register_rule(["conv2d"], _infer_conv2d)


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
