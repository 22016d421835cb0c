"""NN lowerings: lookup_table, layer_norm (with the fused residual),
dropout, softmax, softmax_with_cross_entropy and fused_attention
(counterpart of paddle_tpu/ops/nn_ops.py)."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from .common import first, flatten_lookup_ids, match_dtype
from .cuda_attention import MAX_SEQ, fused_sdpa, sdpa_plain
from .cuda_kernels import fused_ln_residual, fused_softmax_xent


@register_op("lookup_table")
def _lookup_table(ctx, op, ins):
    """ids carry a trailing dim of 1; padding_idx rows read as zeros."""
    w = first(ins, "W")
    flat = flatten_lookup_ids(first(ins, "Ids"))
    out = w[flat]
    pad = op.attr("padding_idx", None)
    if pad is not None:
        real_pad = pad if pad >= 0 else w.shape[0] + pad
        out = out.masked_fill((flat == real_pad).unsqueeze(-1), 0.0)
    return {"Out": out}


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
    gen = ctx.generator
    if op.attr("fix_seed", False):
        gen = torch.Generator(device=x.device).manual_seed(int(op.attr("seed", 0)))
    keep = torch.rand(x.shape, generator=gen, device=x.device) < (1.0 - p)
    if upscale:
        out = torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))
    else:
        out = x * keep.to(x.dtype)
    mask = keep.to(x.dtype) if ctx.wants(op, "Mask") else None
    return {"Out": out, "Mask": mask}


@register_op("softmax")
def _softmax(ctx, op, ins):
    return {"Out": torch.softmax(first(ins, "X"), dim=op.attr("axis", -1))}


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


@register_op("fused_attention")
def _fused_attention(ctx, op, ins):
    """Scaled-dot-product attention over (B, H, L, dh).  Up to MAX_SEQ keys
    and queries it is ops/cuda_attention.py fused_sdpa (the kernel on the
    card, its plain version on the CPU); longer sequences are the streaming
    flash kernel's, not ported yet."""
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
    if max(q.shape[2], k.shape[2]) <= MAX_SEQ:
        return {"Out": fused_sdpa(q, k, v, bias, causal, float(scale))}
    if q.device.type != "cpu":
        raise NotImplementedError(
            f"fused_attention over {max(q.shape[2], k.shape[2])} > {MAX_SEQ} positions needs "
            "the streaming flash kernel (paddle_tpu/ops/nn_ops.py:637, JAX's "
            "pallas.ops.tpu.flash_attention), which is not ported to the card yet")
    return {"Out": sdpa_plain(q, k, v, bias, causal, float(scale))}
