"""Math lowerings: elementwise_add (with the fused bias-act epilogue),
elementwise_sub, _mul, _div, _max and _min, sum, activations, pow, clip,
clip_by_norm, scale, reduce_sum, mean, mul, matmul, less_than and
logical_and (counterpart of paddle_tpu/ops/math_ops.py), with their
build-time inference rules.

The `mul` / `matmul` products stay `torch.matmul`: the JAX package leaves
them to XLA outside any Pallas kernel."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import bcast_y_to_x, first, match_dtype
from .cuda_kernels import fused_bias_act

_UNARY = {
    "relu": torch.relu,
    "gelu": F.gelu,  # exact erf form, as jax.nn.gelu(approximate=False)
    "sigmoid": torch.sigmoid,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "sign": torch.sign,
}


def _unary(fn):
    def lower(ctx, op, ins):
        return {"Out": fn(first(ins, "X"))}

    return lower


for _name, _fn in _UNARY.items():
    register_op(_name)(_unary(_fn))


def _operands(op, ins):
    """X, and Y broadcast to X from `axis` in X's float type."""
    x = first(ins, "X")
    return x, match_dtype(x, bcast_y_to_x(x, first(ins, "Y"), op.attr("axis", -1)))


def _add(op, ins):
    x, y = _operands(op, ins)
    return x + y


def _binary(fn):
    def lower(ctx, op, ins):
        return {"Out": fn(*_operands(op, ins))}

    return lower


register_op("elementwise_sub")(_binary(torch.sub))
register_op("elementwise_mul")(_binary(torch.mul))
register_op("elementwise_div")(_binary(torch.div))
register_op("elementwise_min")(_binary(torch.minimum))
register_op("elementwise_max")(_binary(torch.maximum))


@register_op("sum")
def _sum(ctx, op, ins):
    """The summands added in order (the regularizers' grad + decay, the
    global norm's squared sums), with torch's type promotion as jnp's."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("clip")
def _clip(ctx, op, ins):
    return {"Out": torch.clamp(first(ins, "X"), op.attr("min"), op.attr("max"))}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, op, ins):
    """x scaled by max_norm / ||x||_2 where the norm exceeds max_norm."""
    x = first(ins, "X")
    max_norm = op.attr("max_norm")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": torch.where(norm > max_norm, x * (max_norm / norm), x)}


@register_op("pow")
def _pow(ctx, op, ins):
    """x ** factor, IEEE as jnp.power: 0 ** -0.5 is +inf (the noam schedule's
    first step reads it)."""
    return {"Out": torch.pow(first(ins, "X"), op.attr("factor", 1.0))}


@register_op("less_than")
def _less_than(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": torch.lt(x, bcast_y_to_x(x, first(ins, "Y"), op.attr("axis", -1)))}


@register_op("logical_and")
def _logical_and(ctx, op, ins):
    return {"Out": torch.logical_and(first(ins, "X"), first(ins, "Y"))}


@register_op("scale")
def _scale(ctx, op, ins):
    """x * scale + bias, or (x + bias) * scale without bias_after_scale."""
    x = first(ins, "X")
    scale = op.attr("scale", 1.0)
    bias = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        return {"Out": x * scale + bias}
    return {"Out": (x + bias) * scale}


@register_op("reduce_sum")
def _reduce_sum(ctx, op, ins):
    """Sum over `dim` (every axis with reduce_all), keeping the reduced axes
    as 1 with keep_dim.  An integer sum stays int32 (the x32 rule), where
    torch would widen it to int64."""
    x = first(ins, "X")
    if op.attr("reduce_all", False):
        axes = tuple(range(x.dim()))
    else:
        dim = op.attr("dim", [0])
        dim = [dim] if isinstance(dim, int) else dim
        axes = tuple(sorted({d % x.dim() for d in dim}))
    if not axes:
        return {"Out": x}
    out = x.sum(axes, keepdim=op.attr("keep_dim", False))
    return {"Out": out if x.is_floating_point() else out.to(torch.int32)}


@register_op("elementwise_add")
def _elementwise_add(ctx, op, ins):
    """Plain add, or -- after core/passes.py fuse_bias_act folded a relu/gelu
    consumer into the op (attr fuse_act) -- the fused bias-act epilogue for
    a 1-D bias over the last axis (ops/cuda_kernels.py fused_bias_act)."""
    act = op.attr("fuse_act", None)
    if not act:
        return {"Out": _add(op, ins)}
    x = first(ins, "X")
    y = first(ins, "Y")
    if (y.dim() == 1 and x.dim() >= 2 and y.shape[0] == x.shape[-1]
            and op.attr("axis", -1) in (-1, x.dim() - 1)):
        out = fused_bias_act(x.reshape(-1, x.shape[-1]), y, act)
        return {"Out": out.reshape(x.shape)}
    return {"Out": _UNARY[act](_add(op, ins))}


@register_op("mean")
def _mean(ctx, op, ins):
    # a (1,) tensor, as the reference's mean_op
    return {"Out": torch.mean(first(ins, "X")).reshape(1)}


@register_op("mul")
def _mul(ctx, op, ins):
    """Flatten x to 2-D at x_num_col_dims, y at y_num_col_dims, then GEMM."""
    x = first(ins, "X")
    y = match_dtype(x, first(ins, "Y"))
    xd = op.attr("x_num_col_dims", 1)
    yd = op.attr("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xd]), math.prod(xs[xd:]))
    y2 = y.reshape(math.prod(ys[:yd]), math.prod(ys[yd:]))
    return {"Out": torch.matmul(x2, y2).reshape(xs[:xd] + ys[yd:])}


@register_op("matmul")
def _matmul(ctx, op, ins):
    x = first(ins, "X")
    y = match_dtype(x, first(ins, "Y"))
    if op.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if op.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = op.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


# --- build-time shape/dtype inference (core/analysis.py), as the JAX
# package registers it next to the same lowerings

from ..core import analysis as _A

_A.register_elementwise_infer("elementwise_add", "elementwise_sub", "elementwise_mul",
                              "elementwise_div", "elementwise_max", "elementwise_min")
_A.register_elementwise_infer("less_than", "logical_and", out_dtype="bool")
_A.register_unary_infer(*_UNARY, "pow", "clip", "clip_by_norm", "scale")
_A.register_reduce_infer("reduce_sum")


def _infer_sum(ctx):
    out = None
    for i in range(ctx.n_inputs("X")):
        s = ctx.in_shape("X", i)
        if s is None:
            continue
        out = s if out is None else _A.fluid_broadcast(out, s, -1)
        if out is None:
            ctx.fail("summands have incompatible shapes", var=ctx.op.input("X")[i])
    ctx.set_out("Out", out, ctx.in_dtype("X"))


_A.register_rule(["sum"], _infer_sum)


def _infer_mean(ctx):
    ctx.set_out("Out", (1,), ctx.in_dtype("X"))


_A.register_rule(["mean"], _infer_mean)


def _infer_mul(ctx):
    xs = ctx.in_shape("X")
    ys = ctx.in_shape("Y")
    if xs is None or ys is None:
        return
    xd = ctx.op.attr("x_num_col_dims", 1)
    yd = ctx.op.attr("y_num_col_dims", 1)
    if not (0 < xd <= len(xs) and 0 < yd < len(ys) + 1):
        ctx.fail(f"num_col_dims ({xd},{yd}) out of range for X{tuple(xs)} Y{tuple(ys)}")
    inner_x = xs[xd:]
    inner_y = ys[:yd]
    if all(d != _A.DYN for d in inner_x) and all(d != _A.DYN for d in inner_y):
        if math.prod(inner_x) != math.prod(inner_y):
            ctx.fail(f"flattened contraction dims do not match: X{tuple(xs)} cols "
                     f"{tuple(inner_x)} vs Y{tuple(ys)} rows {tuple(inner_y)}",
                     var=ctx.op.input("Y")[0])
    ctx.set_out("Out", tuple(xs[:xd]) + tuple(ys[yd:]), ctx.in_dtype("X"))


_A.register_rule(["mul"], _infer_mul)


def _infer_matmul(ctx):
    xs = ctx.in_shape("X")
    ys = ctx.in_shape("Y")
    if xs is None or ys is None or len(xs) < 2 or len(ys) < 2:
        return
    if ctx.op.attr("transpose_X", False):
        xs = xs[:-2] + (xs[-1], xs[-2])
    if ctx.op.attr("transpose_Y", False):
        ys = ys[:-2] + (ys[-1], ys[-2])
    if _A.unify_dim(xs[-1], ys[-2]) is None:
        ctx.fail(f"contraction dims do not match: X[...,{xs[-1]}] vs Y[{ys[-2]},...]",
                 var=ctx.op.input("Y")[0])
    bx, by = xs[:-2], ys[:-2]
    if len(bx) < len(by):
        bx, by = by, bx
    batch = _A.fluid_broadcast(bx, by, -1) if by else tuple(bx)
    if batch is None:
        ctx.fail(f"batch dims do not broadcast: {tuple(xs[:-2])} vs {tuple(ys[:-2])}")
    ctx.set_out("Out", tuple(batch) + (xs[-2], ys[-1]), ctx.in_dtype("X"))


_A.register_rule(["matmul"], _infer_matmul)
