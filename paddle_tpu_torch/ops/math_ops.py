"""Math lowerings (counterpart of paddle_tpu/ops/math_ops.py): the
elementwise family (elementwise_add with the fused bias-act epilogue), sum,
the activations, pow, clip, clip_by_norm, scale, the reductions, mean, mul,
matmul, the compare and logical ops, isfinite, the four fake-quantize ops
and the norm / fill tail, with their build-time inference rules (the
fake-quantize rules are registered by contrib/slim/quantization.py, as in
the JAX package).

The `mul` / `matmul` products stay `torch.matmul`: the JAX package leaves
them to XLA outside any Pallas kernel."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from .common import bcast_y_to_x, canon_dtype, first, match_dtype
from .cuda_kernels import fused_bias_act

_UNARY = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "logsigmoid": F.logsigmoid,
    "tanh": torch.tanh,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "abs": torch.abs,
    "square": torch.square,
    "reciprocal": torch.reciprocal,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round": torch.round,  # half to even, as jnp.round
    "sin": torch.sin,
    "cos": torch.cos,
    "gelu": F.gelu,  # exact erf form, as jax.nn.gelu(approximate=False)
    "softplus": lambda x: torch.logaddexp(x, x.new_zeros(())),
    "softsign": F.softsign,
    "tanh_shrink": lambda x: x - torch.tanh(x),
    "erf": torch.erf,
    "sign": torch.sign,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
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
        x, y = first(ins, "X"), first(ins, "Y")
        if isinstance(x, SelectedRows) and y.numel() == 1:
            # SelectedRows op scalar (AMP's gradient unscale, clip-by-value):
            # the value slab, the rows kept, as the JAX package's _ew
            yv = y.reshape(()).to(x.values.dtype)
            return {"Out": SelectedRows(x.rows, fn(x.values, yv), x.height)}
        return {"Out": fn(*_operands(op, ins))}

    return lower


register_op("elementwise_sub")(_binary(torch.sub))
register_op("elementwise_mul")(_binary(torch.mul))
register_op("elementwise_div")(_binary(torch.div))
register_op("elementwise_min")(_binary(torch.minimum))
register_op("elementwise_max")(_binary(torch.maximum))
register_op("elementwise_pow")(_binary(torch.pow))
register_op("elementwise_mod")(_binary(torch.remainder))  # the divisor's sign, as jnp.mod
register_op("elementwise_floordiv")(_binary(torch.floor_divide))


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


def _cmp(fn):
    def lower(ctx, op, ins):
        x = first(ins, "X")
        return {"Out": fn(x, bcast_y_to_x(x, first(ins, "Y"), op.attr("axis", -1)))}

    return lower


for _name, _fn in {"equal": torch.eq, "not_equal": torch.ne, "less_than": torch.lt,
                   "less_equal": torch.le, "greater_than": torch.gt,
                   "greater_equal": torch.ge}.items():
    register_op(_name)(_cmp(_fn))


@register_op("logical_and")
def _logical_and(ctx, op, ins):
    return {"Out": torch.logical_and(first(ins, "X"), first(ins, "Y"))}


@register_op("logical_or")
def _logical_or(ctx, op, ins):
    return {"Out": torch.logical_or(first(ins, "X"), first(ins, "Y"))}


@register_op("logical_not")
def _logical_not(ctx, op, ins):
    return {"Out": torch.logical_not(first(ins, "X"))}


@register_op("isfinite")
def _isfinite(ctx, op, ins):
    """One bool [1]: every value finite (of a SelectedRows gradient, only
    its touched rows)."""
    x = first(ins, "X")
    if isinstance(x, SelectedRows):
        x = x.values
    return {"Out": torch.isfinite(x).all().reshape(1)}


# --- the fake-quantize family (QAT): round to a symmetric bit_length-bit grid
# in the forward, straight through in the backward.  The straight-through form
# is the JAX package's x + stop_gradient(out - x), in that order, so that Out
# has its bits; the scales stay on the device (no host read, so a QAT step
# captures).  Mixed dtypes promote as jnp does: a 0-d float32 scale widens a
# bf16 X, where torch's 0-d rule would narrow the scale.  The division by the
# constant qmax is a product with its reciprocal: XLA rewrites the JAX
# lowering's `/ qmax` so, and torch on CUDA divides by a host scalar so, while
# torch on the CPU would divide (one float32 ulp apart).


def _qmax(op) -> float:
    return float(2 ** (op.attr("bit_length", 8) - 1) - 1)


def _straight_through(x, out):
    return x + (out - x).detach()


@register_op("fake_quantize_abs_max")
def _fake_quantize_abs_max(ctx, op, ins):
    x = first(ins, "X")
    qmax = _qmax(op)
    scale = x.abs().amax()
    safe = torch.clamp_min(scale, 1e-8)
    q = torch.round(x / safe * qmax)
    return {"Out": _straight_through(x, q * safe * (1.0 / qmax)), "OutScale": scale.reshape(1)}


@register_op("fake_channel_wise_quantize_abs_max")
def _fake_channel_wise_quantize_abs_max(ctx, op, ins):
    """One grid per slice along `quant_axis` (0: conv filters; 1: mul /
    matmul Y); OutScale is [C]."""
    x = first(ins, "X")
    axis = op.attr("quant_axis", 0)
    qmax = _qmax(op)
    moved = torch.movedim(x, axis, 0)
    scale = moved.reshape(moved.shape[0], -1).abs().amax(1)
    safe = torch.clamp_min(scale, 1e-8).reshape((-1,) + (1,) * (x.dim() - 1))
    q = torch.round(moved / safe * qmax)
    out = torch.movedim(q * safe * (1.0 / qmax), 0, axis)
    return {"Out": _straight_through(x, out), "OutScale": scale}


@register_op("fake_quantize_moving_average_abs_max")
def _fake_quantize_ma_abs_max(ctx, op, ins):
    """The scale is moving_rate * InScale + (1 - moving_rate) * max|X| once
    InScale is positive; X / scale is clipped to [-1, 1]."""
    x = first(ins, "X")
    in_scale = first(ins, "InScale").reshape(())
    rate = op.attr("moving_rate", 0.9)
    qmax = _qmax(op)
    dt = torch.promote_types(x.dtype, in_scale.dtype)
    cur = x.abs().amax()
    mixed = (rate * in_scale).to(dt) + ((1 - rate) * cur).to(dt)
    scale = torch.where(in_scale > 0, mixed, cur.to(dt))
    safe = torch.clamp_min(scale, 1e-8)
    xw = x.to(dt)
    q = torch.round(torch.clamp(xw / safe, -1.0, 1.0) * qmax)
    return {"Out": _straight_through(xw, q * safe * (1.0 / qmax)),
            "OutScale": scale.reshape(1)}


@register_op("fake_dequantize_max_abs")
def _fake_dequantize_max_abs(ctx, op, ins):
    x = first(ins, "X")
    scale = first(ins, "Scale").reshape(())
    dt = torch.promote_types(x.dtype, scale.dtype)
    return {"Out": x.to(dt) * scale.to(dt) * (1.0 / op.attr("max_range", 127.0))}


# --- the attr'd activations


def _attr_unary(fn):
    def lower(ctx, op, ins):
        return {"Out": fn(first(ins, "X"), op)}

    return lower


def _softshrink(x, op):
    lam = op.attr("lambda", 0.5)
    return torch.where(x > lam, x - lam, torch.where(x < -lam, x + lam, x.new_zeros(())))


_ATTR_UNARY = {
    "hard_shrink": lambda x, op: torch.where(x.abs() > op.attr("threshold", 0.5), x,
                                             x.new_zeros(())),
    "stanh": lambda x, op: op.attr("scale_b", 1.7159) * torch.tanh(op.attr("scale_a", 0.67) * x),
    "leaky_relu": lambda x, op: torch.where(x >= 0, x, op.attr("alpha", 0.02) * x),
    "elu": lambda x, op: F.elu(x, alpha=op.attr("alpha", 1.0)),
    "hard_sigmoid": lambda x, op: torch.clamp(op.attr("slope", 0.2) * x + op.attr("offset", 0.5),
                                              0.0, 1.0),
    "swish": lambda x, op: x * torch.sigmoid(op.attr("beta", 1.0) * x),
    "softshrink": _softshrink,
}
for _name, _fn in _ATTR_UNARY.items():
    register_op(_name)(_attr_unary(_fn))


@register_op("scale")
def _scale(ctx, op, ins):
    """x * scale + bias, or (x + bias) * scale without bias_after_scale."""
    x = first(ins, "X")
    scale = op.attr("scale", 1.0)
    bias = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        return {"Out": x * scale + bias}
    return {"Out": (x + bias) * scale}


def _reduce_axes(op, x):
    if op.attr("reduce_all", False):
        return tuple(range(x.dim()))
    dim = op.attr("dim", [0])
    dim = [dim] if isinstance(dim, int) else dim
    return tuple(sorted({d % x.dim() for d in dim}))


def _prod(x, axes, keepdim):
    for a in sorted(axes, reverse=True):
        x = x.prod(a, keepdim=keepdim)
    return x


def _mean(x, axes, keepdim):
    """jnp.mean: a low-precision float accumulates in float32 and rounds
    once; an integer mean is float32."""
    if not x.is_floating_point():
        return x.to(torch.float32).mean(axes, keepdim=keepdim)
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.to(torch.float32).mean(axes, keepdim=keepdim).to(x.dtype)
    return x.mean(axes, keepdim=keepdim)


_REDUCE = {
    "reduce_sum": lambda x, axes, keep: x.sum(axes, keepdim=keep),
    "reduce_mean": _mean,
    "reduce_max": lambda x, axes, keep: x.amax(axes, keepdim=keep),
    "reduce_min": lambda x, axes, keep: x.amin(axes, keepdim=keep),
    "reduce_prod": _prod,
}


def _reduce(fn):
    def lower(ctx, op, ins):
        """Over `dim` (every axis with reduce_all), keeping the reduced axes
        as 1 with keep_dim.  An integer sum or product stays int32 (the x32
        rule), where torch would widen it to int64."""
        x = first(ins, "X")
        axes = _reduce_axes(op, x)
        if not axes:
            return {"Out": x}
        out = fn(x, axes, op.attr("keep_dim", False))
        if not x.is_floating_point() and out.dtype == torch.int64:
            out = out.to(torch.int32)
        return {"Out": out}

    return lower


for _name, _fn in _REDUCE.items():
    register_op(_name)(_reduce(_fn))


@register_op("frobenius_norm")
def _frobenius_norm(ctx, op, ins):
    # over every element, a 0-d result, as the JAX lowering
    return {"Out": torch.sqrt(torch.sum(torch.square(first(ins, "X"))))}


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


# --- the norm and fill tail (reference minus_op.cc, l1_norm_op.cc,
# squared_l2_norm_op.cc, squared_l2_distance_op.cc, fill_op.cc,
# fill_zeros_like_op.cc)

@register_op("minus")
def _minus(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": x - match_dtype(x, first(ins, "Y"))}


@register_op("l1_norm")
def _l1_norm(ctx, op, ins):
    return {"Out": torch.sum(torch.abs(first(ins, "X"))).reshape(())}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, op, ins):
    return {"Out": torch.sum(torch.square(first(ins, "X"))).reshape(())}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, op, ins):
    """Row-wise squared distance; Y may be one row [1, D] broadcast to X."""
    x = first(ins, "X")
    y = match_dtype(x, first(ins, "Y"))
    sub = x.reshape(x.shape[0], -1) - y.reshape(y.shape[0], -1)
    return {"sub_result": sub, "Out": torch.sum(torch.square(sub), dim=1, keepdim=True)}


@register_op("fill")
def _fill(ctx, op, ins):
    """The `value` attr as a tensor of `shape` (via float32, as the JAX
    lowering), copied to the device once per plan."""
    shape = tuple(op.attr("shape"))
    dtype = canon_dtype(op.attr("dtype", "float32"))
    out = ctx.constant((op.type, id(op)), lambda: torch.as_tensor(
        np.asarray(op.attr("value"), np.float32).reshape(shape)).to(device=ctx.device, dtype=dtype))
    return {"Out": out.clone()}


@register_op("fill_zeros_like2")
def _fill_zeros_like2(ctx, op, ins):
    x = first(ins, "X")
    dt = op.attr("dtype", None)
    dtype = x.dtype if dt in (None, -1) else canon_dtype(dt)
    return {"Out": torch.zeros(x.shape, dtype=dtype, device=x.device)}


# --- build-time shape/dtype inference (core/analysis.py), as the JAX
# package registers it next to the same lowerings

from ..core import analysis as _A

_A.register_elementwise_infer("elementwise_add", "elementwise_sub", "elementwise_mul",
                              "elementwise_div", "elementwise_max", "elementwise_min",
                              "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
                              "minus")
# logical_xor takes its rule beside its lowering (ops/tail_ops.py)
_A.register_elementwise_infer(*sorted(_A.BOOL_OUT_OPS - {"logical_xor"}), out_dtype="bool")
_A.register_unary_infer("logical_not", out_dtype="bool")
_A.register_unary_infer(*_UNARY, *_ATTR_UNARY, "pow", "clip", "clip_by_norm", "scale")
_A.register_reduce_infer(*_REDUCE)


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


# --- static cost rules (core/resource_plan.py) ------------------------------
# The JAX package's (paddle_tpu/ops/math_ops.py): the families of the infer
# rules above, FLOPs and bytes moved instead of shapes.  Transcendental
# unaries are a few FLOPs an element; the dense contractions exact 2*M*K*N.

from ..core import resource_plan as _RP

_RP.register_elementwise_cost(
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv", "minus",
    "logical_not", "relu", "relu6", "abs", "square", "floor", "ceil",
    "round", "sign", "reciprocal", "pow", "clip", "hard_shrink",
    "leaky_relu", "hard_sigmoid", "softshrink", "clip_by_norm",
    *sorted(_A.BOOL_OUT_OPS - {"logical_xor"}))
_RP.register_elementwise_cost(
    "sigmoid", "logsigmoid", "tanh", "exp", "log", "sqrt", "rsqrt", "sin",
    "cos", "gelu", "softplus", "softsign", "tanh_shrink", "erf", "tan",
    "asin", "acos", "atan", "sinh", "cosh", "log2", "log10", "log1p",
    "expm1", "stanh", "elu", "swish", flops_per_elem=8.0)


def _cost_reduce(ctx):
    return float(ctx.in_elems("X")), ctx.io_bytes()


_RP.register_cost(["reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
                   "reduce_prod", "mean"], _cost_reduce)


def _cost_sum(ctx):
    total = sum(ctx.in_elems("X", i) for i in range(len(ctx.op.input("X"))))
    return float(total), ctx.io_bytes()


_RP.register_cost(["sum"], _cost_sum)


def _elems_of(shape):
    n = 1
    for d in shape:
        n *= max(int(d), 1)
    return n


def _cost_mul(ctx):
    xs, ys = ctx.in_shape("X"), ctx.in_shape("Y")
    if xs is None or ys is None:
        return float(ctx.out_elems_total()), ctx.io_bytes()
    xd = ctx.attr("x_num_col_dims", 1)
    yd = ctx.attr("y_num_col_dims", 1)
    rows = _elems_of(xs[:xd])
    inner = _elems_of(xs[xd:])
    cols = _elems_of(ys[yd:])
    return 2.0 * rows * inner * cols, ctx.io_bytes()


def _cost_matmul(ctx):
    xs, ys = ctx.in_shape("X"), ctx.in_shape("Y")
    if xs is None or ys is None or len(xs) < 2 or len(ys) < 2:
        return float(ctx.out_elems_total()), ctx.io_bytes()
    if ctx.attr("transpose_X", False):
        xs = xs[:-2] + (xs[-1], xs[-2])
    if ctx.attr("transpose_Y", False):
        ys = ys[:-2] + (ys[-1], ys[-2])
    batch = _elems_of(ctx.out_shape("Out")[:-2]) if ctx.out_shape("Out") else _elems_of(xs[:-2])
    return 2.0 * batch * xs[-2] * xs[-1] * ys[-1], ctx.io_bytes()


_RP.register_cost(["mul"], _cost_mul)
_RP.register_cost(["matmul"], _cost_matmul)
