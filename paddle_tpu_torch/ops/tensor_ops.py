"""Tensor creation / manipulation lowerings (counterpart of
paddle_tpu/ops/tensor_ops.py): fill_constant, assign, assign_value, the random
fills, cast, reshape2, transpose2, expand, one_hot and increment."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import as_torch_dtype
from ..core.registry import register_op
from .common import canon_dtype, first


def _draw(ctx, op, shape, draw):
    """`draw(shape, generator)`: from the run's generator, or, where an
    op-level `seed` attr pins the stream, the same values every run, drawn
    once per plan from a generator of that seed (a copy, since the caller
    may write its output in place)."""
    seed = op.attr("seed", 0)
    if not seed:
        return draw(shape, ctx.generator)
    return ctx.constant((op.type, id(op), shape, int(seed)), lambda: draw(
        shape, torch.Generator(device=ctx.device).manual_seed(int(seed)))).clone()


@register_op("fill_constant")
def _fill_constant(ctx, op, ins):
    shape = tuple(op.attr("shape", []))
    return {"Out": torch.full(shape, op.attr("value", 0.0), dtype=canon_dtype(op.attr("dtype", "float32")),
                              device=ctx.device)}


@register_op("uniform_random")
def _uniform_random(ctx, op, ins):
    shape = tuple(op.attr("shape"))
    lo, hi = op.attr("min", -1.0), op.attr("max", 1.0)
    u = _draw(ctx, op, shape, lambda s, g: torch.rand(s, generator=g, dtype=torch.float32,
                                                      device=ctx.device))
    return {"Out": (u * (hi - lo) + lo).to(as_torch_dtype(op.attr("dtype", "float32")))}


@register_op("gaussian_random")
def _gaussian_random(ctx, op, ins):
    shape = tuple(op.attr("shape"))
    z = _draw(ctx, op, shape, lambda s, g: torch.randn(s, generator=g, dtype=torch.float32,
                                                       device=ctx.device))
    out = op.attr("mean", 0.0) + op.attr("std", 1.0) * z
    return {"Out": out.to(as_torch_dtype(op.attr("dtype", "float32")))}


@register_op("cast")
def _cast(ctx, op, ins):
    return {"Out": first(ins, "X").to(canon_dtype(op.attr("out_dtype", op.attr("dtype", "float32"))))}


def _xshape(ctx, op, x):
    # the reference's shape-carrier slot; only built when something reads it
    if ctx.wants(op, "XShape"):
        return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    return None


@register_op("reshape2")
def _reshape2(ctx, op, ins):
    x = first(ins, "X")
    # fluid semantics: 0 copies the input dim, -1 infers
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(op.attr("shape"))]
    return {"Out": x.reshape(shape), "XShape": _xshape(ctx, op, x)}


@register_op("transpose2")
def _transpose2(ctx, op, ins):
    x = first(ins, "X")
    # materialized, as the JAX transpose is: the kernels downstream take
    # contiguous tensors
    return {"Out": x.permute(*op.attr("axis")).contiguous(), "XShape": _xshape(ctx, op, x)}


@register_op("one_hot")
def _one_hot(ctx, op, ins):
    """float32 one-hot over a trailing `depth` axis (ids of shape [..., 1]
    drop their last axis first); an id outside [0, depth) gives a zero row,
    as jax.nn.one_hot."""
    x = first(ins, "X")
    flat = x.reshape(x.shape[:-1]) if x.dim() and x.shape[-1] == 1 else x
    classes = torch.arange(op.attr("depth"), device=x.device)
    return {"Out": (flat[..., None] == classes).to(torch.float32)}


@register_op("increment")
def _increment(ctx, op, ins):
    """x + step in x's own dtype: an int counter stays int."""
    x = first(ins, "X")
    step = op.attr("step", 1.0)
    return {"Out": x + (step if x.is_floating_point() else int(step))}


@register_op("assign_value")
def _assign_value(ctx, op, ins):
    """A constant from the op's `values` attr, int64 / float64 as int32 /
    float32 (the x32 rule): copied to the device once per plan, then a
    device copy a run."""
    out = ctx.constant((op.type, id(op)), lambda: torch.as_tensor(np.asarray(op.attr("values"))).to(
        device=ctx.device, dtype=canon_dtype(op.attr("dtype", "float32"))))
    shape = op.attr("shape")
    return {"Out": (out.reshape(shape) if shape else out).clone()}


@register_op("expand")
def _expand(ctx, op, ins):
    """Tile x `expand_times` times along each axis (numpy / jnp.tile)."""
    return {"Out": torch.tile(first(ins, "X"), tuple(op.attr("expand_times")))}


@register_op("assign")
def _assign(ctx, op, ins):
    # a copy: the Adam kernel updates its parameter in place
    return {"Out": first(ins, "X").clone()}


# --- build-time shape/dtype inference (core/analysis.py), as the JAX
# package registers it next to the same lowerings.  assign_value and expand
# have no rule there either.

from ..core import analysis as _A
from ..core.dtypes import canonical_dtype as _canon

_A.register_unary_infer("assign", "increment")


def _infer_filled(ctx):
    shape = ctx.op.attr("shape", None)
    if not shape:
        return
    ctx.set_out("Out", tuple(shape), _canon(ctx.op.attr("dtype", "float32")))


_A.register_rule(["fill_constant", "uniform_random", "gaussian_random"], _infer_filled)


def _infer_cast(ctx):
    dt = ctx.op.attr("out_dtype", ctx.op.attr("dtype", None))
    ctx.set_out("Out", ctx.in_shape("X"), _canon(dt) if dt else None)


_A.register_rule(["cast"], _infer_cast)


def _infer_reshape(ctx):
    xs = ctx.in_shape("X")
    tgt = list(ctx.op.attr("shape", []))
    if not tgt:
        return
    if tgt.count(-1) > 1:
        ctx.fail(f"reshape target {tgt} has more than one -1")
    if xs is None:
        return
    out = []
    for i, s in enumerate(tgt):
        if s == 0:
            if i >= len(xs):
                ctx.fail(f"reshape target {tgt} copies dim {i} (the 0 "
                         f"entry) but X{tuple(xs)} has rank {len(xs)}")
            out.append(xs[i])
        else:
            out.append(int(s))
    if all(d != _A.DYN for d in xs):
        total = int(np.prod(xs)) if xs else 1
        if -1 in out:
            neg = out.index(-1)
            rest = int(np.prod([d for j, d in enumerate(out) if j != neg]) or 1)
            if rest <= 0 or total % rest != 0:
                ctx.fail(f"cannot reshape X{tuple(xs)} ({total} elements) into {tgt}")
            out[neg] = total // rest
        elif all(d != _A.DYN for d in out) and int(np.prod(out) if out else 1) != total:
            ctx.fail(f"cannot reshape X{tuple(xs)} ({total} elements) into "
                     f"{tgt} ({int(np.prod(out) if out else 1)} elements)")
    ctx.set_out("Out", tuple(out), ctx.in_dtype("X"))
    if ctx.op.output("XShape"):
        ctx.set_out("XShape", (0,) + tuple(xs), ctx.in_dtype("X"))


_A.register_rule(["reshape2"], _infer_reshape)


def _infer_transpose(ctx):
    xs = ctx.in_shape("X")
    axis = ctx.op.attr("axis")
    if xs is None or axis is None:
        return
    if sorted(a % len(xs) for a in axis) != list(range(len(xs))):
        ctx.fail(f"transpose axis {list(axis)} is not a permutation of "
                 f"X{tuple(xs)}'s rank {len(xs)}")
    ctx.set_out("Out", tuple(xs[a] for a in axis), ctx.in_dtype("X"))
    if ctx.op.output("XShape"):
        ctx.set_out("XShape", (0,) + tuple(xs), ctx.in_dtype("X"))


_A.register_rule(["transpose2"], _infer_transpose)


def _infer_one_hot(ctx):
    xs = ctx.in_shape("X")
    depth = ctx.op.attr("depth")
    if xs is None or depth is None:
        return
    base = tuple(xs[:-1]) if (xs and xs[-1] == 1) else tuple(xs)
    ctx.set_out("Out", base + (int(depth),), "float32")


_A.register_rule(["one_hot"], _infer_one_hot)
