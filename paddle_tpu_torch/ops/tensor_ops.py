"""Tensor creation / manipulation lowerings (counterpart of
paddle_tpu/ops/tensor_ops.py): the fills (constant, random, zeros, range,
linspace), cast, the reshapes, transposes, squeezes and flattens, concat,
split, stack, slice, pad, the gathers and scatters, cumsum, argsort, expand,
one_hot, norm, shard_index and space_to_depth."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

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


@register_op("truncated_gaussian_random")
def _truncated_gaussian_random(ctx, op, ins):
    """mean + std * z, z a standard normal truncated to [-2, 2] (reference
    truncated_gaussian_random_op.cc), by the inverse CDF of a uniform draw
    over [Phi(-2), Phi(2)]."""
    shape = tuple(op.attr("shape"))
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = _draw(ctx, op, shape, lambda s, g: torch.rand(s, generator=g, dtype=torch.float32,
                                                      device=ctx.device))
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    out = op.attr("mean", 0.0) + op.attr("std", 1.0) * torch.clamp(z, -2.0, 2.0)
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


@register_op("reshape")
def _reshape(ctx, op, ins):
    return {"Out": _reshape2(ctx, op, ins)["Out"]}


@register_op("transpose")
def _transpose(ctx, op, ins):
    return {"Out": _transpose2(ctx, op, ins)["Out"]}


@register_op("squeeze2")
def _squeeze2(ctx, op, ins):
    """Drop the `axes` of size 1 (every size-1 axis when `axes` is empty)."""
    x = first(ins, "X")
    axes = op.attr("axes", [])
    out = x.squeeze(tuple(a % x.dim() for a in axes)) if axes else x.squeeze()
    return {"Out": out, "XShape": _xshape(ctx, op, x)}


@register_op("squeeze")
def _squeeze(ctx, op, ins):
    return {"Out": _squeeze2(ctx, op, ins)["Out"]}


@register_op("unsqueeze2")
def _unsqueeze2(ctx, op, ins):
    x = first(ins, "X")
    out = x
    for a in sorted(op.attr("axes")):
        out = out.unsqueeze(a)
    return {"Out": out, "XShape": _xshape(ctx, op, x)}


@register_op("unsqueeze")
def _unsqueeze(ctx, op, ins):
    return {"Out": _unsqueeze2(ctx, op, ins)["Out"]}


@register_op("flatten2")
def _flatten2(ctx, op, ins):
    """[prod(shape[:axis]), prod(shape[axis:])]."""
    x = first(ins, "X")
    ax = op.attr("axis", 1)
    out = x.reshape(math.prod(x.shape[:ax]), math.prod(x.shape[ax:]))
    return {"Out": out, "XShape": _xshape(ctx, op, x)}


@register_op("flatten")
def _flatten(ctx, op, ins):
    return {"Out": _flatten2(ctx, op, ins)["Out"]}


@register_op("concat")
def _concat(ctx, op, ins):
    return {"Out": torch.cat(ins["X"], dim=op.attr("axis", 0))}


@register_op("split")
def _split(ctx, op, ins):
    """`num` equal parts, or parts of `sections` sizes, along `axis`."""
    x = first(ins, "X")
    axis = op.attr("axis", 0)
    num = op.attr("num", 0)
    if num:
        return {"Out": list(x.tensor_split(num, dim=axis))}
    idx = np.cumsum(op.attr("sections", [])[:-1]).tolist()
    return {"Out": list(x.tensor_split(idx, dim=axis))}


@register_op("stack")
def _stack(ctx, op, ins):
    return {"Y": torch.stack(ins["X"], dim=op.attr("axis", 0))}


@register_op("unstack")
def _unstack(ctx, op, ins):
    return {"Y": list(first(ins, "X").unbind(op.attr("axis", 0)))}


@register_op("shape")
def _shape(ctx, op, ins):
    """x's shape as int32, built once per plan and shape (no host copy at a
    graph's capture)."""
    x = first(ins, "Input")
    dims = tuple(x.shape)
    return {"Out": ctx.constant((op.type, id(op), dims), lambda: torch.tensor(
        dims, dtype=torch.int32, device=ctx.device)).clone()}


@register_op("slice")
def _slice(ctx, op, ins):
    """Python slicing per axis: negative bounds count from the end, bounds
    past the end clamp."""
    x = first(ins, "Input")
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(op.attr("axes"), op.attr("starts"), op.attr("ends")):
        idx[ax] = slice(st, en)
    return {"Out": x[tuple(idx)]}


@register_op("pad")
def _pad(ctx, op, ins):
    """Constant padding; `paddings` is [before0, after0, before1, ...]."""
    x = first(ins, "X")
    p = op.attr("paddings")
    flat = []
    for i in reversed(range(x.dim())):  # F.pad takes the last axis first
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": F.pad(x, flat, value=op.attr("pad_value", 0.0))}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, op, ins):
    return {"Out": torch.zeros_like(first(ins, "X"))}


def _index(t):
    return t.to(torch.long)


@register_op("gather")
def _gather(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": x.index_select(0, _index(first(ins, "Index").reshape(-1)))}


@register_op("gather_nd")
def _gather_nd(ctx, op, ins):
    """Index [..., K] selects into x's first K axes."""
    x = first(ins, "X")
    index = _index(first(ins, "Index"))
    k = index.shape[-1]
    flat = index.reshape(-1, k)
    out = x[tuple(flat[:, i] for i in range(k))]
    return {"Out": out.reshape(tuple(index.shape[:-1]) + tuple(x.shape[k:]))}


@register_op("scatter")
def _scatter(ctx, op, ins):
    """Rows of Updates written (or with overwrite=False added) into X at Ids."""
    x = first(ins, "X")
    ids = _index(first(ins, "Ids").reshape(-1))
    upd = first(ins, "Updates").to(x.dtype)
    return {"Out": x.index_put((ids,), upd, accumulate=not op.attr("overwrite", True))}


@register_op("scatter_nd_add")
def _scatter_nd_add(ctx, op, ins):
    x = first(ins, "X")
    index = _index(first(ins, "Index"))
    k = index.shape[-1]
    flat = index.reshape(-1, k)
    upd = first(ins, "Updates").to(x.dtype).reshape((flat.shape[0],) + tuple(x.shape[k:]))
    return {"Out": x.index_put(tuple(flat[:, i] for i in range(k)), upd, accumulate=True)}


@register_op("range")
def _range(ctx, op, ins):
    """arange(start, end, step): each bound from its `*_v` attr, else from
    its input (a host read, as the JAX lowering's concrete path).  The
    output is `dtype`, else int32 when every bound is an attr, else what
    the bounds give (int32 or float32)."""
    vals, from_attrs = [], True
    for slot, key in (("Start", "start_v"), ("End", "end_v"), ("Step", "step_v")):
        v = op.attr(key, None)
        if v is None:
            v, from_attrs = first(ins, slot).reshape(()).item(), False
        vals.append(v)
    out = torch.arange(*vals, device=ctx.device)
    dtype = op.attr("dtype", None)
    if dtype:
        return {"Out": out.to(canon_dtype(dtype))}
    if from_attrs:
        return {"Out": out.to(torch.int32)}
    return {"Out": out.to(canon_dtype(out.dtype))}


@register_op("cumsum")
def _cumsum(ctx, op, ins):
    x = first(ins, "X")
    axis = op.attr("axis", -1)
    rev = op.attr("reverse", False)
    if rev:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, axis).to(x.dtype)  # an int32 sum stays int32
    if op.attr("exclusive", False):
        out = out - x
    if rev:
        out = torch.flip(out, (axis,))
    return {"Out": out}


@register_op("argsort")
def _argsort(ctx, op, ins):
    """A stable sort along `axis`; Indices int32 (the x32 rule)."""
    x = first(ins, "X")
    out, idx = torch.sort(x, dim=op.attr("axis", -1), descending=op.attr("descending", False),
                          stable=True)
    return {"Out": out, "Indices": idx.to(torch.int32)}


@register_op("expand_as")
def _expand_as(ctx, op, ins):
    x = first(ins, "X")
    target = first(ins, "target_tensor")
    if target is None:
        target = first(ins, "Y")
    return {"Out": torch.tile(x, tuple(t // s for t, s in zip(target.shape, x.shape)))}


@register_op("linspace")
def _linspace(ctx, op, ins):
    """`num_v` points from Start to Stop, as jnp.linspace computes them:
    start * (1 - s) + stop * s for s = i / (num - 1), the last point Stop."""
    start = first(ins, "Start").reshape(())
    stop = first(ins, "Stop").reshape(())
    num = op.attr("num_v", None)
    if num is None:
        num = int(first(ins, "Num").reshape(()).item())
    if num == 1:
        return {"Out": start.reshape(1)}
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    out = start * (1 - step) + stop * step
    return {"Out": torch.cat([out, stop.reshape(1)])}


@register_op("norm")
def _norm(ctx, op, ins):
    """x l2-normalized along `axis`; Norm is the l2 norm (with epsilon)."""
    x = first(ins, "X")
    n = torch.sqrt(torch.sum(torch.square(x), dim=op.attr("axis", -1), keepdim=True)
                   + op.attr("epsilon", 1e-10))
    return {"Out": x / n, "Norm": n}


@register_op("shard_index")
def _shard_index(ctx, op, ins):
    """Global ids to shard-local ids; ids of other shards become ignore_value."""
    x = first(ins, "X")
    shard_size = (op.attr("index_num") + op.attr("nshards") - 1) // op.attr("nshards")
    in_shard = torch.floor_divide(x, shard_size) == op.attr("shard_id")
    return {"Out": torch.where(in_shard, torch.remainder(x, shard_size),
                               torch.full((), op.attr("ignore_value", -1), dtype=x.dtype,
                                          device=x.device))}


@register_op("space_to_depth")
def _space_to_depth(ctx, op, ins):
    """The reference's buffer layout: written as [B, C/bs^2, H*bs, W*bs]
    and read back as [B, C*bs^2, H/bs, W/bs], as the JAX lowering."""
    x = first(ins, "X")
    bs = int(op.attr("blocksize"))
    B, C, H, W = x.shape
    if C % (bs * bs) != 0 or H % bs != 0 or W % bs != 0:
        raise ValueError(
            f"space_to_depth: C ({C}) must divide blocksize^2 and H/W ({H},{W}) "
            f"must divide blocksize ({bs}) -- reference InferShape contract")
    cout = C // (bs * bs)
    a = x.reshape(B, bs, bs, cout, H, W).permute(0, 3, 4, 1, 5, 2)
    return {"Out": a.reshape(B, C * bs * bs, H // bs, W // bs)}


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
# package registers it next to the same lowerings.  The ops without a rule
# there (assign_value, expand, the squeezes, slice, pad, ...) have none here
# either: their layers declare the output shapes.

from ..core import analysis as _A
from ..core.dtypes import canonical_dtype as _canon

_A.register_unary_infer("assign", "increment", "fill_zeros_like", "cumsum")


def _infer_filled(ctx):
    shape = ctx.op.attr("shape", None)
    if not shape:
        return
    ctx.set_out("Out", tuple(shape), _canon(ctx.op.attr("dtype", "float32")))


_A.register_rule(["fill_constant", "uniform_random", "gaussian_random",
                  "truncated_gaussian_random"], _infer_filled)


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


_A.register_rule(["reshape2", "reshape"], _infer_reshape)


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


_A.register_rule(["transpose2", "transpose"], _infer_transpose)


def _infer_one_hot(ctx):
    xs = ctx.in_shape("X")
    depth = ctx.op.attr("depth")
    if xs is None or depth is None:
        return
    base = tuple(xs[:-1]) if (xs and xs[-1] == 1) else tuple(xs)
    ctx.set_out("Out", base + (int(depth),), "float32")


_A.register_rule(["one_hot"], _infer_one_hot)


def _infer_concat(ctx):
    shapes = [ctx.in_shape("X", i) for i in range(ctx.n_inputs("X"))]
    if any(s is None for s in shapes) or not shapes:
        return
    rank = len(shapes[0])
    if any(len(s) != rank for s in shapes):
        ctx.fail(f"concat inputs have mixed ranks: {[tuple(s) for s in shapes]}")
    axis = ctx.op.attr("axis", 0) % rank
    out = list(shapes[0])
    for i, s in enumerate(shapes[1:], start=1):
        for d in range(rank):
            if d == axis:
                continue
            u = _A.unify_dim(out[d], s[d])
            if u is None:
                ctx.fail(f"concat input {i} shape {tuple(s)} mismatches "
                         f"{tuple(out)} outside axis {axis}", var=ctx.op.input("X")[i])
            out[d] = u
    cat = 0
    for s in shapes:
        if s[axis] == _A.DYN:
            cat = _A.DYN
            break
        cat += s[axis]
    out[axis] = cat
    ctx.set_out("Out", tuple(out), ctx.in_dtype("X"))


_A.register_rule(["concat"], _infer_concat)


def _infer_split(ctx):
    xs = ctx.in_shape("X")
    if xs is None:
        return
    axis = ctx.op.attr("axis", 0) % len(xs)
    num = ctx.op.attr("num", 0)
    sections = ctx.op.attr("sections", [])
    for i in range(len(ctx.op.output("Out"))):
        out = list(xs)
        if num:
            if xs[axis] == _A.DYN:
                out[axis] = _A.DYN
            elif xs[axis] % num:
                ctx.fail(f"split axis dim {xs[axis]} not divisible by num={num}")
            else:
                out[axis] = xs[axis] // num
        elif sections:
            if i < len(sections):
                out[axis] = sections[i]
        ctx.set_out("Out", tuple(out), ctx.in_dtype("X"), i=i)


_A.register_rule(["split"], _infer_split)


def _infer_stack(ctx):
    shapes = [ctx.in_shape("X", i) for i in range(ctx.n_inputs("X"))]
    if any(s is None for s in shapes) or not shapes:
        return
    base = shapes[0]
    for s in shapes[1:]:
        u = _A.unify_shape(base, s)
        if u is None:
            ctx.fail(f"stack inputs have mismatched shapes: {[tuple(s) for s in shapes]}")
        base = u
    axis = ctx.op.attr("axis", 0) % (len(base) + 1)
    ctx.set_out("Y", tuple(base[:axis]) + (len(shapes),) + tuple(base[axis:]), ctx.in_dtype("X"))


_A.register_rule(["stack"], _infer_stack)


def _infer_gather(ctx):
    xs = ctx.in_shape("X")
    idx = ctx.in_shape("Index")
    if xs is None or idx is None:
        return
    n = _A.DYN
    if all(d != _A.DYN for d in idx):
        n = int(np.prod(idx)) if idx else 1
    ctx.set_out("Out", (n,) + tuple(xs[1:]), ctx.in_dtype("X"))


_A.register_rule(["gather"], _infer_gather)


# --- static cost rules (core/resource_plan.py) ------------------------------
# The JAX package's (paddle_tpu/ops/tensor_ops.py).

from ..core import resource_plan as _RP

# pure data movement: zero FLOPs, in+out traffic
_RP.register_bytes_cost("assign", "cast", "reshape2", "reshape",
                        "transpose2", "transpose", "concat", "split",
                        "one_hot", "stack", "gather", "fill_zeros_like",
                        "expand", "squeeze2", "squeeze", "unsqueeze2",
                        "unsqueeze", "slice", "pad", "pad2d", "shape",
                        "flatten2", "flatten")
_RP.register_elementwise_cost("scale", "increment", "cumsum")


def _cost_filled(ctx):
    """Generators write their output once; RNG costs a few FLOPs/elem."""
    out_b = sum(ctx.env.nbytes(n) for n in ctx.op.output_arg_names)
    rng = ctx.op.type != "fill_constant"
    return float(ctx.out_elems_total() * (8 if rng else 0)), float(out_b)


_RP.register_cost(["fill_constant", "uniform_random", "gaussian_random",
                   "truncated_gaussian_random"], _cost_filled)
