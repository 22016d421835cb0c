"""Control-flow and tensor-array ops (counterpart of
paddle_tpu/ops/control_flow_ops.py): `while`, `conditional_block`,
`select_input`, `create_array`, `array_write`, `array_read`,
`array_length` and `py_func`.

The interpreter runs `while` and `conditional_block` itself, because their
bodies are sub-blocks of the program, not inputs (core/lowering.py
run_while, run_conditional_block); their registry entries make the
verifier know the types and carry the build-time rule that checks the
`sub_block` attr.  A tensor array is a Python list of tensors in the env
(fetched as a `lod.LoDTensorArray`); `array_write` and `array_read` read
their index on the host, so a plan that holds one runs eagerly
(core/executor.py _graph_refusal), as one with a `conditional_block`
does."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core.registry import register_op
from .common import first


@register_op("while")
def _while(ctx, op, ins):
    raise RuntimeError("a while op reached lower_one; core/lowering.py run_ops runs it "
                       "(run_while)")


@register_op("conditional_block")
def _conditional_block(ctx, op, ins):
    raise RuntimeError("a conditional_block op reached lower_one; core/lowering.py run_ops "
                       "runs it (run_conditional_block)")


@register_op("select_input")
def _select_input(ctx, op, ins):
    """X[Mask]: a where-chain on the card, no host read."""
    xs = ins["X"]
    mask = first(ins, "Mask").reshape(()).to(torch.int32)
    out = xs[0]
    for i in range(1, len(xs)):
        out = torch.where(mask == i, xs[i], out)
    return {"Out": out}


def _host_index(i) -> int:
    """An array index, read on the host."""
    return int(i.reshape(-1)[0]) if isinstance(i, torch.Tensor) else int(i)


@register_op("create_array")
def _create_array(ctx, op, ins):
    return {"Out": [[]]}  # one output whose value is an empty list


@register_op("array_write")
def _array_write(ctx, op, ins):
    arr = list(first(ins, "Array") or [])
    idx = _host_index(first(ins, "I"))
    while len(arr) <= idx:
        arr.append(None)
    arr[idx] = first(ins, "X")
    return {"Out": [arr]}


@register_op("array_read")
def _array_read(ctx, op, ins):
    return {"Out": first(ins, "X")[_host_index(first(ins, "I"))]}


@register_op("array_length")
def _array_length(ctx, op, ins):
    return {"Out": torch.full((1,), len(first(ins, "X")), dtype=torch.int32, device=ctx.device)}


from ..core import analysis as _A


def _infer_sub_block_op(ctx):
    """Validate the sub_block attr at append time, so a broken builder fails
    there and not when the program runs."""
    sub = ctx.op.attrs.get("sub_block")
    program = ctx.block.program
    if sub is None or not isinstance(sub, int) \
            or not (0 <= sub < len(program.blocks)) or sub == ctx.block.idx:
        ctx.fail(f"sub_block attr {sub!r} does not name a valid other "
                 f"block (program has {len(program.blocks)})")


_A.register_rule(["while", "conditional_block"], _infer_sub_block_op)


def _infer_select_input(ctx):
    out = None
    for i in range(ctx.n_inputs("X")):
        s = ctx.in_shape("X", i)
        if s is None:
            continue
        if out is not None and _A.unify_shape(out, s) is None:
            ctx.fail(f"select_input branches disagree on shape: "
                     f"{tuple(out)} vs {tuple(s)}", var=ctx.op.input("X")[i])
        out = s if out is None else _A.unify_shape(out, s)
    ctx.set_out("Out", out, ctx.in_dtype("X"))


_A.register_rule(["select_input"], _infer_select_input)

# layers.py_func's callables, by the func_id attr of their op
_PY_FUNC_REGISTRY = {}
_PY_FUNC_IDS = itertools.count()


def register_py_func(fn) -> int:
    fid = next(_PY_FUNC_IDS)
    _PY_FUNC_REGISTRY[fid] = fn
    return fid


def release_py_func(fid: int):
    """Drop a registered callable (call when its program is discarded)."""
    _PY_FUNC_REGISTRY.pop(fid, None)


@register_op("py_func")
def _py_func(ctx, op, ins):
    """reference operators/py_func_op.cc (layers.py_func): a Python callable
    on host copies of X, its outputs cast to the declared dtypes and put on
    X's device (the JAX package's pure_callback).  A host read: no graph
    captures it (core/executor.py _HOST_READ)."""
    from ..core.dtypes import to_numpy
    from .common import canon_dtype

    fn = _PY_FUNC_REGISTRY[op.attr("func_id")]
    dtypes = [canon_dtype(d) for d in op.attr("out_dtypes")]
    outs = fn(*[to_numpy(x.detach()) for x in ins.get("X", [])])
    if not isinstance(outs, (list, tuple)):
        outs = (outs,)
    if len(outs) != len(dtypes):
        raise ValueError(f"py_func returned {len(outs)} outputs, program declares {len(dtypes)}")
    got = []
    for o, d, want in zip(outs, dtypes, op.attr("out_shapes")):
        a = np.asarray(o)
        if a.shape != tuple(want):
            raise ValueError(f"py_func returned shape {a.shape}, program declares {tuple(want)}")
        a = a.astype(np.float32) if d == torch.bfloat16 else a
        got.append(torch.from_numpy(np.ascontiguousarray(a)).to(d).to(ctx.device))
    return {"Out": got}



# Static cost rules (core/resource_plan.py, the JAX package's): sub-block
# owners carry only their own carry/select traffic — the planner descends
# into the body and prices its ops (one execution; trip counts are not
# static).

from ..core import resource_plan as _RP  # noqa: E402

_RP.register_bytes_cost("while", "conditional_block", "select_input")
