"""Op registry: one eager torch lowering per op type, and its build-time
shape/dtype inference rule (counterpart of paddle_tpu/core/registry.py).

`lower(ctx, op, ins)` receives `ins` as {slot: [tensors]} and returns
{slot: tensor | [tensors]}.  `ctx` is a LoweringContext (core/lowering.py).

`infer(op, block)` validates an op's input shapes and dtypes and declares
its outputs' at `append_op` time.  Rules are registered next to the
lowerings (ops/*) through `set_infer` / `core.analysis.register_rule`;
`infer_and_check` turns any failure into a `ShapeInferenceError` naming the
op, var and block.

`cost(op, block, env)` is the op's static (FLOPs, bytes moved) rule, the
resource planner's per-op model (core/resource_plan.py), registered beside
the lowerings through `set_cost` / `resource_plan.register_cost`.
"""
from __future__ import annotations

import difflib
from typing import Callable, Dict, List, Optional

OpLowerFn = Callable  # (ctx, op, ins) -> {slot: tensors}
InferFn = Callable  # (op, block) -> None (sets output var shapes/dtypes)
CostFn = Callable  # (op, block, env) -> (flops, traffic_bytes)


class OpDef:
    def __init__(self, type: str, lower: OpLowerFn, infer: Optional[InferFn] = None,
                 cost: Optional[CostFn] = None):
        self.type = type
        self.lower = lower
        self.infer = infer
        self.cost = cost


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, infer: Optional[InferFn] = None):
    """Decorator: @register_op("relu") def _relu(ctx, op, ins): ..."""

    def deco(fn: OpLowerFn):
        prev = _REGISTRY.get(type)
        d = OpDef(type, fn, infer)
        if infer is None and prev is not None and prev.infer is not None:
            d.infer = prev.infer  # re-registration keeps an attached infer
        if prev is not None and prev.cost is not None:
            d.cost = prev.cost  # re-registration keeps an attached cost rule
        _REGISTRY[type] = d
        return fn

    return deco


def set_infer(type: str, infer: InferFn):
    """Attach a build-time shape/dtype inference fn to a registered op."""
    try:
        _REGISTRY[type].infer = infer
    except KeyError:
        raise KeyError(f"set_infer({type!r}): op has no registered lowering") from None


def set_cost(type: str, cost: CostFn):
    """Attach a static FLOPs/bytes cost rule to a registered op (the
    resource planner's per-op model, core/resource_plan.py)."""
    try:
        _REGISTRY[type].cost = cost
    except KeyError:
        raise KeyError(f"set_cost({type!r}): op has no registered lowering") from None


def suggest_ops(type: str, n: int = 3) -> List[str]:
    """Nearest-matching registered op types for an unknown-op error."""
    return difflib.get_close_matches(type, sorted(_REGISTRY), n=n)


def get_op_def(type: str) -> OpDef:
    try:
        return _REGISTRY[type]
    except KeyError:
        close = suggest_ops(type)
        hint = f"; did you mean: {', '.join(close)}?" if close else ""
        raise NotImplementedError(
            f"op {type!r} has no lowering in paddle_tpu_torch yet{hint} "
            f"({len(_REGISTRY)} ops ported)") from None


def get_op_def_or_none(type: str) -> Optional[OpDef]:
    return _REGISTRY.get(type)


def has_op(type: str) -> bool:
    return type in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


def infer_and_check(op, block):
    """Run the op's build-time shape/dtype inference, if it registered one.

    Ops the framework appends (feed/fetch/backward) have none.  Under
    FLAGS_verify_program=off nothing runs: the escape hatch for a program
    an over-strict rule would reject.  Failures are `ShapeInferenceError`s
    (core/analysis.py), counted in `analysis.infer_failures`; successes in
    `analysis.infer_checks`."""
    d = _REGISTRY.get(op.type)
    if d is None or d.infer is None:
        return
    from ..flags import flag

    if flag("FLAGS_verify_program") in ("", "off"):
        return
    from ..monitor import MONITOR as _MON
    from .analysis import ShapeInferenceError, StaticAnalysisError, _op_index

    try:
        d.infer(op, block)
        _MON.counter("analysis.infer_checks").inc()
    except StaticAnalysisError:
        _MON.counter("analysis.infer_failures").inc()
        raise
    except Exception as e:
        _MON.counter("analysis.infer_failures").inc()
        raise ShapeInferenceError(
            f"shape/dtype inference crashed for op #{_op_index(block, op)} "
            f"({op.type!r}) in block {block.idx}: {e!r}") from e
