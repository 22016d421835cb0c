"""Static analysis over the Program IR: the verifier, shape/dtype
inference and the hazard lints, everything that can be checked before a
program runs (counterpart of paddle_tpu/core/analysis.py).

  * **Structural verifier** (`verify_structure`): def-before-use per block,
    dangling var references, ops with no registered lowering, orphan
    sub-block attrs, duplicate writes to parameters; feed and fetch targets
    when the caller knows them (`verify_feed_fetch`).
  * **Shape/dtype inference** (`InferContext` and the rule factories): the
    `infer=` rules registered next to the lowerings (ops/*) run at
    `Block.append_op` time through `registry.infer_and_check`, unify `-1`
    (dynamic) dims with the declared shapes, and raise
    `ShapeInferenceError`s naming the op, var and block.
  * **Hazard lints**: in-place persistable state read again later in the
    step (donation), feed vars with dynamic non-batch dims (every distinct
    shape is a new plan), and RNG ops in an unseeded program.  The JAX
    package's collective-order lint waits for the port's collectives
    (ROADMAP A10).

Entry points: `verify_program` (a list of diagnostics) and `check_program`
(raises on an error-severity one).  `core/passes.py` verifies after every
pass and the executor on each plan-cache miss, both under
`FLAGS_verify_program` (off | structural | full).  Monitor:
`analysis.verify_runs`, `analysis.diag.<code>` counters and the
`analysis.infer_coverage_frac` gauge.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..errors import FatalError
from ..monitor import MONITOR as _MON
from . import registry
from .dtypes import canonical_dtype
from .program import Block, Operator, Parameter, Program

__all__ = [
    # diagnostics + errors
    "Diagnostic", "StaticAnalysisError", "ProgramVerificationError",
    "ShapeInferenceError", "PassVerificationError",
    "SEV_ERROR", "SEV_WARNING", "LEVELS",
    # shape algebra
    "unify_dim", "unify_shape", "broadcast_dim", "fluid_broadcast",
    # inference engine
    "InferContext", "as_infer", "register_rule", "register_unary_infer",
    "register_elementwise_infer", "register_reduce_infer",
    "register_state_update_infer", "infer_coverage",
    # verifier + lints
    "verify_structure", "verify_feed_fetch", "verify_shapes",
    "lint_donation", "lint_recompile", "lint_determinism",
    # entry points
    "verify_program", "check_program",
    # shared op vocabularies
    "BOOL_OUT_OPS", "RNG_OPS", "STRUCTURAL_OPS",
]

# Ops the executor handles itself; they have no lowering and no infer fn.
STRUCTURAL_OPS = ("feed", "fetch", "backward")

# Sub-block owners with loop semantics: body reads of body-written vars are
# loop carries (previous iteration's value), not use-before-def.
_LOOP_OPS = ("while", "dynamic_rnn")

# Compare/logical ops produce bool whatever the operand dtype.  Shared by
# the infer registrations (ops/*) and the layer builders (math_sugar) so
# the two cannot drift.
BOOL_OUT_OPS = frozenset({
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor",
})

# RNG-consuming op types and how an op can pin its own stream.
RNG_OPS = frozenset({
    "dropout", "uniform_random", "gaussian_random",
    "truncated_gaussian_random", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "sampling_id", "random_crop",
})

# Program-level ops whose lowering issues collectives, and the attr naming
# the mesh axis they communicate over (the JAX package's table).  Both are
# model-parallel ops the port lowers with ROADMAP A10.3, so today's
# programs have an empty signature; the data-parallel gradient all-reduce
# is the executor's, issued in the same order on every rank by
# construction, and needs no lint.
COLLECTIVE_OPS = {"pipeline": "axis_name", "ring_attention": "sp_axis"}

SEV_ERROR = "error"
SEV_WARNING = "warning"

DYN = -1  # the dynamic-dim sentinel in declared shapes


# --------------------------------------------------------------------------
# diagnostics
# --------------------------------------------------------------------------

@dataclass
class Diagnostic:
    """One finding, with enough provenance to locate the offending op."""

    code: str                 # e.g. "use_before_def", "donation_hazard"
    severity: str             # SEV_ERROR | SEV_WARNING
    message: str
    block: int = 0
    op_idx: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None

    def __str__(self):
        where = f"block {self.block}"
        if self.op_idx is not None:
            where += f" op #{self.op_idx}"
        if self.op_type is not None:
            where += f" ({self.op_type})"
        tail = f" [var {self.var!r}]" if self.var else ""
        return f"[{self.severity}:{self.code}] {where}: {self.message}{tail}"


class StaticAnalysisError(FatalError):
    """Base of build-time analysis failures (never retried: the program
    itself is wrong, not the run)."""

    def __init__(self, message: str, diagnostics: Optional[List[Diagnostic]] = None):
        super().__init__(message, phase="build")
        self.diagnostics = list(diagnostics or [])


class ProgramVerificationError(StaticAnalysisError):
    """verify/check found error-severity diagnostics."""


class ShapeInferenceError(StaticAnalysisError):
    """An op's declared shapes/dtypes are inconsistent with its inputs
    (raised at `append_op` time via `registry.infer_and_check`)."""


class PassVerificationError(ProgramVerificationError):
    """A program-rewrite pass left the program verifier-dirty."""

    def __init__(self, pass_name: str, diagnostics: List[Diagnostic]):
        lines = "\n".join(f"  {d}" for d in diagnostics)
        super().__init__(
            f"pass {pass_name!r} broke the program "
            f"(FLAGS_verify_program caught it before lowering):\n{lines}",
            diagnostics,
        )
        self.pass_name = pass_name


def _op_index(block: Block, op: Operator) -> Optional[int]:
    """Index of `op` in its block; O(1) for the append_op hot path."""
    if block.ops and block.ops[-1] is op:
        return len(block.ops) - 1
    try:
        return block.ops.index(op)
    except ValueError:
        return None


# --------------------------------------------------------------------------
# shape algebra: -1-aware unification / broadcasting
# --------------------------------------------------------------------------

def unify_dim(a: int, b: int) -> Optional[int]:
    """Unify two dims where -1 is unknown; None on conflict."""
    if a == b:
        return a
    if a == DYN:
        return b
    if b == DYN:
        return a
    return None


def unify_shape(a: Sequence[int], b: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """Elementwise dim unification; None on rank or dim conflict."""
    if len(a) != len(b):
        return None
    out = []
    for da, db in zip(a, b):
        d = unify_dim(int(da), int(db))
        if d is None:
            return None
        out.append(d)
    return tuple(out)


def broadcast_dim(a: int, b: int) -> Optional[int]:
    """Numpy-style broadcast of two dims, -1-aware; None on conflict.

    -1 vs d>1 resolves to d (a runtime value of either 1 or d broadcasts to
    d; anything else errors at runtime too).  -1 vs 1 stays -1.
    """
    if a == b:
        return a
    if a == 1:
        return b
    if b == 1:
        return a
    if a == DYN:
        return b if b != 1 else DYN
    if b == DYN:
        return a if a != 1 else DYN
    return None


def fluid_broadcast(x: Sequence[int], y: Sequence[int], axis: int = -1
                    ) -> Optional[Tuple[int, ...]]:
    """Fluid elementwise broadcasting: Y aligns to X starting at `axis`
    (axis=-1: trailing/numpy alignment).  Returns the out shape or None on
    a dim conflict."""
    x = [int(d) for d in x]
    y = [int(d) for d in y]
    if len(y) > len(x):
        x, y = y, x  # rare mirrored case (scalar-first sugar)
        axis = -1
    if axis == -1 or len(x) == len(y):
        pad = len(x) - len(y)
        y_full = [1] * pad + y
    else:
        pad_right = len(x) - axis - len(y)
        if pad_right < 0:
            return None
        y_full = [1] * axis + y + [1] * pad_right
    out = []
    for dx, dy in zip(x, y_full):
        d = broadcast_dim(dx, dy)
        if d is None:
            return None
        out.append(d)
    return tuple(out)


def _scalarish(shape) -> bool:
    """() and (1,) both mean 'scalar' across the op vocabulary."""
    return len(shape) <= 1 and all(d == 1 for d in shape)


def _dtype_kind(name: str) -> str:
    """'f' (any float incl. bfloat16), 'i'/'u' (ints), 'b' (bool)."""
    if name in ("bfloat16", "float16", "float32", "float64"):
        return "f"
    if name == "bool":
        return "b"
    if name.startswith("uint"):
        return "u"
    if name.startswith("int"):
        return "i"
    return "?"


# --------------------------------------------------------------------------
# shape/dtype inference engine
# --------------------------------------------------------------------------

# When set, infer rules only CHECK: `InferContext.set_out` raises on
# conflicts but never fills/narrows declared shapes (whole-program
# re-verification must not mutate the program it verifies).
_READONLY = False


class InferContext:
    """Helper handed to per-op infer rules: slot-level shape/dtype access
    plus declared-vs-inferred unification with full provenance on failure."""

    def __init__(self, op: Operator, block: Block):
        self.op = op
        self.block = block

    # -- inputs ----------------------------------------------------------
    def in_var(self, slot: str, i: int = 0):
        names = self.op.input(slot)
        if i >= len(names):
            return None
        return self.block._find_var_recursive(names[i])

    def in_shape(self, slot: str, i: int = 0) -> Optional[Tuple[int, ...]]:
        v = self.in_var(slot, i)
        if v is None or v.shape is None:
            return None
        return tuple(v.shape)

    def in_dtype(self, slot: str, i: int = 0) -> Optional[str]:
        v = self.in_var(slot, i)
        return None if v is None else v.dtype

    def n_inputs(self, slot: str) -> int:
        return len(self.op.input(slot))

    # -- failure with provenance ----------------------------------------
    def fail(self, message: str, var: Optional[str] = None):
        idx = _op_index(self.block, self.op)
        raise ShapeInferenceError(
            f"shape/dtype inference failed for op #{idx} "
            f"({self.op.type!r}) in block {self.block.idx}: {message}"
            + (f" [var {var!r}]" if var else "")
        )

    # -- outputs ---------------------------------------------------------
    def set_out(self, slot: str, shape, dtype=None, i: int = 0):
        """Declare/validate one output: unify the inferred shape with the
        declared one (fill when undeclared, raise on conflict) and check
        the declared dtype when an inferred dtype is given.

        Under `_READONLY` (whole-program re-verification) conflicts still
        raise but nothing is written back: verifying must not change the
        program."""
        names = self.op.output(slot)
        if i >= len(names):
            return
        name = names[i]
        var = self.block._find_var_recursive(name)
        if var is None:
            return
        if shape is not None:
            shape = tuple(int(s) for s in shape)
            if var.shape is None:
                if not _READONLY:
                    var.shape = shape
            elif _scalarish(var.shape) and _scalarish(shape):
                # the fluid scalar blur: () and (1,) are used
                # interchangeably for scalars (reference reduce/loss ops
                # declare [1] where jnp produces rank-0); keep the declared
                pass
            else:
                unified = unify_shape(var.shape, shape)
                if unified is None:
                    self.fail(
                        f"output {name!r} declared shape {tuple(var.shape)} "
                        f"does not match inferred shape {shape}",
                        var=name,
                    )
                if not _READONLY:
                    var.shape = unified
        if dtype is not None:
            want = canonical_dtype(dtype)
            if var.dtype != want and _dtype_kind(var.dtype) != _dtype_kind(want):
                # widths legally drift (f64 goldens, bf16 master weights);
                # KIND drift (float vs int vs bool) is a real program bug
                self.fail(
                    f"output {name!r} declared dtype {var.dtype!r} does not "
                    f"match inferred dtype {want!r}",
                    var=name,
                )


def as_infer(rule):
    """Adapt rule(ctx) -> None to the registry's InferFn(op, block)."""

    def infer(op, block):
        rule(InferContext(op, block))

    infer._analysis_rule = rule
    return infer


def register_rule(types: Sequence[str], rule):
    """Attach one rule to several registered op types."""
    fn = as_infer(rule)
    for t in types:
        registry.set_infer(t, fn)
    return fn


# -- generic rule factories (used by ops/* registrations) -------------------

def register_unary_infer(*types, x_slot: str = "X", out_slot: str = "Out",
                         out_dtype: Optional[str] = None):
    """Out has X's shape; dtype follows X unless pinned (compare -> bool)."""

    def rule(ctx: InferContext):
        ctx.set_out(out_slot, ctx.in_shape(x_slot),
                    out_dtype or ctx.in_dtype(x_slot))

    return register_rule(types, rule)


def register_elementwise_infer(*types, out_dtype: Optional[str] = None):
    """Fluid binary broadcasting: Y aligns into X at attr `axis`."""

    def rule(ctx: InferContext):
        xs = ctx.in_shape("X")
        ys = ctx.in_shape("Y")
        dt = out_dtype or ctx.in_dtype("X")
        if xs is None:
            return
        if ys is None:
            ctx.set_out("Out", xs, dt)
            return
        out = fluid_broadcast(xs, ys, ctx.op.attr("axis", -1))
        if out is None:
            ctx.fail(
                f"operands do not broadcast: X{tuple(xs)} vs Y{tuple(ys)} "
                f"at axis={ctx.op.attr('axis', -1)}",
                var=ctx.op.input("X")[0] if ctx.op.input("X") else None,
            )
        ctx.set_out("Out", out, dt)

    return register_rule(types, rule)


def register_reduce_infer(*types):
    def rule(ctx: InferContext):
        xs = ctx.in_shape("X")
        if xs is None:
            return
        if ctx.op.attr("reduce_all", False):
            axes = tuple(range(len(xs)))
        else:
            dim = ctx.op.attr("dim", [0])
            if isinstance(dim, int):
                dim = [dim]
            axes = tuple(sorted(d % len(xs) for d in dim))
        keep = ctx.op.attr("keep_dim", False)
        if keep:
            out = tuple(1 if i in axes else d for i, d in enumerate(xs))
        else:
            out = tuple(d for i, d in enumerate(xs) if i not in axes)
        ctx.set_out("Out", out, ctx.in_dtype("X"))

    return register_rule(types, rule)


def register_state_update_infer(*types):
    """Optimizer-style ops: every `<Slot>Out` output mirrors the `<Slot>`
    input's shape/dtype, and Grad must match Param where both are known."""

    def rule(ctx: InferContext):
        ps = ctx.in_shape("Param")
        gs = ctx.in_shape("Grad")
        if ps is not None and gs is not None and unify_shape(ps, gs) is None:
            ctx.fail(
                f"Grad shape {tuple(gs)} does not match Param shape "
                f"{tuple(ps)}",
                var=ctx.op.input("Param")[0],
            )
        for slot, names in ctx.op.outputs.items():
            src = slot[:-3] if slot.endswith("Out") else None
            if not src or not ctx.op.input(src):
                continue
            for i in range(len(names)):
                ctx.set_out(slot, ctx.in_shape(src, i), ctx.in_dtype(src, i), i=i)

    return register_rule(types, rule)


# --------------------------------------------------------------------------
# structural verifier
# --------------------------------------------------------------------------

def _block_writes(program: Program, block: Block, _seen=None) -> set:
    """All names written by a block's ops, including nested sub-blocks."""
    _seen = _seen if _seen is not None else set()
    if block.idx in _seen:
        return set()
    _seen.add(block.idx)
    out = set()
    for op in block.ops:
        out.update(op.output_arg_names)
        sub = op.attrs.get("sub_block")
        if isinstance(sub, int) and 0 <= sub < len(program.blocks):
            out.update(_block_writes(program, program.blocks[sub], _seen))
    return out


def _initially_defined(block: Block) -> set:
    """Names available before any op runs: data vars (fed), persistables
    (scope state), and parameters, from this block and its ancestors."""
    defined = set()
    blk: Optional[Block] = block
    while blk is not None:
        for name, v in blk.vars.items():
            if v.persistable or v.is_data or isinstance(v, Parameter):
                defined.add(name)
        blk = blk.parent_block
    return defined


def _suggest(type: str) -> str:
    close = registry.suggest_ops(type)
    return f"; did you mean: {', '.join(close)}?" if close else ""


def verify_structure(program: Program) -> List[Diagnostic]:
    """Structural checks over every reachable block (reference: the
    def-use validation OpDesc/BlockDesc did at Append time plus the ir
    Graph sanity checks)."""
    diags: List[Diagnostic] = []
    all_written = set()
    for blk in program.blocks:
        for op in blk.ops:
            all_written.update(op.output_arg_names)
    visited = set()

    def walk(block: Block, defined: set):
        visited.add(block.idx)
        later_writes: Dict[str, int] = {}
        for i, op in enumerate(block.ops):
            for n in op.output_arg_names:
                later_writes.setdefault(n, i)
        param_writes: Dict[str, int] = {}
        for i, op in enumerate(block.ops):
            # (1) every op must have a lowering (or be executor-structural)
            if op.type not in STRUCTURAL_OPS and not registry.has_op(op.type):
                diags.append(Diagnostic(
                    "unregistered_op", SEV_ERROR,
                    f"op type {op.type!r} has no registered lowering"
                    + _suggest(op.type),
                    block=block.idx, op_idx=i, op_type=op.type,
                ))
            # (2) def-before-use / dangling reads
            if op.type != "feed":
                reads = list(op.input_arg_names)
                if op.type == "backward":
                    reads.append(op.attrs.get("loss_name"))
                    reads.extend(op.attrs.get("param_names", []))
                for n in reads:
                    if n is None or n in defined:
                        continue
                    j = later_writes.get(n)
                    if j is not None and j >= i:
                        diags.append(Diagnostic(
                            "use_before_def", SEV_ERROR,
                            f"reads {n!r} which is first written by op #{j} "
                            f"later in the block",
                            block=block.idx, op_idx=i, op_type=op.type, var=n,
                        ))
                    else:
                        known = (n in all_written
                                 or block._find_var_recursive(n) is not None)
                        diags.append(Diagnostic(
                            "dangling_var", SEV_ERROR,
                            (f"reads {n!r} which has no producer on this "
                             f"path and is not feedable state"
                             if known else
                             f"reads {n!r} which is declared nowhere in the "
                             f"program"),
                            block=block.idx, op_idx=i, op_type=op.type, var=n,
                        ))
                    defined.add(n)  # report each missing name once
            # (3) duplicate writes to parameters
            for n in op.output_arg_names:
                v = block._find_var_recursive(n)
                if isinstance(v, Parameter):
                    if n in param_writes:
                        diags.append(Diagnostic(
                            "duplicate_param_write", SEV_ERROR,
                            f"parameter {n!r} already written by op "
                            f"#{param_writes[n]} in this block",
                            block=block.idx, op_idx=i, op_type=op.type, var=n,
                        ))
                    else:
                        param_writes[n] = i
            # (4) sub-block attr sanity + recursion
            sub_idx = op.attrs.get("sub_block")
            if sub_idx is not None:
                ok = (isinstance(sub_idx, int)
                      and 0 <= sub_idx < len(program.blocks)
                      and sub_idx != block.idx)
                if not ok:
                    diags.append(Diagnostic(
                        "orphan_sub_block", SEV_ERROR,
                        f"sub_block attr {sub_idx!r} does not name a valid "
                        f"other block (program has {len(program.blocks)})",
                        block=block.idx, op_idx=i, op_type=op.type,
                    ))
                elif sub_idx in visited:
                    diags.append(Diagnostic(
                        "orphan_sub_block", SEV_ERROR,
                        f"sub_block {sub_idx} is referenced more than once "
                        f"or recursively",
                        block=block.idx, op_idx=i, op_type=op.type,
                    ))
                else:
                    sub = program.blocks[sub_idx]
                    if sub.parent_idx != block.idx:
                        diags.append(Diagnostic(
                            "orphan_sub_block", SEV_WARNING,
                            f"sub_block {sub_idx} has parent_idx "
                            f"{sub.parent_idx}, expected {block.idx}",
                            block=block.idx, op_idx=i, op_type=op.type,
                        ))
                    seed = set(defined)
                    if op.type in _LOOP_OPS:
                        # loop carry: body reads of body-written names see
                        # the previous iteration's value
                        seed |= _block_writes(program, sub)
                    if op.type == "dynamic_rnn":
                        seed |= set(op.attrs.get("step_vars", []))
                        seed |= set(op.attrs.get("mem_vars", []))
                    if op.type == "pipeline":
                        seed.add(op.attrs.get("carry_in"))
                        seed |= set(op.attrs.get("canonical_params", []))
                    walk(sub, seed)
                    # control-flow writes surface to the outer env
                    defined |= _block_writes(program, sub)
            defined.update(op.output_arg_names)
            if op.type == "backward":
                defined.update(op.attrs.get("grad_names", []))

    walk(program.blocks[0], _initially_defined(program.blocks[0]))
    for blk in program.blocks[1:]:
        if blk.idx not in visited and blk.ops:
            diags.append(Diagnostic(
                "orphan_sub_block", SEV_WARNING,
                f"block {blk.idx} is referenced by no op (orphaned "
                f"sub-block with {len(blk.ops)} ops)",
                block=blk.idx,
            ))
    return diags


def verify_feed_fetch(program: Program, feed_names=None, fetch_names=None
                      ) -> List[Diagnostic]:
    """Feed/fetch target existence — the executor knows these at run time."""
    diags: List[Diagnostic] = []
    produced = set()
    for blk in program.blocks:
        for op in blk.ops:
            produced.update(op.output_arg_names)
            if op.type == "backward":
                produced.update(op.attrs.get("grad_names", []))
    feed_names = list(feed_names or [])
    for n in fetch_names or []:
        v = program.blocks[0]._find_var_recursive(n)
        ok = (n in produced or n in feed_names
              or (v is not None and (v.persistable or v.is_data)))
        if not ok:
            diags.append(Diagnostic(
                "fetch_target_missing", SEV_ERROR,
                f"fetch target {n!r} is produced by no op and is not "
                f"feedable state",
                var=n,
            ))
    for n in feed_names:
        found = any(n in blk.vars for blk in program.blocks)
        if not found:
            diags.append(Diagnostic(
                "feed_target_unknown", SEV_WARNING,
                f"feed {n!r} matches no declared variable (dtype/shape "
                f"validation cannot apply)",
                var=n,
            ))
    return diags


# --------------------------------------------------------------------------
# whole-program shape re-inference (FLAGS_verify_program=full)
# --------------------------------------------------------------------------

def verify_shapes(program: Program) -> List[Diagnostic]:
    """Re-run every registered infer fn over the (possibly rewritten)
    program; conflicts become diagnostics instead of raises.  Runs the
    rules read-only: verification never fills/narrows declared shapes."""
    global _READONLY
    diags: List[Diagnostic] = []
    prev, _READONLY = _READONLY, True
    try:
        for blk in program.blocks:
            for i, op in enumerate(blk.ops):
                d = registry.get_op_def_or_none(op.type)
                if d is None or d.infer is None:
                    continue
                try:
                    d.infer(op, blk)
                except StaticAnalysisError as e:
                    diags.append(Diagnostic(
                        "shape_dtype", SEV_ERROR, str(e),
                        block=blk.idx, op_idx=i, op_type=op.type,
                    ))
    finally:
        _READONLY = prev
    return diags


def infer_coverage(programs: Sequence[Program]) -> Dict[str, Any]:
    """Fraction of op TYPES appearing in `programs` that have an infer fn
    (the `analysis.infer_coverage_frac` proof for the model zoo)."""
    types = set()
    n_ops = 0
    n_ops_covered = 0
    for p in programs:
        for blk in p.blocks:
            for op in blk.ops:
                if op.type in STRUCTURAL_OPS:
                    continue
                types.add(op.type)
                n_ops += 1
                d = registry.get_op_def_or_none(op.type)
                if d is not None and d.infer is not None:
                    n_ops_covered += 1
    covered = sorted(
        t for t in types
        if (registry.get_op_def_or_none(t) is not None
            and registry.get_op_def_or_none(t).infer is not None)
    )
    missing = sorted(types - set(covered))
    frac = (len(covered) / len(types)) if types else 1.0
    return {
        "covered_types": covered,
        "missing_types": missing,
        "frac": frac,
        "op_frac": (n_ops_covered / n_ops) if n_ops else 1.0,
    }


# --------------------------------------------------------------------------
# hazard lints
# --------------------------------------------------------------------------

def lint_donation(program: Program) -> List[Diagnostic]:
    """In-place persistable updates (the Adam kernel writes its parameter
    and moments in place) that are read again later in the same block: the
    reader silently observes post-update state, and the pre-update value no
    longer exists -- a rewrite reordering either op changes numerics
    without any error."""
    diags: List[Diagnostic] = []
    for blk in program.blocks:
        inplace_at: Dict[str, Tuple[int, str]] = {}
        for i, op in enumerate(blk.ops):
            in_names = set(op.input_arg_names)
            for n in op.output_arg_names:
                if n not in in_names or n in inplace_at:
                    continue
                v = blk._find_var_recursive(n)
                if v is not None and v.persistable:
                    inplace_at[n] = (i, op.type)
        for i, op in enumerate(blk.ops):
            for n in set(op.input_arg_names):
                hit = inplace_at.get(n)
                if hit is not None and hit[0] < i:
                    diags.append(Diagnostic(
                        "donation_hazard", SEV_WARNING,
                        f"reads {n!r} after op #{hit[0]} ({hit[1]}) updated "
                        f"it in place; the donated pre-update buffer is "
                        f"gone and pass reordering would change numerics",
                        block=blk.idx, op_idx=i, op_type=op.type, var=n,
                    ))
    return diags


def lint_recompile(program: Program) -> List[Diagnostic]:
    """Feed vars whose NON-batch dims are dynamic: every distinct feed
    shape is a new plan (the plan-cache key includes the feed signature)
    and, on the card, a new CUDA graph, so such feeds never amortize --
    bucket/pad them instead (what the LoD padded carrier already does for
    its time dim)."""
    diags: List[Diagnostic] = []
    for v in program.list_vars():
        if not v.is_data or v.shape is None:
            continue
        allowed = 2 if v.lod_level >= 1 else 1  # batch (+ bucketed time)
        dyn = [i for i, d in enumerate(v.shape) if d == DYN and i >= allowed]
        if dyn:
            diags.append(Diagnostic(
                "recompile_hazard", SEV_WARNING,
                f"feed var {v.name!r} shape {tuple(v.shape)} has dynamic "
                f"non-batch dims {dyn}: every distinct feed shape builds "
                f"a new plan; pad to fixed shape buckets",
                block=v.block.idx, var=v.name,
            ))
    return diags


def lint_determinism(program: Program) -> List[Diagnostic]:
    """RNG-consuming ops in a program with no random_seed: run-to-run
    results are irreproducible and resume-replay cannot be bit-exact."""
    if program.random_seed is not None:
        return []
    diags: List[Diagnostic] = []
    for blk in program.blocks:
        for i, op in enumerate(blk.ops):
            if op.type not in RNG_OPS:
                continue
            if op.type == "dropout":
                if op.attr("is_test", False) or op.attr("fix_seed", False):
                    continue
            elif op.attr("seed", 0):
                continue
            out = op.output_arg_names[0] if op.output_arg_names else None
            diags.append(Diagnostic(
                "nondeterministic_rng", SEV_WARNING,
                f"RNG op {op.type!r} with no op seed in a program with no "
                f"random_seed: results are not reproducible",
                block=blk.idx, op_idx=i, op_type=op.type, var=out,
            ))
    return diags


def collective_signature(program: Program) -> List[Tuple]:
    """Static order of collective-issuing ops, with their mesh axis and
    whether they sit under divergent (conditional) control flow."""
    sig: List[Tuple] = []

    def walk(block: Block, divergent: bool, seen):
        if block.idx in seen:
            return
        seen.add(block.idx)
        for op in block.ops:
            if op.type in COLLECTIVE_OPS:
                axis = op.attr(COLLECTIVE_OPS[op.type], None)
                sig.append((op.type, axis, block.idx, divergent))
            sub = op.attrs.get("sub_block")
            if isinstance(sub, int) and 0 <= sub < len(program.blocks):
                walk(program.blocks[sub],
                     divergent or op.type == "conditional_block", seen)

    walk(program.blocks[0], False, set())
    return sig


def lint_collective_order(programs: Sequence[Program]) -> List[Diagnostic]:
    """All ranks must issue collectives in the same static order.
    Single-program mode flags collectives under divergent control flow;
    multi-program mode additionally diffs the per-rank signatures."""
    diags: List[Diagnostic] = []
    sigs = [collective_signature(p) for p in programs]
    for (op_type, axis, blk_idx, divergent) in sigs[0]:
        if divergent:
            diags.append(Diagnostic(
                "collective_order", SEV_WARNING,
                f"collective op {op_type!r} (axis {axis!r}) sits under a "
                f"conditional_block: ranks whose predicates diverge will "
                f"issue collectives in different orders and deadlock",
                block=blk_idx, op_type=op_type,
            ))
    base = [(t, a) for (t, a, _, _) in sigs[0]]
    for rank, sig in enumerate(sigs[1:], start=1):
        other = [(t, a) for (t, a, _, _) in sig]
        if other == base:
            continue
        n = min(len(base), len(other))
        at = next((i for i in range(n) if base[i] != other[i]), n)
        ours = base[at] if at < len(base) else None
        theirs = other[at] if at < len(other) else None
        diags.append(Diagnostic(
            "collective_order", SEV_ERROR,
            f"rank-program {rank} issues collectives in a different static "
            f"order: position {at} is {theirs} vs rank 0's {ours} — this "
            f"deadlocks the gang at runtime",
            op_type=theirs[0] if theirs else (ours[0] if ours else None),
        ))
    return diags


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

LEVELS = ("off", "structural", "full")


def verify_program(program: Program, level: str = "structural",
                   feed_names=None, fetch_names=None,
                   sibling_programs: Optional[Sequence[Program]] = None
                   ) -> List[Diagnostic]:
    """Run the analysis suite at `level`; returns diagnostics (errors and
    warnings).  `structural` = verifier (+ feed/fetch when given); `full`
    adds whole-program shape re-inference and the hazard lints."""
    if level in (None, "", "off"):
        return []
    if level not in LEVELS:
        raise ValueError(f"verify_program: unknown level {level!r}; "
                         f"one of {LEVELS}")
    diags = verify_structure(program)
    if feed_names or fetch_names:
        diags += verify_feed_fetch(program, feed_names, fetch_names)
    if level == "full":
        diags += verify_shapes(program)
        diags += lint_donation(program)
        diags += lint_recompile(program)
        diags += lint_determinism(program)
        diags += lint_collective_order(
            [program] + list(sibling_programs or []))
        cov = infer_coverage([program])
        _MON.gauge("analysis.infer_coverage_frac").set(cov["frac"])
    _MON.counter("analysis.verify_runs").inc()
    for d in diags:
        _MON.counter(f"analysis.diag.{d.code}").inc()
    return diags


def check_program(program: Program, level: str = "structural",
                  feed_names=None, fetch_names=None,
                  sibling_programs=None) -> List[Diagnostic]:
    """`verify_program`, raising `ProgramVerificationError` on any
    error-severity diagnostic.  Returns the (warning-only) diagnostics."""
    diags = verify_program(program, level, feed_names, fetch_names,
                           sibling_programs)
    errors = [d for d in diags if d.severity == SEV_ERROR]
    if errors:
        lines = "\n".join(f"  {d}" for d in errors)
        raise ProgramVerificationError(
            f"program verification failed ({len(errors)} error(s)):\n{lines}",
            errors,
        )
    return diags
