"""Static resource planner: liveness-based peak device memory (counterpart
of paddle_tpu/core/resource_plan.py's planner; torch only for dtype sizes).

`plan_program(program, feed_shapes, fetch_names)` gives every
non-persistable value a def / last-use interval over its block;
persistables (parameters, optimizer state, batch-norm statistics) are
resident for the whole program; an op that writes a persistable it also
reads updates it in place (counted once), while a written-but-never-read
persistable costs a transient double buffer at its writer.  Sub-block
(while / conditional_block / dynamic_rnn) temps peak inside the owning op
and die at its end.  A `backward` op keeps every earlier temp live up to
itself (the activations its VJP reads).  The result is a `ResourcePlan`:
the peak bytes (persistables + staged feeds + the peak of live temps), the
op at the peak and the buffers live there.  The liveness is the JAX
package's, so both packages give the same peak bytes for the same program
and feed shapes.

The JAX package's per-op cost model (FLOPs, bytes moved, roofline step
time) is not ported: it comes with its rules and the `resource_plan` tool
in ROADMAP A9.6.

Consumer: the serving registry's pre-load estimate (serving/registry.py
`plan_model_bytes`) prices a model at the largest bucket it will warm
(weights, live activations and staged feeds).  On the card a graphed
bucket also keeps its CUDA graph's private pool; chip_smoke phase 59
prints the estimate beside the allocator's bytes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .dtypes import as_torch_dtype
from .program import Block, Program

__all__ = ["ShapeEnv", "PlanRow", "ResourcePlan", "plan_program"]

DYN = -1

# Sub-block-owning op types whose body executes under the op (the same
# vocabulary the verifier walks).
_SUB_BLOCK_OPS = ("while", "conditional_block", "dynamic_rnn", "pipeline")


def _itemsize(dtype_name: Optional[str]) -> int:
    if not dtype_name:
        return 4
    if "float16" in dtype_name or dtype_name == "bfloat16":
        return 2
    try:
        return as_torch_dtype(dtype_name).itemsize
    except (KeyError, ValueError):
        return 4


def _elems(shape: Optional[Sequence[int]]) -> int:
    if shape is None:
        return 0
    n = 1
    for d in shape:
        n *= max(int(d), 1)
    return n


class ShapeEnv:
    """Concrete per-var byte sizes: declared shapes with dynamic (-1) dims
    bound from the feed shapes (the batch, plus the bucketed time dim the
    LoD carrier pads).  Feeds take their ACTUAL shapes; everything else
    takes its declared shape with each -1 replaced by the batch size."""

    def __init__(self, program: Program, feed_shapes: Optional[Dict[str, tuple]] = None,
                 steps: int = 1):
        self.program = program
        self.steps = max(int(steps), 1)
        raw = {n: tuple(int(d) for d in s)
               for n, s in (feed_shapes or {}).items()}
        self.feed_bytes_shapes = dict(raw)  # with any leading [steps] axis
        if self.steps > 1:  # per-step shapes bind the batch dim
            raw = {n: s[1:] if len(s) > 0 else s for n, s in raw.items()}
        self.feed_shapes = raw
        self._vars: Dict[str, Any] = {}
        for blk in program.blocks:
            for n, v in blk.vars.items():
                self._vars.setdefault(n, v)
        batch = None
        for n, s in raw.items():
            v = self._vars.get(n)
            if (v is not None and v.shape and len(v.shape) > 0
                    and v.shape[0] == DYN and s):
                batch = int(s[0])
                break
        if batch is None:
            for s in raw.values():
                if s:
                    batch = int(s[0])
                    break
        self.batch = batch or 1

    def var(self, name: str):
        return self._vars.get(name)

    def shape(self, name: str) -> Optional[Tuple[int, ...]]:
        if name in self.feed_shapes:
            return self.feed_shapes[name]
        v = self._vars.get(name)
        if v is None or v.shape is None:
            return None
        return tuple(self.batch if int(d) == DYN else int(d) for d in v.shape)

    def dtype(self, name: str) -> Optional[str]:
        v = self._vars.get(name)
        return None if v is None else v.dtype

    def nbytes(self, name: str) -> int:
        s = self.shape(name)
        if s is None:
            return 0
        return _elems(s) * _itemsize(self.dtype(name))

    def feed_resident_bytes(self) -> int:
        """Bytes the staged feeds pin (with any [steps] stacking)."""
        total = 0
        for n, s in self.feed_bytes_shapes.items():
            total += _elems(s) * _itemsize(self.dtype(n))
        return total


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@dataclass
class PlanRow:
    """One op's row: the temps live AT this op."""

    op_idx: int
    op_type: str
    live_bytes: int         # temps live at this op (+ sub-block peak here)


@dataclass
class ResourcePlan:
    """Static resource estimate for one (program, feed shapes) pair."""

    batch: int
    steps: int
    persistable_bytes: int
    feed_bytes: int
    peak_bytes: int              # persistable + feeds + peak live temps
    peak_temp_bytes: int
    peak_op_idx: Optional[int]
    peak_op_type: Optional[str]
    # the buffers live at the peak, largest first:
    # {var, bytes, def_op_idx, def_op_type}
    watermark: List[dict] = field(default_factory=list)
    rows: List[PlanRow] = field(default_factory=list)

    def watermark_ops(self) -> List[str]:
        """Human-readable attribution of the predicted peak: the op at the
        peak plus the def sites of the largest live buffers."""
        out = []
        if self.peak_op_idx is not None:
            out.append(f"op #{self.peak_op_idx} ({self.peak_op_type})")
        for w in self.watermark:
            if w.get("def_op_idx") is not None:
                tag = f"op #{w['def_op_idx']} ({w['def_op_type']})"
                ent = f"{w['var']} ({w['bytes'] / 1e6:.1f} MB, def {tag})"
            else:
                ent = f"{w['var']} ({w['bytes'] / 1e6:.1f} MB)"
            out.append(ent)
        return out

    def to_dict(self) -> dict:
        return {
            "batch": self.batch, "steps": self.steps,
            "persistable_bytes": self.persistable_bytes,
            "feed_bytes": self.feed_bytes,
            "peak_bytes": self.peak_bytes,
            "peak_temp_bytes": self.peak_temp_bytes,
            "peak_op_idx": self.peak_op_idx,
            "peak_op_type": self.peak_op_type,
            "watermark": list(self.watermark),
        }


def _plan_block(program: Program, block: Block, env: ShapeEnv,
                persistable: set, feeds: set, fetch_names: set,
                rows: Optional[List[PlanRow]] = None):
    """Liveness sweep over one block.

    Returns (peak_temp_bytes, peak_op_idx, live_at_peak: {name: bytes})
    where peak_temp_bytes covers this block's
    temps only — persistables and feeds are the caller's resident base.
    Sub-blocks contribute their own peak at the owning op and their temps
    DIE at the owning op's end (loop-carried names live in the loop's
    carry buffers, which the sub-block's own liveness covers)."""
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    n = len(ops)
    resident = persistable | feeds

    # pass 1: def / last-use intervals (+ grad defs, + backward extension)
    def_at: Dict[str, int] = {}
    last_use: Dict[str, int] = {}
    backward_idxs: List[int] = []
    sub_at: Dict[int, Block] = {}
    double_buffer: Dict[int, int] = {}
    for i, op in enumerate(ops):
        reads = list(op.input_arg_names)
        writes = list(op.output_arg_names)
        if op.type == "backward":
            backward_idxs.append(i)
            reads.append(op.attrs.get("loss_name"))
        for m in reads:
            if m is None or m in resident:
                continue
            last_use[m] = i
            def_at.setdefault(m, i)  # read-before-def (loop carry): resident-at-0
        ins = set(op.input_arg_names)
        for m in writes:
            if m in persistable:
                # donated in-place update (read+written) counts once in the
                # resident base; a written-but-NEVER-read persistable is the
                # donation audit's `copied_not_read` class — XLA cannot
                # alias it, so its writer pays a transient double buffer
                if m not in ins:
                    double_buffer[i] = double_buffer.get(i, 0) + env.nbytes(m)
                continue
            if m in feeds:
                continue
            def_at.setdefault(m, i)
            last_use[m] = max(last_use.get(m, i), i)
        sub_idx = op.attrs.get("sub_block")
        if (op.type in _SUB_BLOCK_OPS and isinstance(sub_idx, int)
                and 0 <= sub_idx < len(program.blocks)
                and sub_idx != block.idx):
            sub_at[i] = program.blocks[sub_idx]

    # fetched values stay live to the end of the block (copied out)
    for m in fetch_names:
        if m in def_at:
            last_use[m] = n - 1
    # activations: every temp defined before a backward op is (potentially)
    # saved for the VJP, so it stays live until the backward runs
    for bi in backward_idxs:
        for m, d in def_at.items():
            if d < bi:
                last_use[m] = max(last_use.get(m, d), bi)

    # pass 2: the sweep
    start_events: Dict[int, List[str]] = {}
    end_events: Dict[int, List[str]] = {}
    for m, d in def_at.items():
        start_events.setdefault(d, []).append(m)
        end_events.setdefault(max(last_use.get(m, d), d), []).append(m)
    live: Dict[str, int] = {}
    peak = 0
    peak_idx: Optional[int] = None
    peak_live: Dict[str, int] = {}
    live_total = 0
    for i, op in enumerate(ops):
        sub = None
        if i in sub_at:
            # one body execution (trip counts are not static).  Loop-carried
            # names need no special seeding: a body read of a not-yet-defined
            # temp starts its interval at the read, which covers the whole
            # body — the carry buffer is live across iterations either way.
            sub_peak, _sp_op, sub_live = _plan_block(
                program, sub_at[i], env, persistable, feeds, fetch_names,
                rows=rows)
            sub = (sub_peak, sub_live)
        for m in start_events.get(i, ()):
            b = env.nbytes(m)
            if b and m not in live:
                live[m] = b
                live_total += b
        here = live_total + double_buffer.get(i, 0)
        if sub is not None:
            here += sub[0]
        if here > peak:
            peak, peak_idx = here, i
            peak_live = dict(live)
            if sub is not None:
                peak_live.update(sub[1])
            if double_buffer.get(i):
                for m in op.output_arg_names:
                    if m in persistable and m not in set(op.input_arg_names):
                        peak_live[m] = env.nbytes(m)
        if rows is not None:
            rows.append(PlanRow(op_idx=i, op_type=op.type, live_bytes=here))
        for m in end_events.get(i, ()):
            b = live.pop(m, 0)
            live_total -= b
    return peak, peak_idx, peak_live


def plan_program(program: Program, feed_shapes: Optional[Dict[str, tuple]] = None,
                 fetch_names: Optional[Sequence[str]] = None,
                 steps: int = 1, top_k: int = 6) -> ResourcePlan:
    """Build the ResourcePlan for one program at concrete feed shapes.

    `feed_shapes` may carry a leading [steps] axis when `steps > 1` (the
    executor's stacked multi-step dispatch); the liveness model is
    per-step (lax.scan reuses buffers) while the staged feeds count at
    their full stacked size."""
    env = ShapeEnv(program, feed_shapes, steps=steps)
    block = program.global_block()
    persistable = {v.name for v in program.list_vars() if v.persistable}
    feeds = set(env.feed_shapes)

    persistable_bytes = sum(env.nbytes(nm) for nm in sorted(persistable))
    feed_bytes = env.feed_resident_bytes()

    rows: List[PlanRow] = []
    peak_temp, peak_idx, peak_live = _plan_block(
        program, block, env, persistable, feeds,
        set(fetch_names or ()), rows=rows)

    watermark = [
        {"var": nm, "bytes": b,
         "def_op_idx": _def_idx_of(block, nm),
         "def_op_type": _def_type_of(block, nm)}
        for nm, b in sorted(peak_live.items(), key=lambda kv: -kv[1])[:top_k]
    ]
    peak_op_type = None
    if peak_idx is not None:
        runnable = [op for op in block.ops if op.type not in ("feed", "fetch")]
        if peak_idx < len(runnable):
            peak_op_type = runnable[peak_idx].type
    return ResourcePlan(
        batch=env.batch, steps=env.steps,
        persistable_bytes=int(persistable_bytes),
        feed_bytes=int(feed_bytes),
        peak_bytes=int(persistable_bytes + feed_bytes + peak_temp),
        peak_temp_bytes=int(peak_temp),
        peak_op_idx=peak_idx, peak_op_type=peak_op_type,
        watermark=watermark, rows=rows,
    )


def _def_idx_of(block: Block, name: str) -> Optional[int]:
    idx = 0
    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        if name in op.output_arg_names:
            return idx
        idx += 1
    return None


def _def_type_of(block: Block, name: str) -> Optional[str]:
    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        if name in op.output_arg_names:
            return op.type
    return None

