"""Static resource planner: liveness-based peak device memory and a per-op
cost model (counterpart of paddle_tpu/core/resource_plan.py; torch only for
dtype sizes and the card's memory).

  * **Liveness / peak memory** (`plan_program`): every non-persistable
    value gets a def / last-use interval over its block; persistables
    (parameters, optimizer state, batch-norm statistics) are resident for
    the whole program; an op that writes a persistable it also reads
    updates it in place (counted once), while a written-but-never-read
    persistable costs a transient double buffer at its writer.  Sub-block
    (while / conditional_block / dynamic_rnn) temps peak inside the owning
    op and die at its end.  A `backward` op keeps every earlier temp live
    up to itself (the activations its VJP reads).  The result is a
    `ResourcePlan`: the peak bytes (persistables + staged feeds + the peak
    of live temps), the op at the peak and the buffers live there.

  * **Op cost model**: per-op FLOPs and bytes moved from cost rules
    registered beside the lowerings in ops/* (`registry.set_cost`,
    `register_cost` and the factories below; `_default_cost` prices an op
    without a rule and `cost_coverage` names it).  Rolled up to a roofline
    step time (per op, the larger of flops / CHIP_PEAK_FLOPS and bytes /
    CHIP_HBM_BANDWIDTH; ops ahead of a `backward` count 3x: forward and
    twice that for the backward) and a `predicted_mfu`, the MFU the program
    could reach at that roofline.

The rules, the liveness and the roll-up are the JAX package's, so both
packages give the same rows, totals and peak for the same program and feed
shapes.  The chip model is one dense peak and one memory stream, as the JAX
package's is: a float32 program is priced against the same bf16 peak (the
card's float32 rate is lower; the model does not know dtypes).

Consumers: the executor pre-checks every plan-cache miss and raises
`errors.ResourceError` (phase="build") naming the watermark ops when the
plan exceeds the card's memory, before the plan is built or anything of
the step is allocated (`precheck_program`, FLAGS_resource_precheck /
FLAGS_resource_hbm_limit_mb); the serving registry's pre-load estimate
(serving/registry.py `plan_model_bytes`) prices a model at the largest
bucket it will warm (on the card a graphed bucket also keeps its CUDA
graph's private pool, which no plan prices); `tools/port_resource_plan.py`
renders the plans of the port's zoo, gates their coverage and calibrates
their peaks against the allocator on the card.

Estimates are conservative upper bounds: the lowerings free what the op
graph keeps live, and the roofline's byte count charges every op's inputs
and outputs in full.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..errors import ResourceError
from ..monitor import MONITOR as _MON
from . import registry
from .analysis import STRUCTURAL_OPS
from .dtypes import as_torch_dtype
from .program import Block, Program

__all__ = [
    # chip model
    "CHIP_PEAK_FLOPS", "CHIP_HBM_BANDWIDTH", "CHIP_HBM_BYTES",
    # cost rules
    "CostContext", "as_cost", "register_cost", "register_elementwise_cost",
    "register_bytes_cost", "register_state_update_cost", "cost_coverage",
    "op_cost",
    # planner
    "ShapeEnv", "PlanRow", "ResourcePlan", "plan_program",
    # consumers
    "device_hbm_limit", "precheck_program",
]

# Chip model: the card as `nvidia-smi --query-gpu=name,power.limit` prints
# it, "NVIDIA H100 80GB HBM3, 700.00 W" (dense bf16 peak without sparsity,
# HBM3 bandwidth and capacity; PERF.md's kernel bounds use the same rates).
# A yardstick, not a simulator: one dense peak, one memory stream.
CHIP_PEAK_FLOPS = 989e12     # bf16 dense peak, FLOP/s
CHIP_HBM_BANDWIDTH = 3.35e12  # bytes/s
CHIP_HBM_BYTES = 80e9        # HBM capacity

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
        self._nbytes: Dict[str, int] = {}

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
        # memoized: the sweep and the cost rules ask for each name many
        # times, and the executor plans every plan-cache miss
        b = self._nbytes.get(name)
        if b is None:
            s = self.shape(name)
            b = 0 if s is None else _elems(s) * _itemsize(self.dtype(name))
            self._nbytes[name] = b
        return b

    def feed_resident_bytes(self) -> int:
        """Bytes the staged feeds pin (with any [steps] stacking)."""
        total = 0
        for n, s in self.feed_bytes_shapes.items():
            total += _elems(s) * _itemsize(self.dtype(n))
        return total


# --------------------------------------------------------------------------
# per-op cost rules
# --------------------------------------------------------------------------

class CostContext:
    """Handed to cost rules: slot-level access to CONCRETE shapes (dynamic
    dims bound via ShapeEnv) plus byte-traffic helpers."""

    def __init__(self, op, block: Block, env: ShapeEnv):
        self.op = op
        self.block = block
        self.env = env

    def attr(self, name, default=None):
        return self.op.attr(name, default)

    def in_name(self, slot: str, i: int = 0) -> Optional[str]:
        names = self.op.input(slot)
        return names[i] if i < len(names) else None

    def out_name(self, slot: str, i: int = 0) -> Optional[str]:
        names = self.op.output(slot)
        return names[i] if i < len(names) else None

    def in_shape(self, slot: str, i: int = 0) -> Optional[Tuple[int, ...]]:
        n = self.in_name(slot, i)
        return None if n is None else self.env.shape(n)

    def out_shape(self, slot: str, i: int = 0) -> Optional[Tuple[int, ...]]:
        n = self.out_name(slot, i)
        return None if n is None else self.env.shape(n)

    def in_elems(self, slot: str, i: int = 0) -> int:
        return _elems(self.in_shape(slot, i))

    def out_elems(self, slot: str, i: int = 0) -> int:
        return _elems(self.out_shape(slot, i))

    def out_elems_total(self) -> int:
        return sum(_elems(self.env.shape(n))
                   for n in self.op.output_arg_names)

    def io_bytes(self) -> int:
        """Default traffic: every distinct input read once + every distinct
        output written once."""
        total = 0
        for n in dict.fromkeys(self.op.input_arg_names):
            total += self.env.nbytes(n)
        for n in dict.fromkeys(self.op.output_arg_names):
            total += self.env.nbytes(n)
        return total


def as_cost(rule):
    """Adapt rule(ctx) -> (flops, bytes) to the registry's CostFn."""

    def cost(op, block, env):
        return rule(CostContext(op, block, env))

    cost._cost_rule = rule
    return cost


def register_cost(types: Sequence[str], rule):
    """Attach one cost rule to several registered op types."""
    fn = as_cost(rule)
    for t in types:
        registry.set_cost(t, fn)
    return fn


def register_elementwise_cost(*types, flops_per_elem: float = 1.0):
    """flops_per_elem per OUTPUT element; traffic = inputs + outputs once.
    Right for the unary/binary/compare/activation families (and the
    transcendental ones with a higher flops_per_elem)."""

    def rule(ctx: CostContext):
        return flops_per_elem * ctx.out_elems_total(), ctx.io_bytes()

    return register_cost(types, rule)


def register_bytes_cost(*types):
    """Pure data movement (reshape/cast/concat/transpose/gather...): zero
    FLOPs, traffic = inputs + outputs."""

    def rule(ctx: CostContext):
        return 0.0, ctx.io_bytes()

    return register_cost(types, rule)


def register_state_update_cost(*types, flops_per_elem: float = 4.0):
    """Optimizer-style updates: a few FLOPs per parameter element; traffic
    = every state slot read + its `<Slot>Out` written (which io_bytes
    already counts, in place or not: an in-place update saves residency,
    not traffic)."""

    def rule(ctx: CostContext):
        return flops_per_elem * ctx.in_elems("Param"), ctx.io_bytes()

    return register_cost(types, rule)


# Unregistered op types fall back to 1 FLOP per output element + io
# traffic, and `cost_coverage` names them.
def _default_cost(op, block, env):
    ctx = CostContext(op, block, env)
    return float(ctx.out_elems_total()), float(ctx.io_bytes())


def op_cost(op, block: Block, env: ShapeEnv) -> Tuple[float, float, bool]:
    """(flops, traffic_bytes, covered) for one op."""
    d = registry.get_op_def_or_none(op.type)
    if d is None or d.cost is None:
        f, b = _default_cost(op, block, env)
        return f, b, False
    f, b = d.cost(op, block, env)
    return float(f), float(b), True


def cost_coverage(programs: Sequence[Program]) -> Dict[str, Any]:
    """Fraction of op TYPES appearing in `programs` that have a registered
    cost rule (feed / fetch / backward are structural and exempt: the
    backward's cost is the 3x grad factor)."""
    types = set()
    for p in programs:
        for blk in p.blocks:
            for op in blk.ops:
                if op.type not in STRUCTURAL_OPS:
                    types.add(op.type)
    covered = sorted(
        t for t in types
        if (registry.get_op_def_or_none(t) is not None
            and registry.get_op_def_or_none(t).cost is not None))
    missing = sorted(types - set(covered))
    return {"covered_types": covered, "missing_types": missing,
            "frac": (len(covered) / len(types)) if types else 1.0}


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@dataclass
class PlanRow:
    """One op's contribution: cost + the live set AT this op."""

    op_idx: int
    op_type: str
    flops: float            # forward FLOPs (before the grad factor)
    traffic_bytes: float    # forward bytes moved
    grad_factor: int        # 3 when a later `backward` differentiates this op
    live_bytes: int         # temps live at this op (+ sub-block peak here)
    cost_covered: bool


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
    flops_total: float = 0.0           # grad-factored
    traffic_bytes_total: float = 0.0   # grad-factored
    roofline_step_s: float = 0.0
    predicted_mfu: float = 0.0
    cost_coverage_frac: float = 1.0
    cost_missing_types: List[str] = field(default_factory=list)

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
            "flops_total": self.flops_total,
            "traffic_bytes_total": self.traffic_bytes_total,
            "roofline_step_s": self.roofline_step_s,
            "predicted_mfu": self.predicted_mfu,
            "cost_coverage_frac": self.cost_coverage_frac,
            "cost_missing_types": list(self.cost_missing_types),
        }


def _plan_block(program: Program, block: Block, env: ShapeEnv,
                persistable: set, feeds: set, fetch_names: set,
                rows: Optional[List[PlanRow]] = None):
    """Liveness + cost sweep over one block.

    Returns (peak_temp_bytes, peak_op_idx, live_at_peak: {name: bytes})
    where peak_temp_bytes covers this block's temps only — persistables
    and feeds are the caller's resident base; each op's cost goes to
    `rows`, which plan_program rolls up.  Sub-blocks
    contribute their own peak at the owning op and their temps DIE at the
    owning op's end (loop-carried names live in the loop's carry buffers,
    which the sub-block's own liveness covers)."""
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
                # an in-place update (read + written) counts once in the
                # resident base; a written-but-NEVER-read persistable (the
                # donation audit's `copied_not_read` class) cannot be
                # updated in place, so its writer pays a transient double
                # buffer
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
    has_backward = bool(backward_idxs)
    last_bwd = backward_idxs[-1] if has_backward else -1
    for i, op in enumerate(ops):
        gf = 3 if (has_backward and i < last_bwd
                   and op.type not in STRUCTURAL_OPS) else 1
        sub = None
        if i in sub_at:
            # recurse HERE, where the owner's grad factor is known: body ops
            # ahead of a parent-block `backward` are differentiated too, so
            # their rows inherit the owner's factor.  One body execution
            # (trip counts are not static).  Loop-carried names need no
            # special seeding: a body read of a not-yet-defined temp starts
            # its interval at the read, which covers the whole body — the
            # carry buffer is live across iterations either way.
            n_rows_before = len(rows) if rows is not None else 0
            sub_peak, _sp_op, sub_live = _plan_block(
                program, sub_at[i], env, persistable, feeds, fetch_names,
                rows=rows)
            if rows is not None and gf != 1:
                for r in rows[n_rows_before:]:
                    r.grad_factor *= gf
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
        if op.type == "backward":
            flops, traffic, covered = 0.0, 0.0, True
        else:
            flops, traffic, covered = op_cost(op, block, env)
        if rows is not None:
            rows.append(PlanRow(op_idx=i, op_type=op.type, flops=flops,
                                traffic_bytes=traffic, grad_factor=gf,
                                live_bytes=here, cost_covered=covered))
        for m in end_events.get(i, ()):
            b = live.pop(m, 0)
            live_total -= b
    return peak, peak_idx, peak_live


def plan_program(program: Program, feed_shapes: Optional[Dict[str, tuple]] = None,
                 fetch_names: Optional[Sequence[str]] = None,
                 steps: int = 1, top_k: int = 6) -> ResourcePlan:
    """Build the ResourcePlan for one program at concrete feed shapes.

    `feed_shapes` may carry a leading [steps] axis when `steps > 1` (the
    executor's stacked multi-step dispatch); the liveness model is per-step
    (the steps run one after another on the same buffers) while the staged
    feeds count at their full stacked size."""
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

    # per-op roofline: each op bound by compute OR bandwidth, summed
    roofline = 0.0
    flops_sum = 0.0
    traffic_sum = 0.0
    for r in rows:
        flops_sum += r.flops * r.grad_factor
        traffic_sum += r.traffic_bytes * r.grad_factor
        roofline += max(r.flops * r.grad_factor / CHIP_PEAK_FLOPS,
                        r.traffic_bytes * r.grad_factor / CHIP_HBM_BANDWIDTH)
    mfu = (flops_sum / (roofline * CHIP_PEAK_FLOPS)) if roofline > 0 else 0.0

    # coverage from the sweep's own rows (every reachable op already
    # carries cost_covered)
    types_seen: Dict[str, bool] = {}
    for r in rows:
        if r.op_type not in STRUCTURAL_OPS:
            types_seen[r.op_type] = types_seen.get(r.op_type, True) and r.cost_covered
    cov_missing = sorted(t for t, c in types_seen.items() if not c)
    cov_frac = ((len(types_seen) - len(cov_missing)) / len(types_seen)
                if types_seen else 1.0)
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
        flops_total=flops_sum, traffic_bytes_total=traffic_sum,
        roofline_step_s=roofline, predicted_mfu=mfu,
        cost_coverage_frac=cov_frac,
        cost_missing_types=cov_missing,
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


# --------------------------------------------------------------------------
# the executor's pre-check
# --------------------------------------------------------------------------

def device_hbm_limit(device=None) -> Optional[int]:
    """The bytes the pre-check plans against: FLAGS_resource_hbm_limit_mb
    when set, else a CUDA device's total memory
    (`torch.cuda.mem_get_info(device)[1]`), else None (the CPU has no
    limit)."""
    from ..flags import flag as _flag

    mb = float(_flag("FLAGS_resource_hbm_limit_mb") or 0)
    if mb > 0:
        return int(mb * 1e6)
    if device is None:
        return None
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def precheck_program(program: Program, feed_shapes, fetch_names,
                     steps: int = 1, device=None,
                     limit_bytes: Optional[int] = None) -> Optional[ResourcePlan]:
    """The executor's plan-cache-miss pre-check: plan the program and raise
    `ResourceError` naming the watermark ops when the plan cannot fit,
    before the plan is built or the step allocates anything.  Returns the
    plan (or None when the check is off / no limit is known)."""
    from ..flags import flag as _flag

    if _flag("FLAGS_resource_precheck") in ("", "off"):
        return None
    limit = limit_bytes if limit_bytes is not None else device_hbm_limit(device)
    if not limit:
        return None
    plan = plan_program(program, feed_shapes, fetch_names, steps=steps)
    _MON.counter("analysis.resource_prechecks").inc()
    if plan.peak_bytes > limit:
        _MON.counter("analysis.resource_blocked").inc()
        marks = plan.watermark_ops()
        raise ResourceError(
            f"static resource plan predicts peak device memory "
            f"{plan.peak_bytes / 1e6:.1f} MB > limit {limit / 1e6:.1f} MB "
            f"(persistables {plan.persistable_bytes / 1e6:.1f} MB, feeds "
            f"{plan.feed_bytes / 1e6:.1f} MB, live temps "
            f"{plan.peak_temp_bytes / 1e6:.1f} MB at {marks[0] if marks else '?'}); "
            f"watermark: {'; '.join(marks)} — shrink the batch, enable "
            f"BuildStrategy.memory_optimize (remat), or shard "
            f"(raised before the plan is built or anything is allocated; "
            f"FLAGS_resource_precheck=off skips this check)",
            needed_bytes=plan.peak_bytes, limit_bytes=int(limit),
            watermark_ops=marks)
    return plan
