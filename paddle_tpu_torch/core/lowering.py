"""Eager op interpreter (counterpart of paddle_tpu/core/lowering.py).

Where the JAX package traces a block once into one XLA computation, the
port runs each op's torch lowering in order on real tensors.  A `backward`
op (core/autodiff.py) splits the op list: the forward segment before it
runs with its parameters as leaves that require grad, and
`torch.autograd.grad` takes the place of `jax.vjp`.  A table that only
`is_sparse` lookups read gets a SelectedRows gradient
(core/selected_rows.py): each of its lookups' outputs is an autograd leaf
of its own (`SparseTaps`), whose gradient is that lookup's row slab.
With `ctx.remat` (BuildStrategy.memory_optimize) a region's forward runs
under `torch.utils.checkpoint`, as the JAX package wraps it in
`jax.checkpoint`: autograd keeps only the region's inputs and recomputes
the rest during the backward.

In a gang step (core/executor.py's gang path) the executor installs the
gradient all-reduce as `ctx.grad_sync` (parallel/distributed.py
make_grad_sync), as the JAX package installs its bucketed psum: each
region's gradients are synced before later regions or the optimizer ops
read them, in one flat all-reduce after `torch.autograd.grad` ("serial")
or bucket by bucket from the leaves' tensor hooks while backward runs
("bucketed").  `ctx.global_batch_stats` makes batch norm normalize with the
gang's global batch statistics.

The same code runs eagerly and under CUDA-graph capture
(core/executor.py), so nothing here reads a tensor on the host or moves
a generator's state: a forward that must repeat the step's random draws
(a later backward region, remat's recompute) draws from a generator the
executor synced to the run's generator before the run
(`ctx.rerun_generators`).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .analysis import STRUCTURAL_OPS
from .program import Operator
from .registry import get_op_def
from .selected_rows import SelectedRows


class LoweringContext:
    """Per-run state the lowerings read.

    `generator` draws every random op without a seed attr (the counterpart of
    the JAX package's threaded PRNG key); `device` is where new tensors go;
    `fetch_names` and `read_names` let a lowering skip an output slot that
    nothing reads (eager torch has no dead-code elimination).
    `rerun_generators` are generators in the state `generator` had when the
    run began, one for each forward that repeats the step's draws
    (`rerun_generators_needed`); `persistable` names the vars the executor
    writes back; `constants` holds tensors a lowering builds once per plan
    (`constant`); `remat` checkpoints each backward region's forward.
    `grad_sync` (a gang step's gradient all-reduce) and
    `global_batch_stats` (batch norm over the gang's global batch) are
    set by the executor's gang path."""

    def __init__(self, generator: torch.Generator, device: torch.device, is_test: bool = False,
                 fetch_names: Sequence[str] = (), read_names=frozenset(),
                 rerun_generators: Sequence[torch.Generator] = (), persistable=frozenset(),
                 constants: Optional[dict] = None, remat: bool = False, grad_sync=None,
                 global_batch_stats: bool = False):
        self.generator = generator
        self.device = device
        self.is_test = is_test
        self.fetch_names = tuple(fetch_names)
        self.read_names = frozenset(read_names)
        self.rerun_generators = list(rerun_generators)
        self.persistable = frozenset(persistable)
        self.constants = {} if constants is None else constants
        self.remat = remat
        self.grad_sync = grad_sync
        self.global_batch_stats = global_batch_stats
        self.sparse_taps: Optional["SparseTaps"] = None  # set while a backward region runs
        self.env: Dict[str, torch.Tensor] = {}  # the env of the op being lowered (dynamic_rnn)

    def wants(self, op: Operator, slot: str) -> bool:
        """True when an output of `op` in `slot` is read by an op of the run or fetched."""
        return any(n in self.read_names or n in self.fetch_names for n in op.outputs.get(slot, ()))

    def constant(self, key, build: Callable[[], torch.Tensor]) -> torch.Tensor:
        """`build()`, made at the plan's first run and reused after: a tensor
        made from host data, or from a generator of its own, costs a host
        copy that CUDA-graph capture forbids.  Callers must not write it."""
        t = self.constants.get(key)
        if t is None:
            t = self.constants[key] = build()
        return t

    def take_rerun_generator(self) -> torch.Generator:
        if not self.rerun_generators:
            raise RuntimeError("a forward that repeats the step's random draws found no generator "
                               "synced to the run's start (rerun_generators_needed undercounted)")
        return self.rerun_generators.pop(0)


def rerun_generators_needed(ops: List[Operator], remat: bool) -> int:
    """Forwards of a run that repeat its first forward's random draws: each
    backward region after the first, and with remat each region's recompute."""
    regions = sum(1 for op in ops if op.type == "backward")
    return max(regions - 1, 0) + (regions if remat else 0)


class SparseTaps:
    """The is_sparse lookups of a backward region's forward (counterpart of
    paddle_tpu/core/lowering.py SparseTapCollector).

    Where the JAX package adds a zero delta to each tapped lookup output and
    differentiates by it, torch needs no record phase: the lookup output
    itself, detached, becomes a leaf that requires grad, and its gradient is
    exactly the lookup's per-row slab.  A lookup taps before its
    `padding_idx` mask, so padded positions get a zero gradient."""

    def __init__(self, params):
        self.params = set(params)
        self.taps: list = []  # (table name, flat ids, leaf)

    def tap(self, w_name: str, flat_ids: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        if w_name not in self.params:
            return out
        leaf = out.detach().requires_grad_(True)
        self.taps.append((w_name, flat_ids, leaf))
        return leaf

    def leaves(self) -> List[torch.Tensor]:
        return [leaf for _, _, leaf in self.taps]

    def gradient(self, param: str, table: torch.Tensor, grads) -> SelectedRows:
        """The SelectedRows gradient of `param`, given the gradient of each
        tap's leaf in tap order (None where it does not reach the loss):
        several lookups of one table concatenate, and a table never looked
        up gets an empty slab."""
        dim = table.shape[1] if table.dim() > 1 else 1
        rows, vals = [], []
        for (w_name, ids, leaf), g in zip(self.taps, grads):
            if w_name == param:
                rows.append(ids.reshape(-1).to(torch.int32))
                vals.append((torch.zeros_like(leaf) if g is None else g).reshape(-1, dim))
        if not rows:
            return SelectedRows(torch.zeros(0, dtype=torch.int32, device=table.device),
                                torch.zeros(0, dim, dtype=table.dtype, device=table.device),
                                table.shape[0])
        return SelectedRows(torch.cat(rows), torch.cat(vals), table.shape[0])


def run_ops(ctx: LoweringContext, ops: List[Operator], env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Run `ops` over `env` (var name -> tensor), in order."""
    for op in ops:
        if op.type in STRUCTURAL_OPS:
            raise RuntimeError(f"structural op {op.type!r} reached the interpreter; "
                               "the executor must handle it")
        if op.type == "while":
            run_while(ctx, op, env)
        elif op.type == "conditional_block":
            run_conditional_block(ctx, op, env)
        else:
            lower_one(ctx, op, env)
    return env


def _sub_block_ops(op: Operator) -> List[Operator]:
    return [o for o in op.block.program.blocks[op.attr("sub_block")].ops
            if o.type not in ("feed", "fetch")]


def run_while(ctx: LoweringContext, op: Operator, env: Dict[str, torch.Tensor]) -> None:
    """A `while` op (counterpart of paddle_tpu/ops/control_flow_ops.py): run
    its sub-block while the Condition var is true, reading the condition on
    the host once an iteration.  The carry is what the JAX package's
    lax.while_loop carries: each name the body writes that exists before
    the loop.  Each iteration starts from the env before the loop updated
    by the carry, and only the carry is written back."""
    cond = op.input("Condition")[0]
    if cond not in env:
        raise KeyError(f"while: condition var {cond!r} must exist before the loop")
    body = _sub_block_ops(op)
    written = dict.fromkeys(n for o in body for n in o.output_arg_names)
    carry = {n: env[n] for n in written if n in env}
    carry[cond] = env[cond]
    while bool(carry[cond].reshape(())):
        inner = dict(env)
        inner.update(carry)
        run_ops(ctx, body, inner)
        carry = {n: inner[n] for n in carry}
    env.update(carry)


def run_conditional_block(ctx: LoweringContext, op: Operator,
                          env: Dict[str, torch.Tensor]) -> None:
    """A `conditional_block` op (counterpart of the JAX package's lax.cond
    lowering): read the Cond var on the host; when true, run the sub-block
    and write back every name it writes.  When false, names that exist
    outside keep their values and fresh ones become zeros of the shape the
    true branch would give them: the body runs on a copy of the env with a
    copy of the generator, and only the shapes are kept, so the random
    stream advances on the true branch alone, as under lax.cond."""
    body = _sub_block_ops(op)
    written = list(dict.fromkeys(n for o in body for n in o.output_arg_names))
    if bool(env[op.input("Cond")[0]].reshape(())):
        inner = run_ops(ctx, body, dict(env))
        env.update({n: inner[n] for n in written if n in inner})
        return
    fresh = [n for n in written if n not in env]
    if not fresh:
        return
    gen = ctx.generator
    probe = torch.Generator(device=gen.device)
    probe.set_state(gen.get_state())
    ctx.generator = probe
    try:
        with torch.no_grad():
            inner = run_ops(ctx, body, dict(env))
    finally:
        ctx.generator = gen
    env.update({n: torch.zeros_like(inner[n]) for n in fresh if n in inner})


def lower_one(ctx: LoweringContext, op: Operator, env: Dict[str, torch.Tensor]) -> None:
    opdef = get_op_def(op.type)
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n not in env:
                raise KeyError(
                    f"op {op.type!r} reads {n!r} which is not defined; "
                    "feed it, initialize it via the startup program, or check op order")
            vals.append(env[n])
        ins[slot] = vals
    ctx.env = env
    outs = opdef.lower(ctx, op, ins)
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue  # a slot the lowering skipped: nothing reads it
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        if len(vals) != len(names):
            raise RuntimeError(f"op {op.type!r} slot {slot!r}: lowering returned "
                               f"{len(vals)} values for {len(names)} outputs")
        for n, v in zip(names, vals):
            env[n] = v


def run_block_with_backward(ctx: LoweringContext, ops: List[Operator],
                            env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Run a block that may hold `backward` ops.

    Each region differentiates the whole op prefix before its `backward` op,
    re-run from the block-start env, the first from the run's generator and
    each later one from a rerun generator in the same starting state, so
    every region sees the same dropout masks (the JAX package pins `key0`);
    grads of earlier regions enter later regions as constants.  One region
    runs its forward once.  The ops after the last `backward` (the optimizer
    updates) run without autograd, after every grad is taken, so an in-place
    update never touches a tensor a backward still needs."""
    splits = [i for i, op in enumerate(ops) if op.type == "backward"]
    if not splits:
        with torch.no_grad():
            return run_ops(ctx, ops, env)
    gen = ctx.generator
    start_env = dict(env)
    grads_so_far: Dict[str, torch.Tensor] = {}
    try:
        for k, si in enumerate(splits):
            ctx.generator = gen if k == 0 else ctx.take_rerun_generator()
            env = _run_one_backward_region(ctx, ops, si, start_env, grads_so_far)
    finally:
        ctx.generator = gen
    with torch.no_grad():
        return run_ops(ctx, ops[splits[-1] + 1:], env)


def _run_one_backward_region(ctx: LoweringContext, ops: List[Operator], split: int,
                             start_env: Dict[str, torch.Tensor],
                             grads_so_far: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    bw = ops[split]
    loss_name = bw.attrs["loss_name"]
    param_names: List[str] = list(bw.attrs["param_names"])
    grad_names: List[str] = list(bw.attrs["grad_names"])
    sparse = [n for n in bw.attrs.get("sparse_param_names", []) if n in param_names]
    fwd_ops = [o for o in ops[:split] if o.type != "backward"]

    env = dict(start_env)
    env.update(grads_so_far)
    for p in param_names:
        if p not in env:
            raise KeyError(f"backward: parameter {p!r} not initialized (run the startup program)")
    # dense parameters enter as leaves sharing the scope's storage; a name
    # that is not a float tensor (an int feed, say) gets a zero gradient;
    # a sparse table stays a constant and its lookups are tapped
    leaves = {}
    for p in param_names:
        if p not in sparse and env[p].is_floating_point():
            leaves[p] = env[p].detach().requires_grad_(True)
            env[p] = leaves[p]
    taps = SparseTaps(sparse)
    ctx.sparse_taps = taps if sparse else None
    # the bucketed gradient all-reduce hooks the dense leaves; a dense
    # gradient that is not a leaf (an int feed's zeros) joins at finish
    hooked = None
    if ctx.grad_sync is not None:
        hooked = ctx.grad_sync.hooked([(g, leaves.get(p, start_env[p]))
                                       for p, g in zip(param_names, grad_names) if p not in sparse])
    try:
        with torch.enable_grad():
            if ctx.remat:
                if sparse:
                    raise NotImplementedError(
                        "remat (BuildStrategy.memory_optimize) with is_sparse tables: a "
                        "recompute would tap its lookups again; turn one of the two off")
                keep = ({loss_name} | set(ctx.fetch_names) | ctx.persistable
                        | {n for o in ops[split + 1:] for n in o.input_arg_names})
                env = _checkpointed_forward(ctx, fwd_ops, env, leaves, keep)
            else:
                run_ops(ctx, fwd_ops, env)
            loss = env[loss_name]
            inputs = list(leaves.values()) + taps.leaves()
            got = [None] * len(inputs)
            if inputs and loss.requires_grad:  # else no parameter reaches the loss: zero grads
                got = torch.autograd.grad(loss, inputs, torch.ones_like(loss), allow_unused=True)
    finally:
        ctx.sparse_taps = None
    by_param = dict(zip(leaves, got))
    # downstream ops read the scope's tensors and values without history
    out = {n: (start_env[n] if n in leaves else _detached(v)) for n, v in env.items()}
    named = []
    for p, g in zip(param_names, grad_names):
        if p in sparse:
            gval = taps.gradient(p, start_env[p], got[len(leaves):])
        else:
            gval = by_param.get(p)
            if gval is None:
                gval = torch.zeros_like(start_env[p])
        named.append((g, gval))
    if ctx.grad_sync is not None:
        synced = hooked.finish(named) if hooked is not None else ctx.grad_sync(named)
        named = [(g, synced.get(g, v)) for g, v in named]
    for g, gval in named:
        out[g] = gval
        grads_so_far[g] = gval
    return out


def _checkpointed_forward(ctx: LoweringContext, fwd_ops: List[Operator],
                          env: Dict[str, torch.Tensor], leaves: Dict[str, torch.Tensor],
                          keep) -> Dict[str, torch.Tensor]:
    """Run `fwd_ops` over `env` under torch.utils.checkpoint, with the dense
    parameter `leaves` as its inputs; returns `env` plus the outputs named
    in `keep`.  The recompute draws from a rerun generator in the state the
    forward started from, so it repeats the forward's dropout masks
    (`preserve_rng_state` saves only the default generators, not the
    scope's)."""
    names = list(leaves)
    gens = [ctx.generator, ctx.take_rerun_generator()]
    calls = []
    out_names: List[str] = []

    def forward(*values):
        e = dict(env)
        e.update(zip(names, values))
        ctx.generator = gens[min(len(calls), 1)]
        calls.append(None)
        try:
            run_ops(ctx, fwd_ops, e)
        finally:
            ctx.generator = gens[0]
        if not out_names:
            produced = dict.fromkeys(n for o in fwd_ops for n in o.output_arg_names)
            out_names.extend(n for n in produced if n in keep and n in e)
        return tuple(e[n] for n in out_names)

    outs = checkpoint(forward, *leaves.values(), use_reentrant=False, preserve_rng_state=False)
    out = dict(env)
    out.update(zip(out_names, outs))
    return out


def _detached(v):
    return v.detach() if isinstance(v, torch.Tensor) else v
