"""Eager op interpreter (counterpart of paddle_tpu/core/lowering.py).

Where the JAX package traces a block once into one XLA computation, the
port runs each op's torch lowering in order on real tensors.  A `backward`
op (core/autodiff.py) splits the op list: the forward segment before it
runs with its parameters as leaves that require grad, and
`torch.autograd.grad` takes the place of `jax.vjp`.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .program import Operator
from .registry import get_op_def


class LoweringContext:
    """Per-run state the lowerings read.

    `generator` draws every random op without a seed attr (the counterpart of
    the JAX package's threaded PRNG key); `device` is where new tensors go;
    `fetch_names` and `read_names` let a lowering skip an output slot that
    nothing reads (eager torch has no dead-code elimination)."""

    def __init__(self, generator: torch.Generator, device: torch.device, is_test: bool = False,
                 fetch_names: Sequence[str] = (), read_names=frozenset()):
        self.generator = generator
        self.device = device
        self.is_test = is_test
        self.fetch_names = tuple(fetch_names)
        self.read_names = frozenset(read_names)

    def wants(self, op: Operator, slot: str) -> bool:
        """True when an output of `op` in `slot` is read by an op of the run or fetched."""
        return any(n in self.read_names or n in self.fetch_names for n in op.outputs.get(slot, ()))


# ops the executor handles itself
_STRUCTURAL_OPS = ("feed", "fetch", "backward")


def run_ops(ctx: LoweringContext, ops: List[Operator], env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Run `ops` over `env` (var name -> tensor), in order."""
    for op in ops:
        if op.type in _STRUCTURAL_OPS:
            raise RuntimeError(f"structural op {op.type!r} reached the interpreter; "
                               "the executor must handle it")
        lower_one(ctx, op, env)
    return env


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
    re-run from the block-start env with the generator's state restored, so
    every region sees the same dropout masks (the JAX package pins `key0`);
    grads of earlier regions enter later regions as constants.  One region
    runs its forward once.  The ops after the last `backward` (the optimizer
    updates) run without autograd, after every grad is taken, so an in-place
    update never touches a tensor a backward still needs."""
    splits = [i for i, op in enumerate(ops) if op.type == "backward"]
    if not splits:
        with torch.no_grad():
            return run_ops(ctx, ops, env)
    state0 = ctx.generator.get_state()
    start_env = dict(env)
    grads_so_far: Dict[str, torch.Tensor] = {}
    for si in splits:
        ctx.generator.set_state(state0)
        env = _run_one_backward_region(ctx, ops, si, start_env, grads_so_far)
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
    if sparse:
        raise NotImplementedError(
            f"backward: {sparse} are read only by is_sparse lookup_table ops and take "
            "SelectedRows gradients, which are not ported yet (ROADMAP A5); build the "
            "embeddings with is_sparse=False")
    fwd_ops = [o for o in ops[:split] if o.type != "backward"]

    env = dict(start_env)
    env.update(grads_so_far)
    for p in param_names:
        if p not in env:
            raise KeyError(f"backward: parameter {p!r} not initialized (run the startup program)")
    # parameters enter as leaves sharing the scope's storage; a name that is
    # not a float tensor (an int feed, say) gets a zero gradient
    leaves = {}
    for p in param_names:
        if env[p].is_floating_point():
            leaves[p] = env[p].detach().requires_grad_(True)
            env[p] = leaves[p]
    with torch.enable_grad():
        run_ops(ctx, fwd_ops, env)
        loss = env[loss_name]
        got = [None] * len(leaves)
        if leaves and loss.requires_grad:  # else no parameter reaches the loss: zero grads
            got = torch.autograd.grad(loss, list(leaves.values()), torch.ones_like(loss),
                                      allow_unused=True)
    by_param = dict(zip(leaves, got))
    # downstream ops read the scope's tensors and values without history
    out = {n: (start_env[n] if n in leaves else v.detach()) for n, v in env.items()}
    for p, g in zip(param_names, grad_names):
        gval = by_param.get(p)
        if gval is None:
            gval = torch.zeros_like(start_env[p])
        out[g] = gval
        grads_so_far[g] = gval
    return out
