"""Executor: eager runs of whole programs (counterpart of paddle_tpu/core/executor.py).

`run()` prunes the global block to what the fetches and the persistable
writes need, runs the ops' torch lowerings in order, writes persistable
outputs back to the Scope (startup state, and the parameters and
accumulators an optimizer op updates) and returns the fetches.  A program
without a `backward` op runs under `torch.no_grad()`; one with `backward`
ops runs its regions through `torch.autograd.grad`
(core/lowering.py run_block_with_backward).  Nothing runs under
`torch.inference_mode()`: its tensors could never be trained, and the
Scope keeps them across runs.  The generator in the Scope advances across
runs.  A fetched SelectedRows gradient (an `is_sparse` table's) comes back
as its dense view, or as the SelectedRows itself with return_numpy=False.
A ragged feed (a `LoDTensor`) becomes its padded carrier and lengths
(paddle_tpu_torch/lod.py); a `while` op's sub-block counts for pruning
and write-back as the op's own reads and writes.
There is no compile cache, no `run_async` and no `steps > 1` yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import flags
from ..lod import LoDTensor, lod_var_name
from .dtypes import to_numpy, to_tensor
from .lowering import LoweringContext, run_block_with_backward
from .program import Program, Variable, default_main_program
from .scope import RNG_STATE_VAR, Scope, global_scope
from .selected_rows import SelectedRows


class Place:
    device: torch.device


class CUDAPlace(Place):
    """A CUDA device, `torch.device(f"cuda:{device_id}")`.  Raises when the
    machine has no such card: nothing falls back to the CPU quietly."""

    def __init__(self, device_id: int = 0):
        if not torch.cuda.is_available():
            raise RuntimeError(f"CUDAPlace({device_id}): no CUDA device is available; "
                               "pass CPUPlace() to run on the CPU")
        if not 0 <= device_id < torch.cuda.device_count():
            raise RuntimeError(f"CUDAPlace({device_id}): only {torch.cuda.device_count()} "
                               "CUDA device(s)")
        self.device_id = device_id
        self.device = torch.device(f"cuda:{device_id}")

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


# scripts written for the JAX package name TPUPlace; here it is the card
TPUPlace = CUDAPlace


class CPUPlace(Place):
    def __init__(self):
        self.device_id = 0
        self.device = torch.device("cpu")

    def __repr__(self):
        return "CPUPlace()"


def _runnable_ops(block):
    return [op for op in block.ops if op.type not in ("feed", "fetch")]


def _effective_io(op):
    """(reads, writes) of `op`, a `while` op's sub-block included."""
    reads = list(op.input_arg_names)
    writes = list(op.output_arg_names)
    if op.type == "while":
        for sop in op.block.program.blocks[op.attr("sub_block")].ops:
            r, w = _effective_io(sop)
            reads.extend(r)
            writes.extend(w)
    return reads, writes


def _prune(ops, fetch_names, persistable):
    """Fetch-driven dead-op elimination: keep an op if it (transitively)
    feeds a fetch or writes a persistable var, counting a `while` op's
    sub-block.  A kept `backward` op needs its loss and its parameters."""
    needed = set(fetch_names)
    kept = []
    for op in reversed(ops):
        reads, outs = _effective_io(op)
        if any(o in persistable or o in needed for o in outs):
            kept.append(op)
            needed.update(reads)
            if op.type == "backward":
                needed.add(op.attrs["loss_name"])
                needed.update(op.attrs.get("param_names", []))
    kept.reverse()
    return kept


def _read_names(ops):
    """Every name the ops read, a `while` op's sub-block and a `backward`
    op's parameters included."""
    names = set()
    for op in ops:
        names.update(_effective_io(op)[0])
        if op.type == "backward":
            names.update(op.attrs.get("param_names", []))
    return names


def _expand_ragged_feeds(block, feed):
    """A `LoDTensor`, or a list of per-sequence arrays fed to a var declared
    with lod_level >= 1, becomes the padded carrier (time axis bucketed,
    lod.bucket_length) and the int32 lengths `<name>@LOD`."""
    out = {}
    for name, value in feed.items():
        declared_ragged = block.has_var(name) and block.var(name).lod_level >= 1
        if isinstance(value, LoDTensor) or (
                declared_ragged and isinstance(value, (list, tuple)) and len(value) > 0
                and all(isinstance(s, np.ndarray) for s in value)):
            lt = value if isinstance(value, LoDTensor) else LoDTensor(value)
            out[name], out[lod_var_name(name)] = lt.padded(bucket=True)
        else:
            out[name] = value
    return out


class Executor:
    """`Executor(place).run(program, feed, fetch_list, scope, return_numpy)`."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, object]] = None,
        fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ) -> List[object]:
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        feed = feed or {}
        fetch_names = [f.name if isinstance(f, Variable) else str(f) for f in (fetch_list or [])]
        device = self.place.device
        block = program.global_block()

        persistable = {v.name for v in program.list_vars() if v.persistable}
        ops = _prune(_runnable_ops(block), fetch_names, persistable)
        read_names = _read_names(ops)

        env: Dict[str, torch.Tensor] = {}
        for name in sorted((read_names | set(fetch_names)) & persistable):
            v = scope.find_var(name)
            if v is None:
                continue  # written by this run (startup) or reported missing by the op
            if not isinstance(v, torch.Tensor) or v.device != device:
                v = to_tensor(v, None, device)  # host arrays, other devices
                scope.set_var(name, v)
            env[name] = v
        for name, value in _expand_ragged_feeds(block, feed).items():
            dtype = block.var(name).dtype if block.has_var(name) else None
            env[name] = to_tensor(value, dtype, device)

        gen = scope.find_var(RNG_STATE_VAR)
        if gen is None or gen.device != device:
            gen = torch.Generator(device=device)
            gen.manual_seed(program.random_seed if program.random_seed is not None else 0)
            scope.set_var(RNG_STATE_VAR, gen)

        ctx = LoweringContext(gen, device, fetch_names=fetch_names, read_names=read_names)
        env = run_block_with_backward(ctx, ops, env)
        for op in ops:
            for n in _effective_io(op)[1]:
                if n in persistable and n in env:
                    scope.set_var(n, env[n])

        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not produced by the program")
        fetches = [env[n] if isinstance(env[n], SelectedRows) else env[n].detach()
                   for n in fetch_names]
        if flags.flag("FLAGS_check_nan_inf"):
            for name, t in zip(fetch_names, fetches):
                t = t.values if isinstance(t, SelectedRows) else t
                if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    raise FloatingPointError(f"FLAGS_check_nan_inf: fetch {name!r} contains NaN/Inf")
        if return_numpy:
            # a SelectedRows gradient comes back as its dense view
            return [t.numpy() if isinstance(t, SelectedRows) else to_numpy(t) for t in fetches]
        return fetches
