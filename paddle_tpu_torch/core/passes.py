"""Program-rewrite passes (counterpart of paddle_tpu/core/passes.py): the
fusions whose ops reach the port's kernels, `fuse_bn_relu`,
`fuse_ln_residual` and `fuse_bias_act`, and the program-level rewrites
`remove_identity_ops`, `fold_scale_chains` and `prune_dead_ops`, with the
pass registry and `PassBuilder`.  A pass is a callable Program -> None that
mutates the program in place; under FLAGS_verify_program every applied
pass is followed by the program verifier (core/analysis.py), so a pass
that breaks the program raises `PassVerificationError` naming it."""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence

_PASS_REGISTRY: Dict[str, Callable] = {}


def register_pass(name: str):
    def deco(fn):
        _PASS_REGISTRY[name] = fn
        return fn

    return deco


def registered_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


def _verify_after(program, pass_name: str):
    """Under FLAGS_verify_program, verify the program after a rewrite, so a
    pass bug surfaces as a diagnostic naming the op and var instead of wrong
    numerics when the program runs."""
    from ..flags import flag

    level = flag("FLAGS_verify_program")
    if level in ("", "off"):
        return
    from .analysis import SEV_ERROR, PassVerificationError, verify_program

    errors = [d for d in verify_program(program, level=level) if d.severity == SEV_ERROR]
    if errors:
        raise PassVerificationError(pass_name, errors)


def apply_pass(program, name: str, **kw):
    if name not in _PASS_REGISTRY:
        raise KeyError(f"unknown pass {name!r}; known: {registered_passes()}")
    _PASS_REGISTRY[name](program, **kw)
    program._bump()  # the rewritten ops need a new plan
    _verify_after(program, name)
    return program


class PassBuilder:
    """An ordered pass pipeline, applied in the order the passes were
    appended, each followed by the verifier (`_verify_after`)."""

    def __init__(self, passes: Optional[Sequence[str]] = None):
        self._passes: List[str] = list(passes or [])

    def append_pass(self, name: str) -> "PassBuilder":
        if name not in _PASS_REGISTRY:
            raise KeyError(f"unknown pass {name!r}")
        self._passes.append(name)
        return self

    def remove_pass(self, name: str) -> "PassBuilder":
        self._passes.remove(name)
        return self

    def all_passes(self) -> List[str]:
        return list(self._passes)

    def apply(self, program):
        for p in self._passes:
            apply_pass(program, p)
        return program


def _rewire(block, old: str, new: str, start: int):
    """Replace reads of `old` with `new` in ops from index `start` on."""
    for op in block.ops[start:]:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [new if n == old else n for n in names]


@register_pass("remove_identity_ops")
def remove_identity_ops(program, keep=()):
    """Drop `assign` and no-op `scale` (scale=1, bias=0) ops, rewiring
    same-block consumers to the producer.

    `keep`: names that must stay written (fetch targets).  Identities whose
    output is kept, persistable, or read from another block (control-flow
    sub-blocks) stay, as does an identity whose input or output some later
    op writes (t = x; x += 1; use t is a real copy)."""
    keep = set(keep)
    for block, outside in zip(program.blocks, _outside_reads(program)):
        last_write: Dict[str, int] = {}
        for i, op in enumerate(block.ops):
            for out_name in op.output_arg_names:
                last_write[out_name] = i
        kept = []
        for i, op in enumerate(block.ops):
            is_identity = op.type == "assign" or (
                op.type == "scale" and op.attrs.get("scale", 1.0) == 1.0
                and op.attrs.get("bias", 0.0) == 0.0)
            if not is_identity:
                kept.append(op)
                continue
            src = op.input_arg_names[0]
            dst = op.output_arg_names[0]
            dst_var = block._find_var_recursive(dst)
            if dst in keep or dst in outside or (dst_var is not None and dst_var.persistable):
                kept.append(op)
                continue
            if last_write.get(src, -1) > i or last_write.get(dst, -1) > i:
                kept.append(op)
                continue
            _rewire(block, dst, src, i + 1)
        block.ops = kept


@register_pass("fold_scale_chains")
def fold_scale_chains(program):
    """Fold consecutive scale ops (y = a2*(a1*x + b1) + b2) into one.  The
    bypassed op stays in the program (other consumers or a fetch may read
    it); the executor's prune drops it when it is dead."""
    for block in program.blocks:
        by_output = {}
        for op in block.ops:
            if op.type == "scale" and op.attrs.get("bias_after_scale", True):
                src = op.input_arg_names[0]
                prev = by_output.get(src)
                if prev is not None and prev.attrs.get("bias_after_scale", True):
                    a1 = prev.attrs.get("scale", 1.0)
                    b1 = prev.attrs.get("bias", 0.0)
                    a2 = op.attrs.get("scale", 1.0)
                    b2 = op.attrs.get("bias", 0.0)
                    op.inputs["X"] = [prev.input_arg_names[0]]
                    op.attrs["scale"] = a1 * a2
                    op.attrs["bias"] = a2 * b1 + b2
                by_output[op.output_arg_names[0]] = op
            # any write drops the cached chains that read or wrote the name
            # (an in-place op like increment would otherwise be folded across)
            for out in op.output_arg_names:
                if op.type != "scale" or out != op.output_arg_names[0]:
                    by_output.pop(out, None)
                stale = [k for k, v in by_output.items()
                         if v.input_arg_names[0] == out and v is not op]
                for k in stale:
                    by_output.pop(k)


def _reader_counts(block):
    """name -> number of ops in `block` reading it."""
    counts: Dict[str, int] = {}
    for op in block.ops:
        for n in op.input_arg_names:
            counts[n] = counts.get(n, 0) + 1
    return counts


def _rw_positions(block):
    """(writes, reads): name -> ascending op indices writing / reading it."""
    writes: Dict[str, list] = {}
    reads: Dict[str, list] = {}
    for i, op in enumerate(block.ops):
        for n in op.input_arg_names:
            reads.setdefault(n, []).append(i)
        for n in op.output_arg_names:
            writes.setdefault(n, []).append(i)
    return writes, reads


def _accessed_between(positions, name, lo, hi):
    """True if `name` appears in `positions` at an op index strictly between lo and hi."""
    idxs = positions.get(name)
    if not idxs:
        return False
    j = bisect.bisect_right(idxs, lo)
    return j < len(idxs) and idxs[j] < hi


def _outside_reads(program):
    """Per-block sets of names read by any op outside that block."""
    block_reads = []
    n_blocks_reading: Dict[str, int] = {}
    for b in program.blocks:
        reads = set()
        for op in b.ops:
            reads.update(op.input_arg_names)
        block_reads.append(reads)
        for n in reads:
            n_blocks_reading[n] = n_blocks_reading.get(n, 0) + 1
    return [{n for n, c in n_blocks_reading.items() if c > (1 if n in reads else 0)}
            for reads in block_reads]


@register_pass("fuse_bn_relu")
def fuse_bn_relu(program, keep=()):
    """Merge `batch_norm` -> `relu` pairs into batch_norm(fuse_relu=True), so
    the relu runs in the BN epilogue kernel's pass over the activation
    (ops/cuda_kernels.py bn_epilogue).

    Safe only when the BN's Y is read by exactly that relu (not fetched via
    `keep`, not read from another block, not persistable), and no op between
    the two writes Y or reads or writes the relu's Out: fusing moves the
    write of Out up to the BN."""
    keep = set(keep)
    for block, outside in zip(program.blocks, _outside_reads(program)):
        readers = _reader_counts(block)
        writes, reads = _rw_positions(block)
        by_out = {}
        for i, op in enumerate(block.ops):
            if op.type == "batch_norm" and not op.attrs.get("fuse_relu"):
                by_out[op.output("Y")[0]] = (op, i)
        kept = []
        for i, op in enumerate(block.ops):
            if op.type == "relu":
                src = op.input_arg_names[0]
                bn, bn_i = by_out.get(src, (None, -1))
                # by_out keeps the LAST batch_norm writing each Y name; it must
                # also precede this relu
                if bn is not None and bn_i >= i:
                    bn = None
                out_name = op.output("Out")[0] if bn is not None else None
                hazard = bn is not None and (
                    _accessed_between(writes, src, bn_i, i)
                    or _accessed_between(writes, out_name, bn_i, i)
                    or _accessed_between(reads, out_name, bn_i, i))
                if (bn is not None and not hazard and readers.get(src, 0) == 1
                        and src not in keep and src not in outside):
                    v = block._find_var_recursive(src)
                    if v is None or not v.persistable:
                        # the BN now writes the relu's output var
                        bn.outputs["Y"] = [op.output("Out")[0]]
                        bn.attrs["fuse_relu"] = True
                        continue
            kept.append(op)
        block.ops = kept


@register_pass("fuse_ln_residual")
def fuse_ln_residual(program, keep=()):
    """Fold `elementwise_add(X, Y)` -> `layer_norm` chains into
    layer_norm(X, Residual=Y), so the pre-norm sum never becomes its own
    tensor on the kernel path (ops/cuda_kernels.py fused_ln_residual).

    Conditions: the add's output feeds exactly the layer_norm (no other
    readers, not fetched via `keep`, not read from another block, not
    persistable), shapes match exactly (no broadcasting), default axis, and
    no op between the two writes the add's inputs or output."""
    keep = set(keep)
    for block, outside in zip(program.blocks, _outside_reads(program)):
        readers = _reader_counts(block)
        writes, _ = _rw_positions(block)
        adds = {}
        for i, op in enumerate(block.ops):
            if (op.type == "elementwise_add" and op.attrs.get("axis", -1) in (-1,)
                    and len(op.input("X")) == 1 and len(op.input("Y")) == 1):
                xv = block._find_var_recursive(op.input("X")[0])
                yv = block._find_var_recursive(op.input("Y")[0])
                if (xv is not None and yv is not None and xv.shape is not None
                        and tuple(xv.shape) == tuple(yv.shape or ())):
                    adds[op.output("Out")[0]] = (op, i)
        fused_adds = []
        for i, op in enumerate(block.ops):
            if op.type != "layer_norm" or op.inputs.get("Residual"):
                continue
            src = op.input("X")[0]
            add, add_i = adds.get(src, (None, -1))
            # the LAST add writing src must also precede this layer_norm
            if (add is None or add_i >= i or readers.get(src, 0) != 1
                    or src in keep or src in outside):
                continue
            if (_accessed_between(writes, add.input("X")[0], add_i, i)
                    or _accessed_between(writes, add.input("Y")[0], add_i, i)
                    or _accessed_between(writes, src, add_i, i)):
                continue
            v = block._find_var_recursive(src)
            if v is not None and v.persistable:
                continue
            op.inputs["X"] = [add.input("X")[0]]
            op.inputs["Residual"] = [add.input("Y")[0]]
            fused_adds.append(add)
        if fused_adds:
            dead = set(id(a) for a in fused_adds)
            block.ops = [o for o in block.ops if id(o) not in dead]


@register_pass("fuse_bias_act")
def fuse_bias_act(program, keep=()):
    """Merge `elementwise_add` -> `relu`/`gelu` pairs into
    elementwise_add(fuse_act=<act>), so the bias-act epilogue kernel
    (ops/cuda_kernels.py fused_bias_act) applies both in one pass.

    Safe only when the add's Out is read by exactly that activation, is not
    fetched (`keep`) or read from another block, and no op between the two
    reads or writes the moved values."""
    keep = set(keep)
    for block, outside in zip(program.blocks, _outside_reads(program)):
        readers = _reader_counts(block)
        writes, reads = _rw_positions(block)
        by_out = {}
        for i, op in enumerate(block.ops):
            if (op.type == "elementwise_add" and not op.attrs.get("fuse_act")
                    and len(op.input("X")) == 1 and len(op.input("Y")) == 1):
                by_out[op.output("Out")[0]] = (op, i)
        kept = []
        for i, op in enumerate(block.ops):
            if op.type in ("relu", "gelu"):
                src = op.input_arg_names[0]
                add, add_i = by_out.get(src, (None, -1))
                if add is not None and add_i >= i:
                    add = None
                out_name = op.output("Out")[0] if add is not None else None
                hazard = add is not None and (
                    _accessed_between(writes, src, add_i, i)
                    or _accessed_between(writes, out_name, add_i, i)
                    or _accessed_between(reads, out_name, add_i, i))
                if (add is not None and not hazard and readers.get(src, 0) == 1
                        and src not in keep and src not in outside):
                    v = block._find_var_recursive(src)
                    if v is None or not v.persistable:
                        # the add now writes the activation's output var
                        add.outputs["Out"] = [op.output("Out")[0]]
                        add.attrs["fuse_act"] = op.type
                        continue
            kept.append(op)
        block.ops = kept


@register_pass("prune_dead_ops")
def prune_dead_ops(program, targets: Optional[Sequence[str]] = None):
    """Fetch-driven dead-op elimination of the global block, as the
    executor prunes each plan.  `targets` is required: guessing the live
    outputs would delete independent branches."""
    from .executor import _prune, _runnable_ops

    if not targets:
        raise ValueError("prune_dead_ops: pass the fetch targets explicitly "
                         "(apply_pass(prog, 'prune_dead_ops', targets=[...]))")
    persistable = {v.name for v in program.list_vars() if v.persistable}
    block = program.global_block()
    block.ops = _prune(_runnable_ops(block), list(targets), persistable)
