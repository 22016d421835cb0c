"""The `while` op's registration and inference rule (counterpart of the
`while` part of paddle_tpu/ops/control_flow_ops.py).

The interpreter runs a `while` op itself, because its body is a sub-block
of the program, not inputs (core/lowering.py run_while); the registry
entry makes the verifier know the type and carries the build-time rule
that checks the `sub_block` attr."""
from __future__ import annotations

from ..core.registry import register_op


@register_op("while")
def _while(ctx, op, ins):
    raise RuntimeError("a while op reached lower_one; core/lowering.py run_ops runs it "
                       "(run_while)")


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


_A.register_rule(["while"], _infer_sub_block_op)
