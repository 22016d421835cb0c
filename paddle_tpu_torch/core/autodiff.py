"""append_backward / calc_gradient (counterpart of paddle_tpu/core/autodiff.py).

There are no grad ops.  `append_backward` records ONE `backward` op naming
(loss, params, grad vars); the executor differentiates the forward segment
before it with `torch.autograd.grad` (core/lowering.py
run_block_with_backward).  After append_backward, `<param>@GRAD` variables
exist and optimizer ops read them.  The ops and attrs are the JAX package's,
`sparse_param_names` included, so the program dicts of both packages agree.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .program import Variable

GRAD_SUFFIX = "@GRAD"


def _grad_name(name: str) -> str:
    return name + GRAD_SUFFIX


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[set] = None,
    callbacks=None,
) -> List[Tuple[Variable, Variable]]:
    block = loss.block
    program = block.program
    no_grad = set()
    for item in no_grad_set or ():
        no_grad.add(item.name if isinstance(item, Variable) else str(item))

    if parameter_list is not None:
        params = []
        for p in parameter_list:
            params.append(block.var(p) if isinstance(p, str) else p)
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    params = [p for p in params if p.name not in no_grad]
    if not params:
        raise ValueError("append_backward: no trainable parameters found")

    param_names = [p.name for p in params]
    grad_names = [_grad_name(n) for n in param_names]
    grads = []
    for p, gname in zip(params, grad_names):
        grads.append(block.create_var(gname, shape=p.shape, dtype=p.dtype))

    block.append_op(
        "backward",
        inputs={"Loss": [loss.name]},
        outputs={"Grads": grad_names},
        attrs={
            "loss_name": loss.name,
            "param_names": param_names,
            "grad_names": grad_names,
            "sparse_param_names": _find_sparse_params(block, param_names),
        },
    )
    return list(zip(params, grads))


def _find_sparse_params(block, param_names) -> List[str]:
    """Params eligible for SelectedRows gradients: every read of the param is
    an is_sparse lookup_table (any other consumer needs the dense gradient)."""
    pset = set(param_names)
    sparse_ok: dict = {}
    program = block.program

    def scan(blk):
        for op in blk.ops:
            for slot, names in op.inputs.items():
                for n in names:
                    if n not in pset:
                        continue
                    is_sparse_lookup = (
                        op.type in ("lookup_table", "lookup_table_v2")
                        and slot == "W"
                        and bool(op.attrs.get("is_sparse", False))
                    )
                    sparse_ok[n] = sparse_ok.get(n, True) and is_sparse_lookup
            # sub-block reads count too
            sub = op.attrs.get("sub_block")
            if sub is not None and program is not None:
                scan(program.blocks[sub])

    scan(block)
    return sorted(n for n, ok in sparse_ok.items() if ok)


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of `targets` w.r.t. arbitrary `inputs`.

    Emits its own backward region; a program may hold several (for instance
    calc_gradient + optimizer.minimize) -- the executor runs each region
    over the shared op prefix with the random stream pinned."""
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    if target_gradients is not None and len(target_gradients) != len(targets):
        raise ValueError("calc_gradient: target_gradients must match targets")
    if len(targets) == 1 and target_gradients is None:
        loss = targets[0]
    else:
        # several targets / weighted cotangents: d/dx sum_i <t_i, tg_i>,
        # built with program ops so one backward region covers it
        block0 = targets[0].block
        parts = []
        for i, t in enumerate(targets):
            v = t
            tg = target_gradients[i] if target_gradients is not None else None
            if tg is not None:  # None entry = all-ones cotangent
                w = block0.create_var(shape=t.shape, dtype=t.dtype)
                block0.append_op("elementwise_mul",
                                 inputs={"X": [t.name], "Y": [tg.name]},
                                 outputs={"Out": [w.name]}, attrs={"axis": -1})
                v = w
            r = block0.create_var(shape=(1,), dtype=t.dtype)
            block0.append_op("reduce_sum", inputs={"X": [v.name]},
                             outputs={"Out": [r.name]}, attrs={"reduce_all": True})
            parts.append(r)
        if len(parts) == 1:
            loss = parts[0]
        else:
            loss = block0.create_var(shape=(1,), dtype=targets[0].dtype)
            block0.append_op("sum", inputs={"X": [p.name for p in parts]},
                             outputs={"Out": [loss.name]})
    block = loss.block
    param_names = [v.name for v in inputs]
    grad_names = [_grad_name(n) for n in param_names]
    grads = []
    for v, gname in zip(inputs, grad_names):
        grads.append(block.create_var(gname, shape=v.shape, dtype=v.dtype))
    block.append_op(
        "backward",
        inputs={"Loss": [loss.name]},
        outputs={"Grads": grad_names},
        attrs={
            "loss_name": loss.name,
            "param_names": param_names,
            "grad_names": grad_names,
        },
    )
    return grads
