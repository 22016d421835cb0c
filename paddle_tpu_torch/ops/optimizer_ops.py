"""Optimizer update lowerings (counterpart of paddle_tpu/ops/optimizer_ops.py):
`adam` and `momentum` so far.

Each update writes its `<Slot>Out` outputs in the dtype of `<Slot>`, as the
JAX package's register_opt does.  The bias-corrected step size and the
beta-pow advance stay tensor math on the parameter's device: nothing waits
on the host between the optimizer ops of a step."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import first
from .cuda_kernels import fused_adam


def _lr(ins):
    return first(ins, "LearningRate").reshape(())


def _dense_grad(op, g):
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(
            f"{op.type}: grad of {op.input('Param')[0]!r} is {type(g).__name__}; SelectedRows "
            "(sparse) gradients are not ported yet (ROADMAP A5)")
    return g


@register_op("momentum")
def _momentum(ctx, op, ins):
    """Dense momentum, plain torch (the JAX package has no kernel for it):
    v' = mu*v + g, then p' = p - lr*v', or p - lr*(g + mu*v') with
    use_nesterov.  New tensors, each in its slot's dtype."""
    p = first(ins, "Param")
    g = _dense_grad(op, first(ins, "Grad"))
    v = first(ins, "Velocity")
    mu = op.attr("mu", 0.9)
    lr = _lr(ins)
    v_new = mu * v + g
    step = g + mu * v_new if op.attr("use_nesterov", False) else v_new
    return {"ParamOut": (p - lr * step).to(p.dtype), "VelocityOut": v_new.to(v.dtype)}


@register_op("adam")
def _adam(ctx, op, ins):
    """Dense Adam through ops/cuda_kernels.py fused_adam: the kernel updates
    Param, Moment1 and Moment2 in place on the card (their outputs name the
    same vars); the CPU takes the plain version."""
    p = first(ins, "Param")
    g = _dense_grad(op, first(ins, "Grad"))
    m1 = first(ins, "Moment1")
    m2 = first(ins, "Moment2")
    b1p = first(ins, "Beta1Pow").reshape(())
    b2p = first(ins, "Beta2Pow").reshape(())
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    lr_t = _lr(ins) * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    p_new, m1n, m2n = fused_adam(p, g.contiguous(), m1, m2, lr_t, beta1, beta2,
                                 op.attr("epsilon", 1e-8))
    return {
        "ParamOut": p_new,
        "Moment1Out": m1n,
        "Moment2Out": m2n,
        "Beta1PowOut": (b1p * beta1).reshape(1).to(first(ins, "Beta1Pow").dtype),
        "Beta2PowOut": (b2p * beta2).reshape(1).to(first(ins, "Beta2Pow").dtype),
    }
