"""Optimizer update lowerings (counterpart of paddle_tpu/ops/optimizer_ops.py):
`sgd`, `momentum`, `adam` and `adagrad`, each with its SelectedRows branch.

Each update writes its `<Slot>Out` outputs in the dtype of `<Slot>`, as the
JAX package's register_opt does.  The bias-corrected step size and the
beta-pow advance stay tensor math on the parameter's device: nothing waits
on the host between the optimizer ops of a step.

A SelectedRows gradient (an `is_sparse` embedding's) first sums its
repeated rows (`merged()`, in a fixed order), then only those rows of the
parameter and its accumulators are read and written: untouched rows keep
their values exactly.  Adam densifies it by default and takes the dense
update (the fused Adam kernel on the card); under `lazy_mode` it updates the
touched rows only.  An update op without a sparse branch refuses it."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from .common import first
from .cuda_kernels import fused_adam

_SPARSE_CAPABLE = {"sgd", "momentum", "adam", "adagrad"}


def register_opt(type: str):
    """register_op + the JAX package's register_opt contract: a SelectedRows
    gradient reaches only the sparse-capable updates, each `<Slot>Out` takes
    `<Slot>`'s dtype.  A wired `FoundInf` (the AMP decorator's overflow
    flag) raises: the port has no AMP ops yet, and an update that ignored it
    would apply an overflowed step."""

    def deco(fn):
        def wrapped(ctx, op, ins):
            g = first(ins, "Grad")
            if isinstance(g, SelectedRows) and type not in _SPARSE_CAPABLE:
                raise NotImplementedError(
                    f"{type}: no SelectedRows (sparse) update; use sgd/momentum/adagrad/adam "
                    "for is_sparse embeddings, or set is_sparse=False")
            if op.input("FoundInf"):
                raise NotImplementedError(
                    f"{type}: the FoundInf input (AMP's skip-on-overflow) is not ported yet; "
                    "the AMP ops that set it come with contrib/mixed_precision (ROADMAP A9)")
            outs = fn(ctx, op, ins)
            for k, v in outs.items():
                src = first(ins, k[:-3]) if k.endswith("Out") else None
                if isinstance(src, torch.Tensor) and v.dtype != src.dtype:
                    outs[k] = v.to(src.dtype)
            return outs

        register_op(type)(wrapped)
        return wrapped

    return deco


def _lr(ins):
    return first(ins, "LearningRate").reshape(())


def _rows(t, m):
    """The rows of `t` that the merged SelectedRows `m` touches."""
    return t.index_select(0, m.rows.long())


def _set_rows(t, m, values):
    """A copy of `t` with the rows of `m` replaced by `values` (unique rows:
    no write races on the card)."""
    return t.index_copy(0, m.rows.long(), values.to(t.dtype))


@register_opt("sgd")
def _sgd(ctx, op, ins):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    lr = _lr(ins)
    if isinstance(g, SelectedRows):
        m = g.merged()
        return {"ParamOut": _set_rows(p, m, _rows(p, m) - lr * m.values)}
    return {"ParamOut": p - lr * g}


@register_opt("momentum")
def _momentum(ctx, op, ins):
    """v' = mu*v + g, then p' = p - lr*v', or p - lr*(g + mu*v') with
    use_nesterov (plain torch: the JAX package has no kernel for it)."""
    p = first(ins, "Param")
    g = first(ins, "Grad")
    v = first(ins, "Velocity")
    mu = op.attr("mu", 0.9)
    lr = _lr(ins)
    nesterov = op.attr("use_nesterov", False)
    if isinstance(g, SelectedRows):
        m = g.merged()
        v_new = mu * _rows(v, m) + m.values
        step = m.values + mu * v_new if nesterov else v_new
        return {"ParamOut": _set_rows(p, m, _rows(p, m) - lr * step),
                "VelocityOut": _set_rows(v, m, v_new)}
    v_new = mu * v + g
    step = g + mu * v_new if nesterov else v_new
    return {"ParamOut": p - lr * step, "VelocityOut": v_new}


@register_opt("adam")
def _adam(ctx, op, ins):
    """Dense Adam through ops/cuda_kernels.py fused_adam: the kernel updates
    Param, Moment1 and Moment2 in place on the card (their outputs name the
    same vars); the CPU takes the plain version.  A SelectedRows gradient is
    densified first, save under lazy_mode: then the touched rows alone
    move, in plain torch, while the beta powers advance for every row."""
    p = first(ins, "Param")
    g = first(ins, "Grad")
    m1 = first(ins, "Moment1")
    m2 = first(ins, "Moment2")
    b1p = first(ins, "Beta1Pow").reshape(())
    b2p = first(ins, "Beta2Pow").reshape(())
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    lr_t = _lr(ins) * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    pows = {"Beta1PowOut": (b1p * beta1).reshape(1), "Beta2PowOut": (b2p * beta2).reshape(1)}
    if isinstance(g, SelectedRows) and op.attr("lazy_mode", False):
        m = g.merged()
        m1r = beta1 * _rows(m1, m) + (1.0 - beta1) * m.values
        m2r = beta2 * _rows(m2, m) + (1.0 - beta2) * torch.square(m.values)
        step = lr_t * m1r / (torch.sqrt(m2r) + eps)
        return {"ParamOut": _set_rows(p, m, _rows(p, m) - step),
                "Moment1Out": _set_rows(m1, m, m1r), "Moment2Out": _set_rows(m2, m, m2r), **pows}
    if isinstance(g, SelectedRows):
        g = g.to_dense()
    p_new, m1n, m2n = fused_adam(p, g.contiguous(), m1, m2, lr_t, beta1, beta2, eps)
    return {"ParamOut": p_new, "Moment1Out": m1n, "Moment2Out": m2n, **pows}


@register_opt("adagrad")
def _adagrad(ctx, op, ins):
    """m' = m + g^2, p' = p - lr*g / (sqrt(m') + epsilon)."""
    p = first(ins, "Param")
    g = first(ins, "Grad")
    moment = first(ins, "Moment")
    eps = op.attr("epsilon", 1e-6)
    lr = _lr(ins)
    if isinstance(g, SelectedRows):
        m = g.merged()
        mr = _rows(moment, m) + torch.square(m.values)
        step = lr * m.values / (torch.sqrt(mr) + eps)
        return {"ParamOut": _set_rows(p, m, _rows(p, m) - step),
                "MomentOut": _set_rows(moment, m, mr)}
    m_new = moment + torch.square(g)
    return {"ParamOut": p - lr * g / (torch.sqrt(m_new) + eps), "MomentOut": m_new}


# --- build-time shape/dtype inference (core/analysis.py): every update
# writes `<Slot>Out` mirroring `<Slot>`'s shape and dtype, and Grad must
# match Param, as the JAX package registers it

from ..core import analysis as _A

_A.register_state_update_infer("sgd", "momentum", "adam", "adagrad")
