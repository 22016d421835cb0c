"""Optimizer update lowerings (counterpart of paddle_tpu/ops/optimizer_ops.py
and of `decayed_adagrad` in paddle_tpu/ops/tail_ops.py): `sgd`, `momentum`,
`adam` and `adagrad`, each with its SelectedRows branch; the dense-only
`rmsprop`, `adamax`, `adadelta`, `lamb`, `ftrl`, `lars_momentum`, `dpsgd`,
`proximal_gd`, `proximal_adagrad` and `decayed_adagrad`; ModelAverage's
`model_average_accum` / `_count`, DGCMomentum's `dgc` transform, and
contrib/mixed_precision's `update_loss_scaling`.

Each update writes its `<Slot>Out` outputs in the dtype of `<Slot>`, as the
JAX package's register_opt does.  The bias-corrected step size and the
beta-pow advance stay tensor math on the parameter's device: nothing waits
on the host between the optimizer ops of a step.

A SelectedRows gradient (an `is_sparse` embedding's) first sums its
repeated rows (`merged()`, in a fixed order), then only those rows of the
parameter and its accumulators are read and written: untouched rows keep
their values exactly.  Adam densifies it by default and takes the dense
update (the fused Adam kernel on the card); under `lazy_mode` it updates the
touched rows only.  An update op without a sparse branch refuses it.

A wired `FoundInf` (contrib/mixed_precision's overflow flag) skips the
step as the JAX package does: every `<Slot>Out` keeps `<Slot>`'s value bit
for bit, by a select on the device.  `update_loss_scaling` is the decorator's
dynamic loss-scaling state machine, all of it device selects."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from .common import first
from .cuda_kernels import fused_adam

_SPARSE_CAPABLE = {"sgd", "momentum", "adam", "adagrad"}


def _found_inf(ins):
    """The AMP decorator's overflow flag as a 0-d bool on the device, or None."""
    fi = first(ins, "FoundInf") if ins.get("FoundInf") else None
    return None if fi is None else fi.reshape(()).to(torch.bool)


def register_opt(type: str):
    """register_op + the JAX package's register_opt contract: a SelectedRows
    gradient reaches only the sparse-capable updates, each `<Slot>Out` takes
    `<Slot>`'s dtype, and with a wired `FoundInf` (the AMP decorator's
    overflow flag) each `<Slot>Out` whose `<Slot>` is an input becomes
    where(found_inf, <Slot>, new): an overflowed step leaves every state
    buffer, the beta powers included, bit for bit as it was.  An output that
    is its input tensor itself was written in place by a kernel (the dense
    Adam's), which must read the flag on the device and skip the write: a
    select there would pick between two names of the updated tensor.  The
    flag stays on the device (no host read), so the step can be captured in
    a CUDA graph."""

    def deco(fn):
        def wrapped(ctx, op, ins):
            g = first(ins, "Grad")
            if isinstance(g, SelectedRows) and type not in _SPARSE_CAPABLE:
                raise NotImplementedError(
                    f"{type}: no SelectedRows (sparse) update; use sgd/momentum/adagrad/adam "
                    "for is_sparse embeddings, or set is_sparse=False")
            outs = fn(ctx, op, ins)
            skip = _found_inf(ins)
            for k, v in outs.items():
                src = first(ins, k[:-3]) if k.endswith("Out") and ins.get(k[:-3]) else None
                if isinstance(src, torch.Tensor):
                    if v.dtype != src.dtype:
                        v = v.to(src.dtype)
                    if skip is not None and v is not src:
                        v = torch.where(skip, src, v)
                    outs[k] = v
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
    move, in plain torch, while the beta powers advance for every row.
    A wired FoundInf goes to the kernel, which writes in place; the other
    outputs take register_opt's select."""
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
    p_new, m1n, m2n = fused_adam(p, g.contiguous(), m1, m2, lr_t, beta1, beta2, eps,
                                 _found_inf(ins))
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


# --- the dense-only updates: plain torch, the JAX package's formulas.  None
# has a Pallas kernel there, so none has a hand-written one here; each is a
# handful of elementwise ops (and, for lamb / lars_momentum / dpsgd, norms
# reduced on the card), with no host read.

@register_opt("rmsprop")
def _rmsprop(ctx, op, ins):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    ms = first(ins, "MeanSquare")
    mg = first(ins, "MeanGrad")
    mom = first(ins, "Moment")
    rho = op.attr("decay", 0.95)
    eps = op.attr("epsilon", 1e-6)
    momentum = op.attr("momentum", 0.0)
    lr = _lr(ins)
    ms_new = rho * ms + (1.0 - rho) * torch.square(g)
    if op.attr("centered", False):
        mg_new = rho * mg + (1.0 - rho) * g
        denom = torch.sqrt(ms_new - torch.square(mg_new) + eps)
    else:
        mg_new = mg
        denom = torch.sqrt(ms_new + eps)
    mom_new = momentum * mom + lr * g / denom
    return {"ParamOut": p - mom_new, "MeanSquareOut": ms_new, "MeanGradOut": mg_new,
            "MomentOut": mom_new}


@register_opt("adamax")
def _adamax(ctx, op, ins):
    """The beta1 power is advanced by a separate `scale` op (optimizer.py)."""
    p = first(ins, "Param")
    g = first(ins, "Grad")
    m = first(ins, "Moment")
    inf_norm = first(ins, "InfNorm")
    b1p = first(ins, "Beta1Pow").reshape(())
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    lr = _lr(ins)
    m_new = beta1 * m + (1.0 - beta1) * g
    inf_new = torch.maximum(beta2 * inf_norm, torch.abs(g))
    lr_t = lr / (1.0 - b1p)
    return {"ParamOut": p - lr_t * m_new / (inf_new + eps), "MomentOut": m_new,
            "InfNormOut": inf_new}


@register_opt("adadelta")
def _adadelta(ctx, op, ins):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    avg_sq_grad = first(ins, "AvgSquaredGrad")
    avg_sq_upd = first(ins, "AvgSquaredUpdate")
    rho = op.attr("rho", 0.95)
    eps = op.attr("epsilon", 1e-6)
    g2 = rho * avg_sq_grad + (1.0 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_upd + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_upd + (1.0 - rho) * torch.square(update)
    return {"ParamOut": p + update, "AvgSquaredGradOut": g2, "AvgSquaredUpdateOut": u2}


def _norm(t):
    return torch.sqrt(torch.sum(torch.square(t)))


@register_opt("lamb")
def _lamb(ctx, op, ins):
    """Adam's moments with bias correction, the decoupled weight decay added
    to the step, and the step scaled by the trust ratio ||p|| / ||r|| (1
    where either norm is 0).  The norms reduce on the card: the ratio is
    a 0-d tensor, never read on the host."""
    p = first(ins, "Param")
    g = first(ins, "Grad")
    m1 = first(ins, "Moment1")
    m2 = first(ins, "Moment2")
    b1p = first(ins, "Beta1Pow").reshape(())
    b2p = first(ins, "Beta2Pow").reshape(())
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-6)
    wd = op.attr("weight_decay", 0.0)
    lr = _lr(ins)
    m1n = beta1 * m1 + (1.0 - beta1) * g
    m2n = beta2 * m2 + (1.0 - beta2) * torch.square(g)
    r = (m1n / (1.0 - b1p)) / (torch.sqrt(m2n / (1.0 - b2p)) + eps) + wd * p
    w_norm = _norm(p)
    r_norm = _norm(r)
    ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, torch.ones_like(w_norm))
    return {"ParamOut": p - lr * ratio * r, "Moment1Out": m1n, "Moment2Out": m2n,
            "Beta1PowOut": (b1p * beta1).reshape(1), "Beta2PowOut": (b2p * beta2).reshape(1)}


@register_opt("ftrl")
def _ftrl(ctx, op, ins):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    sq = first(ins, "SquaredAccumulator")
    lin = first(ins, "LinearAccumulator")
    l1 = op.attr("l1", 0.0)
    l2 = op.attr("l2", 0.0)
    lr_power = op.attr("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
    new_lin = lin + g - sigma * p
    quad = torch.pow(new_sq, -lr_power) / lr + 2.0 * l2
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    p_new = torch.where(torch.abs(new_lin) > l1, pre / quad, torch.zeros_like(p))
    return {"ParamOut": p_new, "SquaredAccumOut": new_sq, "LinearAccumOut": new_lin}


@register_op("update_loss_scaling")
def _update_loss_scaling(ctx, op, ins):
    """The dynamic loss-scaling state machine of contrib/mixed_precision
    (paddle_tpu/ops/optimizer_ops.py _update_loss_scaling): after
    incr_every_n_steps finite steps in a row the scale grows by incr_ratio,
    unless the product is not finite (then it stays); after
    decr_every_n_nan_or_inf overflow steps it shrinks by decr_ratio, never
    below 1.0.  GoodSteps and BadSteps keep their dtype and shape [1].
    Device selects only: nothing is read on the host."""
    fi = first(ins, "FoundInf").reshape(()).to(torch.bool)
    s = first(ins, "LossScaling").reshape(())
    good = first(ins, "GoodSteps").reshape(())
    bad = first(ins, "BadSteps").reshape(())
    zero = torch.zeros_like(good)
    good_new = torch.where(fi, zero, good + 1)
    bad_new = torch.where(fi, bad + 1, zero)
    do_incr = good_new >= op.attr("incr_every_n_steps", 1000)
    do_decr = bad_new >= op.attr("decr_every_n_nan_or_inf", 2)
    grown = s * op.attr("incr_ratio", 2.0)
    s_new = torch.where(do_incr & torch.isfinite(grown), grown, s)
    s_new = torch.where(do_decr, torch.clamp_min(s * op.attr("decr_ratio", 0.5), 1.0), s_new)
    good_new = torch.where(do_incr, zero, good_new)
    bad_new = torch.where(do_decr, zero, bad_new)
    return {"LossScalingOut": s_new.reshape(1), "GoodStepsOut": good_new.reshape(1),
            "BadStepsOut": bad_new.reshape(1)}


@register_opt("lars_momentum")
def _lars_momentum(ctx, op, ins):
    """Layer-adaptive rate scaling: local_lr = lr * lars_coeff * ||p|| /
    (||g|| + wd * ||p|| + epsilon) (lr where either norm is 0), then
    momentum with the weight decay folded into the gradient.  The norms
    are float32 whatever the parameter's type, as in the JAX package."""
    p = first(ins, "Param")
    g = first(ins, "Grad")
    v = first(ins, "Velocity")
    mu = op.attr("mu", 0.9)
    lars_coeff = op.attr("lars_coeff", 0.001)
    wd = op.attr("lars_weight_decay", 0.0005)
    eps = op.attr("epsilon", 0.0)
    lr = _lr(ins)
    p_norm = _norm(p.float())
    g_norm = _norm(g.float())
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * lars_coeff * p_norm / (g_norm + wd * p_norm + eps), lr)
    v_new = mu * v + local_lr * (g + wd * p)
    return {"ParamOut": p - v_new, "VelocityOut": v_new}


@register_opt("dpsgd")
def _dpsgd(ctx, op, ins):
    """Differentially private SGD: the gradient clipped to L2 norm `clip`,
    Gaussian noise of std sigma * clip added, divided by the batch size,
    then an SGD step.  The noise is drawn from the run's generator (the
    JAX package draws from its threaded key: the streams differ, the
    noise's moments agree)."""
    p = first(ins, "Param")
    g = first(ins, "Grad")
    clip = op.attr("clip", 10.0)
    sigma = op.attr("sigma", 1.0)
    batch_size = op.attr("batch_size", 16.0)
    lr = _lr(ins)
    gf = g.float()
    scale = torch.clamp(clip / torch.clamp_min(_norm(gf), 1e-12), max=1.0)
    noise = torch.randn(g.shape, generator=ctx.generator, dtype=torch.float32, device=g.device)
    upd = (gf * scale + sigma * clip * noise) / batch_size
    return {"ParamOut": p - lr * upd}


def _prox(prox, lr, l1, l2):
    return torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr * l1, 0.0) / (1.0 + lr * l2)


@register_opt("proximal_gd")
def _proximal_gd(ctx, op, ins):
    """prox = p - lr*g; p' = sign(prox) * max(|prox| - lr*l1, 0) / (1 + lr*l2)."""
    p = first(ins, "Param")
    lr = _lr(ins)
    return {"ParamOut": _prox(p - lr * first(ins, "Grad"), lr, op.attr("l1", 0.0),
                              op.attr("l2", 0.0))}


@register_opt("proximal_adagrad")
def _proximal_adagrad(ctx, op, ins):
    """moment += g^2; only the gradient step is scaled by 1/sqrt(moment):
    the l1 threshold and the (1 + lr*l2) denominator use the raw lr."""
    p = first(ins, "Param")
    g = first(ins, "Grad")
    lr = _lr(ins)
    m_new = first(ins, "Moment") + torch.square(g)
    prox = p - (lr / torch.sqrt(m_new)) * g
    return {"ParamOut": _prox(prox, lr, op.attr("l1", 0.0), op.attr("l2", 0.0)),
            "MomentOut": m_new}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx, op, ins):
    """moment = decay*moment + (1-decay)*g^2; p -= lr * g / (sqrt(moment) + eps).
    A plain registration, as in the JAX package: no dtype cast-back."""
    p = first(ins, "Param")
    g = first(ins, "Grad")
    decay = op.attr("decay", 0.95)
    m2 = decay * first(ins, "Moment") + (1.0 - decay) * g * g
    return {"ParamOut": p - _lr(ins) * g / (torch.sqrt(m2) + op.attr("epsilon", 1e-6)),
            "MomentOut": m2}


@register_op("model_average_accum")
def _model_average_accum(ctx, op, ins):
    """ModelAverage's window sum: Sum + Param, halved when the count (read
    before the step: model_average_count, appended after every accum, owns
    the increment) reaches max_average_window, so all parameters halve
    together."""
    s = first(ins, "Sum")
    cnt = first(ins, "Count").reshape(())
    s2 = s + first(ins, "Param").to(s.dtype)
    over = (cnt + 1.0) >= op.attr("max_average_window", 10000)
    return {"SumOut": torch.where(over, s2 * 0.5, s2)}


@register_op("model_average_count")
def _model_average_count(ctx, op, ins):
    c2 = first(ins, "Count").reshape(()) + 1.0
    return {"CountOut": torch.where(c2 >= op.attr("max_average_window", 10000), c2 * 0.5,
                                    c2).reshape(1)}


@register_op("dgc")
def _dgc(ctx, op, ins):
    """Deep Gradient Compression's transform (DGCMomentumOptimizer): U = m*U
    + G, V += U, keep the top-k of |V| as the gradient and clear both
    buffers there.  The step's k comes from the sparsity ramp, a tensor: the
    lowering takes the static top-k at the largest k of the ramp and masks
    ranks past the current k, so it reads nothing on the host.  Before
    rampup_begin_step the gradient passes through and the buffers keep."""
    g = first(ins, "Grad").float()
    u = first(ins, "U").float()
    v = first(ins, "V").float()
    step = first(ins, "CurrentStep").reshape(()).float()
    m = op.attr("m", 0.9)
    rampup_begin = float(op.attr("rampup_begin_step", 0.0))
    rampup_step = float(op.attr("rampup_step", 1.0))
    sparsity = list(op.attr("sparsity", [0.999]))
    clip_norm = float(op.attr("clip_norm", 0.0))
    if clip_norm > 0:
        g = g * (clip_norm / torch.clamp_min(_norm(g), clip_norm))
    numel = g.numel()
    k_list = [max(1, int(numel * (1.0 - s))) for s in sparsity]
    k_max = max(k_list)
    period = max(rampup_step / len(sparsity), 1e-9)
    idx = torch.clamp(torch.floor((step - rampup_begin) / period), 0, len(sparsity) - 1).long()
    ks = ctx.constant(("dgc_k", tuple(k_list), str(g.device)),
                      lambda: torch.tensor(k_list, dtype=torch.int64, device=g.device))
    k_cur = ks.index_select(0, idx.reshape(1)).reshape(())  # a 0-d index would read the host
    u2 = m * u + g
    v2 = v + u2
    flat = v2.reshape(-1)
    top_idx = torch.topk(torch.abs(flat), k_max, sorted=True).indices
    sel = torch.arange(k_max, device=g.device) < k_cur
    dense = torch.zeros_like(flat).index_put((top_idx,), torch.where(sel, flat[top_idx],
                                                                     torch.zeros_like(flat[top_idx])))
    cleared = torch.zeros_like(flat, dtype=torch.bool).index_put((top_idx,), sel).reshape(g.shape)
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    active = step >= rampup_begin
    return {"GradOut": torch.where(active, dense.reshape(g.shape), g),
            "UOut": torch.where(active, torch.where(cleared, zero, u2), u),
            "VOut": torch.where(active, torch.where(cleared, zero, v2), v)}


# --- build-time shape/dtype inference (core/analysis.py): every update
# writes `<Slot>Out` mirroring `<Slot>`'s shape and dtype, and Grad must
# match Param, as the JAX package registers it

from ..core import analysis as _A

_A.register_state_update_infer(
    "sgd", "momentum", "adam", "adagrad", "rmsprop", "adamax", "adadelta", "lamb", "ftrl",
    "lars_momentum", "dpsgd", "proximal_gd", "proximal_adagrad")


# Static cost rules (core/resource_plan.py, the JAX package's): optimizer
# updates are pure bandwidth — every state slot reads + writes its full size
# a step (an in-place update saves residency, not traffic).

from ..core import resource_plan as _RP

_RP.register_state_update_cost(
    "sgd", "momentum", "adam", "adagrad", "rmsprop", "adamax", "adadelta", "lamb", "ftrl",
    "lars_momentum", "dpsgd", "proximal_gd", "proximal_adagrad")
