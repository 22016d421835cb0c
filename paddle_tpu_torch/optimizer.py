"""Optimizers (counterpart of paddle_tpu/optimizer.py).

`minimize()` = append_backward (one `backward` op) + one update op per
parameter.  The learning rate is a persistable [1] variable and the
accumulators are persistable variables, each initialized by a
`fill_constant` in the startup program, with the same names, ops and attrs
as the JAX package.  Between the backward and the updates come the
program's gradient clip and the regularizers' decay ops (clip.py,
core/regularizer.py), on the dense gradients only.  The port has every
optimizer of the JAX package but `PipelineOptimizer` (which needs the
`pipeline` op and a mesh, ROADMAP A10): `SGD`, `Momentum`, `Adam`,
`Adagrad`, `RMSProp`, `Adamax`, `Adadelta`, `Ftrl`, `Lamb`,
`LarsMomentum`, `DecayedAdagrad`, `DGCMomentum` and `Dpsgd`, and the
parameter averages `ExponentialMovingAverage` and `ModelAverage`.

Inside a `dygraph.guard()`, `minimize` updates each parameter eagerly from
its `.grad` (`_dygraph_minimize`): nine classes have an eager rule
(`_eager_update`), the JAX package's expressions in its order, with the
learning rate a Python float (a `LearningRateDecay` is called once a
`minimize`).  `Lamb` and `DGCMomentum` inherit Adam's and Momentum's rule,
`Ftrl`, `Dpsgd` and `ModelAverage` raise, and no regularizer is applied:
all as in the JAX package.

The averages' `apply()` swaps the averaged values into the parameters and
back by copying into the tensors the scope holds: a plan replayed as a CUDA
graph keeps reading the tensors it was captured with, so rebinding a scope
entry would leave the graph on the old values.
"""
from __future__ import annotations

import contextlib

# Tuple and Program are names of this module in the JAX package's API.spec
from typing import Dict, List, Optional, Tuple  # noqa: F401

import torch

from .core import unique_name
from .core.autodiff import append_backward
from .core.dtypes import canonical_dtype
from .core.program import (Parameter, Program, Variable,  # noqa: F401
                           default_main_program, default_startup_program)
from .core.regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._lr_var: Optional[Variable] = None
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    # --- learning rate ---------------------------------------------------
    def _create_global_learning_rate(self):
        if self._lr_var is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        name = unique_name.generate("learning_rate")
        main_block = default_main_program().global_block()
        self._lr_var = main_block.create_var(name, shape=(1,), dtype="float32", persistable=True)
        startup = default_startup_program().global_block()
        startup.create_var(name, shape=(1,), dtype="float32", persistable=True)
        startup.append_op(
            "fill_constant",
            outputs={"Out": [name]},
            attrs={"shape": [1], "dtype": "float32", "value": float(self._learning_rate)},
        )

    # --- accumulators ----------------------------------------------------
    def _add_accumulator(self, name: str, param: Parameter, fill_value: float = 0.0,
                         shape=None, dtype=None):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        var_name = f"{param.name}_{name}_0"
        shape = list(shape if shape is not None else param.shape)
        dtype = canonical_dtype(dtype or param.dtype)
        main_block = default_main_program().global_block()
        v = main_block.create_var(var_name, shape=shape, dtype=dtype, persistable=True)
        startup = default_startup_program().global_block()
        startup.create_var(var_name, shape=shape, dtype=dtype, persistable=True)
        startup.append_op(
            "fill_constant",
            outputs={"Out": [var_name]},
            attrs={"shape": shape, "dtype": dtype, "value": float(fill_value)},
        )
        self._accumulators.setdefault(name, {})[param.name] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def get_opti_var_name_list(self):
        """The names of the accumulator variables this optimizer created."""
        return [v.name for by_param in self._accumulators.values() for v in by_param.values()]

    def load(self, stat_dict):
        """Put accumulator values, by name, into the global scope."""
        from .core.scope import global_scope

        for by_param in self._accumulators.values():
            for var in by_param.values():
                if var.name in stat_dict:
                    global_scope().set_var(var.name, stat_dict[var.name])

    # --- hooks subclasses implement --------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # --- public API -------------------------------------------------------
    def apply_gradients(self, params_grads) -> List:
        """The program's gradient clip, then each parameter's regularizer,
        on the dense gradients; then one update op per parameter."""
        from .clip import append_gradient_clip_ops

        block = default_main_program().global_block()
        self._create_global_learning_rate()
        # SelectedRows grads (is_sparse embeddings) bypass clip and
        # regularization, whose ops rewrite a dense grad var
        sparse_set = set()
        for op in block.ops:
            if op.type == "backward":
                sparse_set.update(op.attrs.get("sparse_param_names", []))
        sparse_pg = [(p, g) for p, g in params_grads if p.name in sparse_set]
        dense_pg = [(p, g) for p, g in params_grads if p.name not in sparse_set]
        dense_pg = append_gradient_clip_ops(dense_pg)
        dense_pg = append_regularization_ops(dense_pg, self.regularization)
        params_grads = dense_pg + sparse_pg
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = []
        for pg in params_grads:
            ops.append(self._append_optimize_op(block, pg))
        return ops

    def backward(self, loss, startup_program=None, parameter_list=None, no_grad_set=None,
                 callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_optimize(self, loss, startup_program, params_grads):
        """The apply_gradients half of minimize (the clip and decay included)."""
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        from .dygraph import base as _dy

        if _dy.enabled():
            return self._dygraph_minimize(loss, parameter_list)
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    # --- dygraph (eager) path --------------------------------------------
    def _dygraph_minimize(self, loss, parameter_list):
        """Apply the update rule eagerly from each parameter's .grad, which
        the caller's loss.backward() set."""
        if parameter_list is None:
            raise ValueError("dygraph minimize() needs parameter_list")
        if not hasattr(self, "_eager_state"):
            self._eager_state: Dict[int, dict] = {}
        lr = self._learning_rate() if callable(self._learning_rate) else self._learning_rate
        updated = []
        with torch.no_grad():
            for p in parameter_list:
                if p.grad is None or p.stop_gradient:
                    continue
                st = self._eager_state.setdefault(id(p), {})
                p.value = self._eager_update(p.value, p.grad, float(lr), st)
                updated.append(p)
        return [], [(p, p.grad) for p in updated]

    def _eager_update(self, p, g, lr, state):
        raise NotImplementedError(
            f"{type(self).__name__} has no eager (dygraph) update rule yet"
        )


class SGDOptimizer(Optimizer):
    def _eager_update(self, p, g, lr, state):
        return p - lr * g

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [p.name], "Grad": [g.name], "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name]},
        )


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _eager_update(self, p, g, lr, state):
        v = state.get("velocity")
        v = torch.zeros_like(p) if v is None else v
        v_new = self._momentum * v + g
        if self._use_nesterov:
            p_new = p - lr * (g + self._momentum * v_new)
        else:
            p_new = p - lr * v_new
        state["velocity"] = v_new
        return p_new

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode

    def _eager_update(self, p, g, lr, state):
        m1 = state.get("m1")
        m1 = torch.zeros_like(p) if m1 is None else m1
        m2 = state.get("m2")
        m2 = torch.zeros_like(p) if m2 is None else m2
        b1p = state.get("b1p", 1.0) * self._beta1
        b2p = state.get("b2p", 1.0) * self._beta2
        m1 = self._beta1 * m1 + (1 - self._beta1) * g
        m2 = self._beta2 * m2 + (1 - self._beta2) * torch.square(g)
        lr_t = lr * (1 - b2p) ** 0.5 / (1 - b1p)
        state.update(m1=m1, m2=m2, b1p=b1p, b2p=b2p)
        return p - lr_t * m1 / (torch.sqrt(m2) + self._epsilon)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            # beta powers stay float32 whatever the param dtype: bf16 cannot
            # represent 0.999 (it rounds to 1.0 and zeroes the step size)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1],
                                  dtype="float32")
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2, shape=[1],
                                  dtype="float32")

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            "adam",
            inputs={
                "Param": [p.name],
                "Grad": [g.name],
                "Moment1": [m1.name],
                "Moment2": [m2.name],
                "Beta1Pow": [b1p.name],
                "Beta2Pow": [b2p.name],
                "LearningRate": [self._lr_var.name],
            },
            outputs={
                "ParamOut": [p.name],
                "Moment1Out": [m1.name],
                "Moment2Out": [m2.name],
                "Beta1PowOut": [b1p.name],
                "Beta2PowOut": [b2p.name],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon,
                   "lazy_mode": self._lazy_mode},
        )


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _eager_update(self, p, g, lr, state):
        m = state.get("moment")
        m = torch.full_like(p, self._initial) if m is None else m
        m = m + torch.square(g)
        state["moment"] = m
        return p - lr * g / (torch.sqrt(m) + self._epsilon)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"epsilon": self._epsilon},
        )



class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum, self._centered = rho, epsilon, momentum, centered

    def _eager_update(self, p, g, lr, state):
        if not state:
            state.update(ms=torch.zeros_like(p), mg=torch.zeros_like(p),
                         mom=torch.zeros_like(p))
        ms, mg, mom = state["ms"], state["mg"], state["mom"]
        ms = self._rho * ms + (1 - self._rho) * torch.square(g)
        if self._centered:
            mg = self._rho * mg + (1 - self._rho) * g
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * mom + lr * g / denom
        state.update(ms=ms, mg=mg, mom=mom)
        return p - mom

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)
            self._add_accumulator("momentum", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        mom = self._get_accumulator("momentum", p)
        return block.append_op(
            "rmsprop",
            inputs={"Param": [p.name], "Grad": [g.name], "MeanSquare": [ms.name],
                    "MeanGrad": [mg.name], "Moment": [mom.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MeanSquareOut": [ms.name],
                     "MeanGradOut": [mg.name], "MomentOut": [mom.name]},
            attrs={"decay": self._rho, "epsilon": self._epsilon, "momentum": self._momentum,
                   "centered": self._centered},
        )


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _eager_update(self, p, g, lr, state):
        if not state:
            state.update(m=torch.zeros_like(p), inf=torch.zeros_like(p), b1p=1.0)
        m, inf = state["m"], state["inf"]
        b1p = state["b1p"] * self._beta1
        m = self._beta1 * m + (1 - self._beta1) * g
        inf = torch.maximum(self._beta2 * inf, torch.abs(g))
        state.update(m=m, inf=inf, b1p=b1p)
        return p - (lr / (1 - b1p)) * m / (inf + self._epsilon)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1],
                                  dtype="float32")

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        op = block.append_op(
            "adamax",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "InfNorm": [inf.name], "Beta1Pow": [b1p.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name], "InfNormOut": [inf.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )
        # the beta1 power advances by a scale op after the update
        block.append_op("scale", inputs={"X": [b1p.name]}, outputs={"Out": [b1p.name]},
                        attrs={"scale": self._beta1})
        return op


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _eager_update(self, p, g, lr, state):
        if not state:
            state.update(g2=torch.zeros_like(p), u2=torch.zeros_like(p))
        g2, u2 = state["g2"], state["u2"]
        g2 = self._rho * g2 + (1 - self._rho) * torch.square(g)
        upd = -torch.sqrt((u2 + self._epsilon) / (g2 + self._epsilon)) * g
        u2 = self._rho * u2 + (1 - self._rho) * torch.square(upd)
        state.update(g2=g2, u2=u2)
        return p + upd

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": [p.name], "Grad": [g.name], "AvgSquaredGrad": [asg.name],
                    "AvgSquaredUpdate": [asu.name], "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "AvgSquaredGradOut": [asg.name],
                     "AvgSquaredUpdateOut": [asu.name]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": [p.name], "Grad": [g.name], "SquaredAccumulator": [sq.name],
                    "LinearAccumulator": [lin.name], "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "SquaredAccumOut": [sq.name],
                     "LinearAccumOut": [lin.name]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class LambOptimizer(AdamOptimizer):
    """LAMB (You et al. 2019): Adam's accumulators and one `lamb` op a
    parameter, whose trust ratio needs the parameter's and the step's
    norms; no Adam kernel runs."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            "lamb",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment1": [m1.name],
                    "Moment2": [m2.name], "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name], "Moment2Out": [m2.name],
                     "Beta1PowOut": [b1p.name], "Beta2PowOut": [b2p.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon,
                   "weight_decay": self._weight_decay},
        )


class LarsMomentumOptimizer(MomentumOptimizer):
    """Layer-adaptive rate scaling (You, Gitman and Ginsburg 2017) over
    Momentum's velocity: one `lars_momentum` op a parameter."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001, lars_weight_decay=0.0005,
                 **kw):
        super().__init__(learning_rate, momentum, **kw)
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _eager_update(self, p, g, lr, state):
        wd = self._lars_weight_decay
        p_norm = torch.sqrt(torch.sum(torch.square(p)))
        g_norm = torch.sqrt(torch.sum(torch.square(g)))
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * p_norm / (g_norm + wd * p_norm),
            lr,
        )
        v = state.get("velocity")
        v = torch.zeros_like(p) if v is None else v
        v_new = self._momentum * v + local_lr * (g + wd * p)
        state["velocity"] = v_new
        return p - v_new

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
        )


class DecayedAdagradOptimizer(Optimizer):
    """Adagrad whose squared-gradient moment decays exponentially."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay = decay
        self._epsilon = epsilon

    def _eager_update(self, p, g, lr, state):
        m = state.get("moment")
        m = torch.zeros_like(p) if m is None else m
        m = self._decay * m + (1.0 - self._decay) * g * g
        state["moment"] = m
        return p - lr * g / (torch.sqrt(m) + self._epsilon)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep Gradient Compression momentum: before the momentum update of
    each float32 parameter of at least 16384 elements (a dense gradient),
    a `dgc` op keeps the top (1 - sparsity) of the error-feedback buffer,
    with momentum correction and factor masking, the sparsity ramping over
    rampup_step steps from rampup_begin_step.  One process: the gradient
    is the whole batch's, so the op keeps the sparsified-update dynamics
    and exchanges nothing."""

    _DGC_MIN_NUMEL = 16384

    def __init__(self, learning_rate, momentum, rampup_begin_step, rampup_step=1,
                 sparsity=(0.999,), use_nesterov=False, local_grad_clip_norm=None,
                 num_trainers=None, regularization=None, name=None):
        super().__init__(learning_rate, momentum, use_nesterov, regularization=regularization,
                         name=name)
        self._rampup_begin_step = float(rampup_begin_step)
        self._rampup_step = float(rampup_step)
        self._sparsity = [float(s) for s in sparsity]
        self._clip_norm = 0.0
        if local_grad_clip_norm is not None:
            if not isinstance(num_trainers, int) or num_trainers <= 0:
                raise ValueError("DGCMomentumOptimizer: local_grad_clip_norm "
                                 "needs a positive int num_trainers")
            self._clip_norm = float(local_grad_clip_norm) / (num_trainers * num_trainers)
        self._counter_var = None

    def _dgc_eligible(self, param, grad):
        numel = 1
        for d in param.shape:
            numel *= int(d)
        return (numel >= self._DGC_MIN_NUMEL and str(param.dtype) in ("float32", "fp32")
                and getattr(grad, "type", None) != "selected_rows")

    def _ensure_counter(self, block):
        """A persistable step counter, -1 after startup and advanced by one
        at the top of each run's updates, so the first run reads step 0."""
        if self._counter_var is not None:
            return self._counter_var
        name = unique_name.generate("dgc_counter")
        self._counter_var = block.create_var(name, shape=(1,), dtype="float32", persistable=True)
        startup = default_startup_program().global_block()
        startup.create_var(name, shape=(1,), dtype="float32", persistable=True)
        startup.append_op("fill_constant", outputs={"Out": [name]},
                          attrs={"shape": [1], "dtype": "float32", "value": -1.0})
        block.append_op("increment", inputs={"X": [name]}, outputs={"Out": [name]},
                        attrs={"step": 1.0})
        return self._counter_var

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        if self._dgc_eligible(p, g):
            counter = self._ensure_counter(block)
            u = self._add_accumulator("dgc_u", p)
            v = self._add_accumulator("dgc_v", p)
            g_out = block.create_var(unique_name.generate(f"{g.name}@DGC"), shape=g.shape,
                                     dtype=g.dtype)
            block.append_op(
                "dgc",
                inputs={"Grad": [g.name], "U": [u.name], "V": [v.name],
                        "CurrentStep": [counter.name]},
                outputs={"GradOut": [g_out.name], "UOut": [u.name], "VOut": [v.name]},
                attrs={"m": self._momentum, "rampup_begin_step": self._rampup_begin_step,
                       "rampup_step": self._rampup_step, "sparsity": self._sparsity,
                       "clip_norm": self._clip_norm},
            )
            g = g_out
        return super()._append_optimize_op(block, (p, g))


class DpsgdOptimizer(Optimizer):
    """Differentially private SGD: one `dpsgd` op a parameter (clip the
    gradient's L2 norm, add Gaussian noise from the run's generator, step)."""

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0, **kw):
        super().__init__(learning_rate, **kw)
        self._clip, self._sigma, self._batch_size = clip, sigma, batch_size

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "dpsgd",
            inputs={"Param": [p.name], "Grad": [g.name], "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name]},
            attrs={"clip": self._clip, "sigma": self._sigma, "batch_size": self._batch_size},
        )


def _swap_in(scope, values):
    """Copy each name's new value into the tensor the scope holds (a
    captured CUDA graph keeps reading that tensor); returns clones of the
    old values.  A value still on the host (never run) is rebound."""
    import torch

    saved = {}
    for name, new in values.items():
        cur = scope.find_var(name)
        if isinstance(cur, torch.Tensor):
            saved[name] = cur.detach().clone()
            with torch.no_grad():
                cur.copy_(new.to(cur.device, cur.dtype))
        else:
            saved[name] = cur
            scope.set_var(name, new)
    return saved


def _swap_back(scope, saved):
    import torch

    for name, old in saved.items():
        cur = scope.find_var(name)
        if isinstance(cur, torch.Tensor) and isinstance(old, torch.Tensor):
            with torch.no_grad():
                cur.copy_(old)
        else:
            scope.set_var(name, old)


def _scalar(scope, name):
    import numpy as np

    from .core.dtypes import to_numpy

    return float(np.asarray(to_numpy(scope.find_var(name))).reshape(-1)[0])


def _as_tensor(v):
    import torch

    from .core.dtypes import to_tensor

    return v if isinstance(v, torch.Tensor) else to_tensor(v)


class ExponentialMovingAverage:
    """EMA shadow parameters: `update()` appends shadow := decay*shadow +
    (1-decay)*param ops to the main program (run every step);
    `apply(executor, scope)` is a context that swaps the bias-corrected
    shadows into the parameters and copies the parameters back on exit."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._pairs = []  # (param Variable, shadow name)
        self._step_var = None

    def update(self):
        from .layers import tensor as tensor_layers

        program = default_main_program()
        block = program.global_block()
        self._step_var = tensor_layers.create_global_var(
            [1], 0, "float32", persistable=True, name=f"{self._name}_step")
        block.append_op("increment", inputs={"X": [self._step_var.name]},
                        outputs={"Out": [self._step_var.name]}, attrs={"step": 1.0})
        sblock = default_startup_program().global_block()
        for p in program.all_parameters():
            if not p.trainable:
                continue
            shadow_name = f"{self._name}@{p.name}"
            sblock.create_var(shadow_name, shape=p.shape, dtype=p.dtype, persistable=True)
            block.create_var(shadow_name, shape=p.shape, dtype=p.dtype, persistable=True)
            sblock.append_op(
                "fill_constant", outputs={"Out": [shadow_name]},
                attrs={"shape": list(p.shape or []), "dtype": str(p.dtype), "value": 0.0})
            scaled_s = block.create_var(shape=p.shape, dtype=p.dtype)
            block.append_op("scale", inputs={"X": [shadow_name]}, outputs={"Out": [scaled_s.name]},
                            attrs={"scale": self._decay})
            scaled_p = block.create_var(shape=p.shape, dtype=p.dtype)
            block.append_op("scale", inputs={"X": [p.name]}, outputs={"Out": [scaled_p.name]},
                            attrs={"scale": 1.0 - self._decay})
            block.append_op("sum", inputs={"X": [scaled_s.name, scaled_p.name]},
                            outputs={"Out": [shadow_name]})
            self._pairs.append((p, shadow_name))

    def apply(self, executor=None, scope=None, need_restore=True):
        """Context manager: the bias-corrected shadows in, the parameters back
        on exit (bit for bit) unless need_restore is False."""
        from .core.scope import global_scope

        scope = scope or global_scope()
        ema = self

        @contextlib.contextmanager
        def guard():
            corr = 1.0 - ema._decay ** max(_scalar(scope, ema._step_var.name), 1.0)
            saved = _swap_in(scope, {p.name: _as_tensor(scope.find_var(shadow)) / corr
                                     for p, shadow in ema._pairs})
            try:
                yield
            finally:
                if need_restore:
                    _swap_back(scope, saved)

        return guard()

    def restore(self, executor=None):
        pass  # the apply() context restores


class ModelAverage(Optimizer):
    """Bounded-window parameter averaging: one sum and one count, the sum
    halved when the count reaches max_average_window (an effective window
    of up to twice that).  `update()` appends the accumulation ops;
    `apply()` swaps the window average in, and back on exit."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, name=None):
        super().__init__(0.0, name=name)
        self._max_window = max_average_window
        self._name = name or "model_avg"
        self._pairs = []
        self._count_var = None

    def update(self):
        from .layers import tensor as tensor_layers

        program = default_main_program()
        block = program.global_block()
        self._count_var = tensor_layers.create_global_var(
            [1], 0, "float32", persistable=True, name=f"{self._name}_n")
        sblock = default_startup_program().global_block()
        for p in program.all_parameters():
            if not p.trainable:
                continue
            acc = f"{self._name}@{p.name}"
            block.create_var(acc, shape=p.shape, dtype=p.dtype, persistable=True)
            sblock.create_var(acc, shape=p.shape, dtype=p.dtype, persistable=True)
            sblock.append_op(
                "fill_constant", outputs={"Out": [acc]},
                attrs={"shape": list(p.shape or []), "dtype": str(p.dtype), "value": 0.0})
            block.append_op(
                "model_average_accum",
                inputs={"Sum": [acc], "Count": [self._count_var.name], "Param": [p.name]},
                outputs={"SumOut": [acc]}, attrs={"max_average_window": self._max_window})
            self._pairs.append((p, acc))
        block.append_op("model_average_count", inputs={"Count": [self._count_var.name]},
                        outputs={"CountOut": [self._count_var.name]},
                        attrs={"max_average_window": self._max_window})

    def apply(self, executor=None, scope=None, need_restore=True):
        from .core.scope import global_scope

        scope = scope or global_scope()
        avg = self

        @contextlib.contextmanager
        def guard():
            n = max(_scalar(scope, avg._count_var.name), 1.0)
            saved = _swap_in(scope, {p.name: _as_tensor(scope.find_var(acc)) / n
                                     for p, acc in avg._pairs})
            try:
                yield
            finally:
                if need_restore:
                    _swap_back(scope, saved)

        return guard()

    def restore(self, executor=None):
        pass


SGD = SGDOptimizer
Adam = AdamOptimizer
Adagrad = AdagradOptimizer
Momentum = MomentumOptimizer
RMSProp = RMSPropOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
Dpsgd = DpsgdOptimizer
LarsMomentum = LarsMomentumOptimizer
DGCMomentum = DGCMomentumOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
