"""Optimizers (counterpart of paddle_tpu/optimizer.py).

`minimize()` = append_backward (one `backward` op) + one update op per
parameter.  The learning rate is a persistable [1] variable and the
accumulators are persistable variables, each initialized by a
`fill_constant` in the startup program, with the same names, ops and attrs
as the JAX package.  Between the backward and the updates come the
program's gradient clip and the regularizers' decay ops (clip.py,
core/regularizer.py), on the dense gradients only.  The port has `SGD`,
`Momentum`, `Adam` and `Adagrad` so far; the other optimizers and the
dygraph (eager) updates come with later slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .core import unique_name
from .core.autodiff import append_backward
from .core.dtypes import canonical_dtype
from .core.program import Parameter, Variable, default_main_program, default_startup_program
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

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
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


SGD = SGDOptimizer
Adam = AdamOptimizer
Adagrad = AdagradOptimizer
Momentum = MomentumOptimizer
