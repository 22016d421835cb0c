"""Mixed-precision training with dynamic loss scaling (counterpart of
paddle_tpu/contrib/mixed_precision/decorator.py; reference
python/paddle/fluid/contrib/mixed_precision/decorator.py:26,
`OptimizerWithMixedPrecision`): scale the loss, backward through the scaled
loss, check the gradients for inf/nan, unscale them, skip the update on
overflow, and adapt the scaling factor (grow after N good steps, shrink
after M bad ones).

The program it builds is the JAX package's, var for var and op for op
(`Program.to_dict` of a decorated program is equal in both packages): one
`isfinite` per gradient, a chain of `logical_and`, a `logical_not` giving
the overflow flag, an `elementwise_div` unscaling each gradient, the flag
wired as `FoundInf` into every update op, and `update_loss_scaling`.

On the card it is float16's path (bfloat16 needs no loss scaling): the
model runs in float16 through the port's float16 kernels, the master
weights the optimizer updates are the parameters' own dtype.  The guard
costs no host round trip: `isfinite` reduces on the device, the update ops
select old against new on the device (ops/optimizer_ops.py register_opt;
the in-place Adam kernel reads the flag itself, csrc/adam.cu) and
`update_loss_scaling` is selects, so a decorated step is captured in a CUDA
graph like any other.  An overflowed step keeps every state buffer bit for
bit (the reference zeroed the gradients instead, which still decayed the
momentum and Adam accumulators)."""
from __future__ import annotations

from ... import layers
from ...core.layer_helper import LayerHelper
from ...core.program import default_main_program


class OptimizerWithMixedPrecision:
    """Wraps a regular Optimizer; same minimize() contract."""

    def __init__(self, optimizer, init_loss_scaling=2.0 ** 15,
                 use_dynamic_loss_scaling=True, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5):
        self._optimizer = optimizer
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._loss_scaling = None

    @property
    def loss_scaling(self):
        """The loss-scaling program variable (readable via fetch_list)."""
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None, no_grad_set=None,
                 callbacks=None):
        self._loss_scaling = layers.create_global_var(
            shape=[1], value=self._init_loss_scaling, dtype="float32",
            persistable=True, name="loss_scaling_0")
        self._good_steps = layers.create_global_var(
            shape=[1], value=0, dtype="int32", persistable=True, name="good_steps_0")
        self._bad_steps = layers.create_global_var(
            shape=[1], value=0, dtype="int32", persistable=True, name="bad_steps_0")

        scaled_loss = loss * self._loss_scaling
        params_grads = self._optimizer.backward(
            scaled_loss, startup_program, parameter_list, no_grad_set, callbacks)

        # finite check over every raw grad, then unscale
        helper = LayerHelper("amp_check")
        finite_flags = []
        new_pg = []
        for p, g in params_grads:
            f = helper.create_variable_for_type_inference("bool", shape=(1,))
            helper.append_op("isfinite", inputs={"X": [g.name]},
                             outputs={"Out": [f.name]})
            finite_flags.append(f)
            new_pg.append((p, g / self._loss_scaling))
        all_finite = finite_flags[0]
        for f in finite_flags[1:]:
            nxt = helper.create_variable_for_type_inference("bool", shape=(1,))
            helper.append_op("logical_and", inputs={"X": [all_finite.name], "Y": [f.name]},
                             outputs={"Out": [nxt.name]})
            all_finite = nxt
        found_inf = helper.create_variable_for_type_inference("bool", shape=(1,))
        helper.append_op("logical_not", inputs={"X": [all_finite.name]},
                         outputs={"Out": [found_inf.name]})
        self._found_inf = found_inf
        return new_pg

    def apply_gradients(self, params_grads):
        optimize_ops = self._optimizer.apply_gradients(params_grads)
        # predicate every update op on the overflow flag
        for op in optimize_ops:
            op.inputs["FoundInf"] = [self._found_inf.name]
        if self._use_dynamic:
            block = default_main_program().global_block()
            block.append_op(
                "update_loss_scaling",
                inputs={"FoundInf": [self._found_inf.name],
                        "LossScaling": [self._loss_scaling.name],
                        "GoodSteps": [self._good_steps.name],
                        "BadSteps": [self._bad_steps.name]},
                outputs={"LossScalingOut": [self._loss_scaling.name],
                         "GoodStepsOut": [self._good_steps.name],
                         "BadStepsOut": [self._bad_steps.name]},
                attrs={"incr_every_n_steps": self._incr_every_n_steps,
                       "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                       "incr_ratio": self._incr_ratio,
                       "decr_ratio": self._decr_ratio},
            )
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


def decorate(optimizer, init_loss_scaling=2.0 ** 15, incr_every_n_steps=1000,
             decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5,
             use_dynamic_loss_scaling=True):
    """Reference decorator.py:decorate — wrap an optimizer for fp16/bf16
    training with (dynamic) loss scaling."""
    return OptimizerWithMixedPrecision(
        optimizer, init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling,
        incr_every_n_steps=incr_every_n_steps,
        decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
        incr_ratio=incr_ratio, decr_ratio=decr_ratio)
