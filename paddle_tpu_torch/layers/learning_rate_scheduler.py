"""Learning-rate schedules (counterpart of
paddle_tpu/layers/learning_rate_scheduler.py): a persistable float32 step
counter, advanced by one `increment` op each run of the main program, and
the schedule's ops over it: noam, exponential, natural_exp, inverse_time,
polynomial (with `cycle`), piecewise and cosine decay, and
`linear_lr_warmup` over a float or a schedule.  Each is arithmetic over the
counter (piecewise and the warmup select by 0/1 masks, not by conditional
blocks), so a schedule reads nothing on the host and stays inside a
captured CUDA graph."""
from __future__ import annotations

import math

from ..core.layer_helper import LayerHelper
from ..core.program import Variable, default_main_program, default_startup_program
from . import nn, tensor

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _global_step():
    """The persistable counter; startup sets it to -1, so the first run's
    schedule sees step 0."""
    main_block = default_main_program().global_block()
    if main_block.has_var(_COUNTER_NAME):
        return main_block.var(_COUNTER_NAME)
    var = main_block.create_var(_COUNTER_NAME, shape=(1,), dtype="float32", persistable=True)
    startup = default_startup_program().global_block()
    startup.create_var(_COUNTER_NAME, shape=(1,), dtype="float32", persistable=True)
    startup.append_op("fill_constant", outputs={"Out": [_COUNTER_NAME]},
                      attrs={"shape": [1], "dtype": "float32", "value": -1.0})
    main_block.append_op("increment", inputs={"X": [_COUNTER_NAME]},
                         outputs={"Out": [_COUNTER_NAME]}, attrs={"step": 1.0})
    return var


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """learning_rate * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5): at
    step 0, min(+inf, 0) = 0."""
    step = _global_step()
    a = nn.pow(step, -0.5)
    b = step * (warmup_steps ** -1.5)
    return nn.elementwise_min(a, b) * (d_model ** -0.5) * learning_rate


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """learning_rate * decay_rate ^ (step / decay_steps), as exp(div * ln rate)."""
    div = _div(decay_steps, staircase)
    return nn.exp(div * math.log(decay_rate)) * learning_rate


def _div(decay_steps, staircase):
    div = _global_step() / float(decay_steps)
    return nn.floor(div) if staircase else div


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    return nn.exp(_div(decay_steps, staircase) * (-decay_rate)) * learning_rate


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    denom = _div(decay_steps, staircase) * decay_rate + 1.0
    return nn.reciprocal(denom) * learning_rate


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0,
                     cycle=False):
    """(lr - end) * (1 - step / decay_steps)^power + end, the step capped at
    decay_steps; with `cycle` the horizon is decay_steps * max(ceil(step /
    decay_steps), 1)."""
    step = _global_step()
    if cycle:
        ceil_ratio = nn.ceil(step / float(decay_steps))
        one = tensor.fill_constant([1], "float32", 1.0)
        frac = step / (nn.elementwise_max(ceil_ratio, one) * float(decay_steps))
    else:
        capped = nn.elementwise_min(step, tensor.fill_constant([1], "float32", float(decay_steps)))
        frac = capped / float(decay_steps)
    return nn.pow(1.0 - frac, power) * (learning_rate - end_learning_rate) + end_learning_rate


def _compare(op_type, x, y):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference("bool", shape=x.shape)
    helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]}, outputs={"Out": [out.name]})
    return out


def piecewise_decay(boundaries, values):
    """values[i] for boundaries[i-1] <= step < boundaries[i], by masks."""
    assert len(values) == len(boundaries) + 1
    step = _global_step()
    lr = tensor.fill_constant([1], "float32", values[-1])
    prev_bound = None
    for i, b in enumerate(boundaries):
        bound = tensor.fill_constant([1], "float32", float(b))
        mask = tensor.cast(_compare("less_than", step, bound), "float32")
        if prev_bound is not None:
            above = tensor.cast(_compare("greater_equal", step, prev_bound), "float32")
            mask = nn.elementwise_mul(mask, above)
        lr = lr + mask * (values[i] - values[-1])
        prev_bound = bound
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """learning_rate * (cos(epoch * pi / epochs) + 1) / 2, epoch = floor(step / step_each_epoch)."""
    epoch = nn.floor(_global_step() / float(step_each_epoch))
    return (nn.cos(epoch * (math.pi / float(epochs))) + 1.0) * 0.5 * learning_rate


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr + (end_lr - start_lr) * step / warmup_steps below warmup_steps,
    then `learning_rate` (a float or a schedule Variable)."""
    step = _global_step()
    wsteps = tensor.fill_constant([1], "float32", float(warmup_steps))
    in_warmup = tensor.cast(_compare("less_than", step, wsteps), "float32")
    warm = (step / float(warmup_steps)) * (end_lr - start_lr) + start_lr
    after = (learning_rate if isinstance(learning_rate, Variable)
             else tensor.fill_constant([1], "float32", float(learning_rate)))
    return in_warmup * warm + (1.0 - in_warmup) * after
