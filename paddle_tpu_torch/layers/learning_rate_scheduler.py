"""Learning-rate schedules (counterpart of
paddle_tpu/layers/learning_rate_scheduler.py): a persistable float32 step
counter, advanced by one `increment` op each run of the main program, and
the schedule's ops over it.  The port has `noam_decay` so far."""
from __future__ import annotations

from ..core.program import default_main_program, default_startup_program
from . import nn

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
