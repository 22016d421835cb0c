"""The `fluid.backward` module surface (counterpart of paddle_tpu/backward.py):
`append_backward`, `calc_gradient` and `gradients`."""
from .core.autodiff import append_backward, calc_gradient  # noqa: F401


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """`calc_gradient` under the name the reference's backward module gives it."""
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
