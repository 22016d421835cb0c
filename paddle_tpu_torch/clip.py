"""Gradient clipping (counterpart of paddle_tpu/clip.py):
GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
set_gradient_clip and ErrorClipByValue.

`set_gradient_clip` records a strategy on the program; Optimizer.
apply_gradients appends its ops between the backward and the updates, on
the dense gradients only, with the same ops, attrs and vars as the JAX
package."""
from __future__ import annotations

from .core.program import default_main_program
from .layers import nn, tensor


class BaseGradientClipAttr:
    def _append_clip_op(self, params_grads):
        raise NotImplementedError


class ErrorClipByValue:
    """Kept for the API: the reference clips activation gradients with it;
    gradients from autograd leave only the parameter-gradient clips."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClipAttr):
    """Each gradient clipped elementwise to [min, max]."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _append_clip_op(self, params_grads):
        return [(p, nn.clip(g, self.min, self.max)) for p, g in params_grads]


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled down to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append_clip_op(self, params_grads):
        return [(p, nn.clip_by_norm(g, self.clip_norm)) for p, g in params_grads]


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient scaled by clip_norm / max(global_norm, clip_norm), the
    global norm taken over all of them."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append_clip_op(self, params_grads):
        sq_sums = [nn.reduce_sum(nn.square(g)) for _, g in params_grads]
        total = tensor.sums(sq_sums) if len(sq_sums) > 1 else sq_sums[0]
        global_norm = nn.sqrt(total)
        max_norm = tensor.fill_constant([1], "float32", self.clip_norm)
        denom = nn.elementwise_max(global_norm, max_norm)
        scale = nn.elementwise_div(max_norm, denom)
        return [(p, nn.elementwise_mul(g, scale)) for p, g in params_grads]


def set_gradient_clip(clip, param_list=None, program=None):
    """Record the clip strategy on the program, for the parameters of
    `param_list` (names or Parameters) or for all when it is None;
    Optimizer.apply_gradients applies it."""
    program = program or default_main_program()
    program._grad_clip = clip
    program._grad_clip_params = (
        {p if isinstance(p, str) else p.name for p in param_list} if param_list else None)


def append_gradient_clip_ops(params_grads):
    program = default_main_program()
    clip = getattr(program, "_grad_clip", None)
    if clip is None:
        return params_grads
    only = getattr(program, "_grad_clip_params", None)
    if only is None:
        return clip._append_clip_op(params_grads)
    subset = [(p, g) for p, g in params_grads if p.name in only]
    rest = [(p, g) for p, g in params_grads if p.name not in only]
    return clip._append_clip_op(subset) + rest
