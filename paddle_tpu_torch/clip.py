"""Gradient clipping (counterpart of paddle_tpu/clip.py).

`set_gradient_clip` records a clip strategy on the program, as in the JAX
package.  The port has no lowering yet for the ops a clip appends, so
Optimizer.apply_gradients refuses a program that has one and names
`first_op`, the first op the JAX package would append for it.
"""
from __future__ import annotations

from .core.program import default_main_program


class BaseGradientClipAttr:
    first_op = ""


class GradientClipByValue(BaseGradientClipAttr):
    first_op = "clip"

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max


class GradientClipByNorm(BaseGradientClipAttr):
    first_op = "clip_by_norm"

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    first_op = "square"

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


def set_gradient_clip(clip, param_list=None, program=None):
    """Record the clip strategy on the program.  Optimizer.apply_gradients
    refuses any clip until its ops are ported, whatever `param_list` names."""
    program = program or default_main_program()
    program._grad_clip = clip
