"""Dygraph gradient clipping (counterpart of paddle_tpu/dygraph_grad_clip.py;
reference python/paddle/fluid/dygraph_grad_clip.py): callables over
(param, grad) pairs, applied before the eager optimizer update."""
from __future__ import annotations

import torch


class GradClipBase:
    def __call__(self, params_grads):
        return [(p, self._clip(p, g)) if g is not None else (p, g)
                for p, g in params_grads]


class GradClipByValue(GradClipBase):
    """clip each grad element into [min, max]."""

    def __init__(self, min_value, max_value=None):
        if max_value is None:
            max_value = abs(min_value)
            min_value = -max_value
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def _clip(self, p, g):
        return torch.clamp(g, self.min_value, self.max_value)


class GradClipByNorm(GradClipBase):
    """scale each grad so its own l2 norm is <= clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, p, g):
        n = torch.sqrt(torch.sum(torch.square(g)))
        return g * (self.clip_norm / torch.clamp_min(n, self.clip_norm))


class GradClipByGlobalNorm(GradClipBase):
    """scale ALL grads by clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, max_global_norm):
        self.max_global_norm = float(max_global_norm)

    def __call__(self, params_grads):
        gs = [g for _, g in params_grads if g is not None]
        if not gs:
            return params_grads
        global_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in gs))
        scale = self.max_global_norm / torch.clamp_min(global_norm, self.max_global_norm)
        return [(p, g * scale if g is not None else g) for p, g in params_grads]
