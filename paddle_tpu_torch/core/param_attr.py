"""ParamAttr (counterpart of paddle_tpu/core/param_attr.py)."""
from __future__ import annotations

from typing import Optional

from .initializer import Initializer


class ParamAttr:
    def __init__(
        self,
        name: Optional[str] = None,
        initializer: Optional[Initializer] = None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        gradient_clip=None,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def _to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else ParamAttr(trainable=False)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")


class WeightNormParamAttr(ParamAttr):
    """A ParamAttr that names the axis `dim` of a weight-normalized
    parameter; the layers build a plain parameter from it, as the JAX
    package's do."""

    def __init__(self, dim=None, **kw):
        super().__init__(**kw)
        self.dim = dim
