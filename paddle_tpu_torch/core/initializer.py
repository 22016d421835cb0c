"""Initializers: append init ops to the startup program (counterpart of
paddle_tpu/core/initializer.py).  An initializer appends one op writing the
parameter into the startup block; `Executor.run(startup)` runs it and the
tensor lands in the Scope."""
from __future__ import annotations

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": float(self.value)},
        )


class UniformInitializer(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "min": self.low,
                   "max": self.high, "seed": self.seed},
        )


class NormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "mean": self.loc,
                   "std": self.scale, "seed": self.seed},
        )


def _fans(var):
    shape = var.shape
    if len(shape) < 2:
        return int(shape[0]), int(shape[0])
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = int(shape[1]) * receptive if len(shape) > 2 else int(shape[0])
    fan_out = int(shape[0]) * receptive if len(shape) > 2 else int(shape[1])
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None, seed: int = 0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / (fi + fo)))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "truncated_gaussian_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "mean": self.loc,
                   "std": self.scale, "seed": self.seed},
        )


class MSRAInitializer(Initializer):
    def __init__(self, uniform: bool = True, fan_in=None, seed: int = 0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = float(np.sqrt(6.0 / fi))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / fi))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            "assign_value",
            outputs={"Out": [var.name]},
            attrs={"values": self.value, "dtype": var.dtype, "shape": list(self.value.shape)},
        )


# the reference's short names
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
