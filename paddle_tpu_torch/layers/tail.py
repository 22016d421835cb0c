"""Layers of the JAX package's layers/tail.py whose ops the port has:
`uniform_random`, `gaussian_random` and `sign`."""
from __future__ import annotations

from ..core.layer_helper import LayerHelper
from . import nn as _nn
from .nn import _out

sign = _nn._act_layer("sign")


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = _out(helper, dtype, shape=tuple(shape))
    helper.append_op("uniform_random", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype, "min": min, "max": max,
                            "seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = _out(helper, dtype, shape=tuple(shape))
    helper.append_op("gaussian_random", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype, "mean": mean, "std": std,
                            "seed": seed})
    return out
