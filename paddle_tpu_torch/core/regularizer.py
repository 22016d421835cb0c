"""Weight-decay regularizers (counterpart of paddle_tpu/core/regularizer.py).

`append_regularization_ops` is called by Optimizer.apply_gradients and
appends grad := grad + penalty ops into the main program, with the same
ops, attrs and vars as the JAX package.  A parameter's own
`ParamAttr(regularizer=)` wins over the optimizer's `regularization`.
"""
from __future__ import annotations


class Regularizer:
    def append_ops(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(Regularizer):
    """grad + coeff * param."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_ops(self, param, grad, block):
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": [param.name]}, outputs={"Out": [decay.name]},
                        attrs={"scale": self.coeff})
        out = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("sum", inputs={"X": [grad.name, decay.name]},
                        outputs={"Out": [out.name]})
        return out


class L1DecayRegularizer(Regularizer):
    """grad + coeff * sign(param)."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_ops(self, param, grad, block):
        sign = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("sign", inputs={"X": [param.name]}, outputs={"Out": [sign.name]})
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": [sign.name]}, outputs={"Out": [decay.name]},
                        attrs={"scale": self.coeff})
        out = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("sum", inputs={"X": [grad.name, decay.name]},
                        outputs={"Out": [out.name]})
        return out


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for param, grad in params_grads:
        regularizer = param.regularizer or regularization
        if regularizer is None:
            out.append((param, grad))
            continue
        out.append((param, regularizer.append_ops(param, grad, grad.block)))
    return out


L2Decay = L2DecayRegularizer
L1Decay = L1DecayRegularizer
