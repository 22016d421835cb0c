"""Weight-decay regularizers (counterpart of paddle_tpu/core/regularizer.py).

The port has no lowering yet for the ops a regularizer appends, so these
classes only carry their settings: Optimizer.apply_gradients refuses a
parameter that has one and names `first_op`, the first op the JAX package
would append for it.
"""
from __future__ import annotations


class Regularizer:
    first_op = ""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff


class L2DecayRegularizer(Regularizer):
    first_op = "scale"


class L1DecayRegularizer(Regularizer):
    first_op = "sign"


L2Decay = L2DecayRegularizer
L1Decay = L1DecayRegularizer
