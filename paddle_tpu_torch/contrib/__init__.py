"""Contributed modules (counterpart of paddle_tpu/contrib): `mixed_precision`,
float16 training with dynamic loss scaling.  The JAX package's `slim`
(quantization) and `rnn_impl` (BasicGRUUnit, BasicLSTMUnit) are not ported
yet: they wait for ROADMAP A9.3 and A9.4."""
from . import mixed_precision  # noqa: F401
