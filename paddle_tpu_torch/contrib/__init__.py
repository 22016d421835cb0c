"""Contributed modules (counterpart of paddle_tpu/contrib): `mixed_precision`,
float16 training with dynamic loss scaling, and `slim`: quantization (QAT,
post-training, the int8 freeze), pruning and distillation.  The JAX
package's `rnn_impl` (BasicGRUUnit, BasicLSTMUnit) is not ported yet: it
waits for ROADMAP A9.4."""
from . import mixed_precision  # noqa: F401
from . import slim  # noqa: F401
