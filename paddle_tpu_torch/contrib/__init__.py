"""Contributed modules (counterpart of paddle_tpu/contrib): `mixed_precision`,
float16 training with dynamic loss scaling; `slim`: quantization (QAT,
post-training, the int8 freeze), pruning and distillation; and `rnn_impl`,
the dygraph cells `BasicLSTMUnit` and `BasicGRUUnit`."""
from . import mixed_precision  # noqa: F401
from . import rnn_impl  # noqa: F401
from . import slim  # noqa: F401
from .rnn_impl import BasicGRUUnit, BasicLSTMUnit  # noqa: F401
