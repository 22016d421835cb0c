"""Op lowerings; importing this package registers them."""
from . import math_ops, misc_ops, nn_ops, optimizer_ops, sequence_ops, tensor_ops  # noqa: F401
