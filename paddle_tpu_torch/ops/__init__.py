"""Op lowerings; importing this package registers them."""
from . import math_ops, nn_ops, optimizer_ops, tensor_ops  # noqa: F401
