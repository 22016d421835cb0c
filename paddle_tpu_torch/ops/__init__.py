"""Op lowerings; importing this package registers them."""
from . import (control_flow_ops, math_ops, misc_ops, nn_ops, optimizer_ops,  # noqa: F401
               sequence_ops, tensor_ops)
