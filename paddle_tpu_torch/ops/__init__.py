"""Op lowerings; importing this package registers them."""
from . import (control_flow_ops, detection_ops, math_ops, misc_ops, nn_ops,  # noqa: F401
               optimizer_ops, sequence_ops, tail_ops, tensor_ops)
