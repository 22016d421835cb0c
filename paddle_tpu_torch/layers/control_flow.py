"""Control-flow layers (counterpart of paddle_tpu/layers/control_flow.py):
`While` with its block guard, `increment`, `less_than`, `equal` and
`greater_than`.  The `while`
op's sub-block runs as a Python loop (core/lowering.py run_while)."""
from __future__ import annotations

from ..core.layer_helper import LayerHelper
from ..core.program import Variable, default_main_program


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("increment", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"step": float(value)})
    return out


def less_than(x, y, cond=None):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", shape=(1,))
    helper.append_op("less_than", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]})
    return cond


def equal(x, y, cond=None):
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", shape=(1,))
    helper.append_op("equal", inputs={"X": [x.name], "Y": [y.name]}, outputs={"Out": [cond.name]})
    return cond


def greater_than(x, y, cond=None):
    helper = LayerHelper("greater_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", shape=(1,))
    helper.append_op("greater_than", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]})
    return cond


class While:
    """    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        ...body ops...
        layers.increment(i)
        layers.less_than(i, n, cond=cond)
    """

    def __init__(self, cond: Variable, is_test: bool = False, name: str = None):
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)

    def block(self):
        return _WhileBlockGuard(self)


class _WhileBlockGuard:
    def __init__(self, while_op: While):
        self.w = while_op
        self.main = default_main_program()

    def __enter__(self):
        self.parent_block = self.main.current_block()
        self.sub_block = self.main.create_block()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.main.rollback()
        if exc_type is not None:
            return False
        # the op's X: names the body reads before writing them, defined outside
        defined = set()
        reads = []
        for op in self.sub_block.ops:
            reads.extend(n for n in op.input_arg_names if n not in defined)
            defined.update(op.output_arg_names)
        x_names = sorted({n for n in reads if self.parent_block.has_var(n)})
        self.parent_block.append_op(
            "while", inputs={"X": x_names, "Condition": [self.w.cond_var.name]}, outputs={},
            attrs={"sub_block": self.sub_block.idx})
        return False
