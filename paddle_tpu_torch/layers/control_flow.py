"""Control-flow layers (counterpart of paddle_tpu/layers/control_flow.py):
`While` with its block guard, `increment`, `less_than`, `equal`,
`greater_than`, `cond` and the tensor-array layers `create_array`,
`array_write`, `array_read` and `array_length`.  The `while` op's
sub-block runs as a Python loop (core/lowering.py run_while), a
`conditional_block`'s once when its predicate holds
(run_conditional_block)."""
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


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op("create_array", outputs={"Out": [array.name]})
    inputs = {"X": [x.name], "I": [i.name], "Array": [array.name]}
    helper.append_op("array_write", inputs=inputs, outputs={"Out": [array.name]})
    return array


def create_array(dtype="float32"):
    helper = LayerHelper("create_array")
    array = helper.create_variable_for_type_inference(dtype)
    helper.append_op("create_array", outputs={"Out": [array.name]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(
        "array_read", inputs={"X": [array.name], "I": [i.name]}, outputs={"Out": [out.name]}
    )
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int32", shape=(1,))
    helper.append_op("array_length", inputs={"X": [array.name]}, outputs={"Out": [out.name]})
    return out


def cond(pred, true_fn, false_fn=None):
    """Two-branch conditional: each branch builds a sub-block run by a
    `conditional_block` op (the false one on the negated predicate); the
    branches' outputs merge by `select_input` on the predicate.  The
    executor reads the predicate on the host, so such a plan runs
    eagerly."""
    main = default_main_program()
    helper = LayerHelper("cond")

    parent = main.current_block()
    tb = main.create_block()
    t_out = true_fn()
    main.rollback()
    t_idx = tb.idx
    parent.append_op(
        "conditional_block",
        inputs={"Cond": [pred.name]},
        outputs={},
        attrs={"sub_block": t_idx},
    )
    if false_fn is None:
        return t_out
    fb = main.create_block()
    f_out = false_fn()
    main.rollback()
    # invert predicate
    not_pred = helper.create_variable_for_type_inference("bool", shape=pred.shape)
    helper.append_op("logical_not", inputs={"X": [pred.name]}, outputs={"Out": [not_pred.name]})
    parent.append_op(
        "conditional_block",
        inputs={"Cond": [not_pred.name]},
        outputs={},
        attrs={"sub_block": fb.idx},
    )
    if t_out is None or f_out is None:
        return t_out
    single = not isinstance(t_out, (list, tuple))
    t_list = [t_out] if single else list(t_out)
    f_list = [f_out] if single else list(f_out)
    outs = []
    for tv, fv in zip(t_list, f_list):
        sel = helper.create_variable_for_type_inference(tv.dtype, shape=tv.shape)
        mask = helper.create_variable_for_type_inference("int32", shape=(1,))
        helper.append_op("cast", inputs={"X": [pred.name]}, outputs={"Out": [mask.name]},
                         attrs={"out_dtype": "int32"})
        helper.append_op(
            "select_input",
            inputs={"X": [fv.name, tv.name], "Mask": [mask.name]},
            outputs={"Out": [sel.name]},
        )
        outs.append(sel)
    return outs[0] if single else outs
