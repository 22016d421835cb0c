"""Program IR: Program / Block / Operator / Variable (counterpart of
paddle_tpu/core/program.py).

The same IR as the JAX package, serialized the same way
(`Program.to_dict` / `from_dict`), so a program built or saved by either
package loads in the other.  Ops carry no kernels: a type, slot-named
inputs/outputs and attrs; `Block.append_op` infers their outputs' shapes
and dtypes (core/analysis.py).  The executor interprets them eagerly with
torch (core/lowering.py).
"""
from __future__ import annotations

import contextlib
import copy
import uuid
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import unique_name
from .dtypes import canonical_dtype


class Variable:
    """A named tensor slot inside a Block; shape uses -1 for the batch dim."""

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        lod_level: int = 0,
        persistable: bool = False,
        stop_gradient: bool = False,
        trainable: bool = False,
        is_data: bool = False,
        initializer=None,
        regularizer=None,
        error_clip=None,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.trainable = trainable
        self.is_data = is_data
        self.initializer = initializer
        self.regularizer = regularizer
        self.error_clip = error_clip

    @property
    def program(self) -> "Program":
        return self.block.program

    def astype(self, dtype):
        """A cast of this variable to `dtype` (layers.cast)."""
        from ..layers import tensor as tensor_layers

        return tensor_layers.cast(self, dtype)

    # Python operator sugar, as the JAX package's Variable has it
    def _binary(self, other, op):
        from ..layers import math_sugar

        return math_sugar.binary(self, other, op)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        from ..layers import math_sugar

        return math_sugar.binary(other, self, "elementwise_sub")

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, dtype={self.dtype}, "
                f"persistable={self.persistable})")

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "trainable": self.trainable,
            "is_data": self.is_data,
        }


class Parameter(Variable):
    """A trainable persistable Variable."""

    def __init__(self, block, name, **kw):
        kw.setdefault("persistable", True)
        kw.setdefault("trainable", True)
        super().__init__(block, name, **kw)
        self.optimize_attr = kw.get("optimize_attr", {"learning_rate": 1.0})


class Operator:
    """One op descriptor: type, {slot: [var names]} inputs/outputs, JSON attrs."""

    def __init__(self, block: "Block", type: str, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return f"Operator({self.type}, in={self.inputs}, out={self.outputs})"

    def to_dict(self) -> dict:
        return {"type": self.type, "inputs": self.inputs, "outputs": self.outputs,
                "attrs": _jsonify_attrs(self.attrs)}


def _jsonify_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _dejsonify_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


class Block:
    """An ordered list of ops plus a var table."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        return None if self.parent_idx < 0 else self.program.blocks[self.parent_idx]

    def create_var(self, name: Optional[str] = None, **kw) -> Variable:
        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kw)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name: str, shape, dtype, **kw) -> Parameter:
        p = Parameter(self, name, shape=shape, dtype=dtype, **kw)
        self.vars[name] = p
        self.program._bump()
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        """Append an op and run its build-time shape/dtype inference
        (registry.infer_and_check), which fills or checks its outputs'
        declared shapes and dtypes."""
        from .registry import infer_and_check  # late import: registry needs Block

        op = Operator(self, type, _normalize_io(inputs), _normalize_io(outputs), attrs)
        self.ops.append(op)
        infer_and_check(op, self)
        self.program._bump()
        return op

    def to_dict(self) -> dict:
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": [v.to_dict() for v in self.vars.values()],
                "ops": [op.to_dict() for op in self.ops]}


def _normalize_io(io) -> Dict[str, List[str]]:
    """Accept {slot: Variable|name|list-of-either} and normalize to names."""
    if io is None:
        return {}
    out: Dict[str, List[str]] = {}
    for slot, v in io.items():
        if v is None:
            continue
        if not isinstance(v, (list, tuple)):
            v = [v]
        names = []
        for item in v:
            if isinstance(item, Variable):
                names.append(item.name)
            elif isinstance(item, str):
                names.append(item)
            else:
                raise TypeError(f"bad io entry for slot {slot!r}: {item!r}")
        out[slot] = names
    return out


class Program:
    """A list of Blocks; block 0 is global."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        # stable identity for the executor's plan-cache keys (an id() can be
        # reused after gc; clone() gets a fresh one)
        self._uuid = uuid.uuid4().hex
        self.current_block_idx = 0
        self.random_seed: Optional[int] = None
        self.version = 0

    def _bump(self):
        """Mark a mutation: plans cached for the old version are not reused."""
        self.version += 1

    def block(self, index: int) -> Block:
        return self.blocks[index]

    def to_string(self, throw_on_error=False, with_details=False) -> str:
        """The program as JSON text over `to_dict` (the JAX package's form)."""
        import json

        return json.dumps(self.to_dict(), indent=2, default=str)

    @staticmethod
    def parse_from_string(s: str) -> "Program":
        import json

        return Program.from_dict(json.loads(s))

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        """A new block under the current one (or `parent_idx`), made current."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump()
        return b

    def rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy.  for_test=True switches every `is_test` attr on (dropout
        becomes identity) and cuts the block at its `backward` op."""
        p = copy.deepcopy(self)
        p._uuid = uuid.uuid4().hex
        if for_test:
            for blk in p.blocks:
                cut = None
                for i, op in enumerate(blk.ops):
                    if op.type == "backward":
                        cut = i
                        break
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
                if cut is not None and blk.idx == 0:
                    blk.ops = blk.ops[:cut]
        p._bump()
        return p

    def to_dict(self) -> dict:
        return {"version": 1, "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks]}

    @staticmethod
    def from_dict(d: dict) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed")
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd.get("parent_idx", -1))
            for vd in bd["vars"]:
                v = Variable(
                    b, vd["name"], shape=vd["shape"], dtype=vd["dtype"],
                    lod_level=vd.get("lod_level", 0), persistable=vd.get("persistable", False),
                    stop_gradient=vd.get("stop_gradient", False), is_data=vd.get("is_data", False),
                )
                if vd.get("trainable"):
                    v.__class__ = Parameter
                    v.trainable = True
                    v.optimize_attr = {"learning_rate": 1.0}
                b.vars[v.name] = v
            for od in bd["ops"]:
                b.ops.append(Operator(b, od["type"], od["inputs"], od["outputs"],
                                      _dejsonify_attrs(od["attrs"])))
            p.blocks.append(b)
        if not p.blocks:
            p.blocks = [Block(p, 0)]
        p._bump()
        return p

    def __repr__(self):
        lines = ["Program("]
        for blk in self.blocks:
            lines.append(f"  Block {blk.idx} (parent {blk.parent_idx}):")
            lines.extend(f"    {op}" for op in blk.ops)
        return "\n".join(lines) + ")"


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    global _main_program, _startup_program
    old_main, old_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program = old_main
        _startup_program = old_startup


@contextlib.contextmanager
def name_scope(prefix=None):
    """Prefix the op and variable names generated inside with `prefix`
    (nested scopes compose as outer/inner, repeated siblings take suffixes;
    the counters are not reset)."""
    if prefix:
        with unique_name.name_scope_guard(prefix):
            yield
    else:
        yield
