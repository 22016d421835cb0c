"""Dygraph core: VarBase, the tape and the guard (counterpart of
paddle_tpu/dygraph/base.py).

An eager op runs at once on tensors of the guard's device.  When some input
does not stop the gradient, the tape records the call: each such floating
input enters as a fresh autograd leaf, the closure runs under
`torch.enable_grad()`, and the entry keeps the leaves and the outputs with
their graph.  `Tape.backward` walks the entries in reverse and asks
`torch.autograd.grad` for each entry's vector-Jacobian product, as the JAX
package asks `jax.vjp` for each of its entries: the gradients are summed
per input in the order of the walk and then assigned (a second
`backward(retain_graph=True)` overwrites `.grad`, it does not add), an input
that an entry used but that gets no cotangent gets zeros, and the loss
itself gets no `.grad`.  The forward runs once; `.value` is a plain tensor
that the optimizer and `set_value` rebind.

Values go through the x32 rule of the JAX package (float64 -> float32,
int64 -> int32), and `guard(place)` puts every VarBase made under it on
`place.device`; without a place, and outside any guard, that is
`CUDAPlace(0)`, which raises on a machine without a card.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.dtypes import canonical_dtype, to_numpy, to_tensor
from ..ops.common import canon_dtype

_dygraph_tracer: Optional["Tape"] = None
_device: Optional[torch.device] = None


def enabled() -> bool:
    return _dygraph_tracer is not None


def _tape() -> Optional["Tape"]:
    return _dygraph_tracer


def _place_device(place) -> torch.device:
    if place is None:
        from ..core.executor import CUDAPlace

        place = CUDAPlace(0)
    return place.device if hasattr(place, "device") else torch.device(place)


def current_device() -> torch.device:
    """The device new VarBases go to: the guard's, else the card's."""
    return _device if _device is not None else _place_device(None)


def _as_value(value, device=None) -> torch.Tensor:
    """A tensor of `value` through the x32 rule; a tensor keeps its device,
    anything else goes to `device` (default: the current one)."""
    if isinstance(value, VarBase):
        value = value.value
    if isinstance(value, torch.Tensor):
        return value.to(canon_dtype(canonical_dtype(value.dtype)))
    arr = np.asarray(value)
    return to_tensor(arr, canon_dtype(arr.dtype), device or current_device())


def promote(*ts):
    """The tensors cast to one floating dtype as jnp promotes them (bf16 with
    float32 computes in float32), for the ops torch will not mix."""
    want = ts[0].dtype
    for t in ts[1:]:
        want = torch.promote_types(want, t.dtype)
    return [t if t.dtype == want else t.to(want) for t in ts]


class VarBase:
    """Eager tensor: a tensor on the device and a grad slot."""

    def __init__(self, value, stop_gradient: bool = False, name: Optional[str] = None,
                 persistable: bool = False):
        self.value = _as_value(value)
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self.name = name
        self.grad: Optional[torch.Tensor] = None

    # --- introspection ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return canonical_dtype(self.value.dtype)

    def numpy(self) -> np.ndarray:
        return to_numpy(self.value)

    def gradient(self) -> Optional[np.ndarray]:
        return None if self.grad is None else to_numpy(self.grad)

    def clear_gradient(self):
        self.grad = None

    def set_value(self, value):
        self.value = _as_value(value, self.value.device)

    def detach(self) -> "VarBase":
        return VarBase(self.value, stop_gradient=True, name=self.name)

    def astype(self, dtype) -> "VarBase":
        want = canon_dtype(dtype)
        return _apply("cast", lambda x: x.to(want), self)

    # --- autograd --------------------------------------------------------
    def backward(self, retain_graph: bool = False):
        tape = _tape()
        if tape is None:
            raise RuntimeError("backward() outside fluid.dygraph.guard()")
        tape.backward(self, retain_graph=retain_graph)

    # --- operator sugar --------------------------------------------------
    def _bin(self, other, fn, name):
        if not isinstance(other, VarBase):
            # a Python scalar takes self's dtype, as jnp.asarray(o, dtype) does
            other = VarBase(torch.as_tensor(np.asarray(other), dtype=self.value.dtype,
                                            device=self.value.device), stop_gradient=True)
        return _apply(name, fn, self, other)

    def __add__(self, o):
        return self._bin(o, torch.add, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, torch.sub, "sub")

    def __rsub__(self, o):
        return VarBase(o, stop_gradient=True)._bin(self, torch.sub, "sub") if not isinstance(o, VarBase) else o._bin(self, torch.sub, "sub")

    def __mul__(self, o):
        return self._bin(o, torch.mul, "mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, torch.div, "div")

    def __matmul__(self, o):
        return self._bin(o, lambda a, b: torch.matmul(*promote(a, b)), "matmul")

    def __neg__(self):
        return _apply("neg", torch.neg, self)

    def __repr__(self):
        return f"VarBase(shape={self.shape}, dtype={self.dtype}, stop_gradient={self.stop_gradient})\n{self.value}"


def _run(fn, args):
    out = fn(*args)
    multi = isinstance(out, (tuple, list))
    return (list(out) if multi else [out]), multi


class _Traced:
    """One eager call with its autograd graph: `leaves[i]` is the leaf that
    stood for input i (None where the input takes no gradient), `outs` the
    outputs as computed, graph attached."""

    __slots__ = ("fn", "leaves", "outs", "multi")

    def __init__(self, fn, inputs: Sequence["VarBase"]):
        """Run fn on the inputs' values, each floating input that does not
        stop the gradient as a fresh leaf."""
        self.fn = fn
        self.leaves, args = [], []
        for i in inputs:
            v = i.value
            if not i.stop_gradient and v.is_floating_point():
                v = v.detach().requires_grad_(True)
                self.leaves.append(v)
            else:
                self.leaves.append(None)
            args.append(v)
        with torch.enable_grad():
            self.outs, self.multi = _run(fn, args)

    def __call__(self, *args):
        return self.fn(*args)


class _TapeEntry:
    __slots__ = ("fn", "inputs", "outputs")

    def __init__(self, fn, inputs, outputs):
        self.fn = fn
        self.inputs = inputs
        self.outputs = outputs


class Tape:
    """Records eager ops; `backward` walks them in reverse, one
    `torch.autograd.grad` an entry."""

    def __init__(self):
        self.entries: List[_TapeEntry] = []

    def record(self, fn, inputs: Sequence[VarBase], outputs: Sequence[VarBase]):
        """Record `fn(inputs) -> outputs` when some input takes a gradient.
        `fn` is the traced call `_apply` made; any other callable is run
        again under autograd at `backward`, as `jax.vjp` runs it."""
        if any(not i.stop_gradient for i in inputs):
            self.entries.append(_TapeEntry(fn, list(inputs), list(outputs)))
            for o in outputs:
                o.stop_gradient = False
        else:
            for o in outputs:
                o.stop_gradient = True

    def backward(self, loss: VarBase, retain_graph: bool = False):
        grads: Dict[int, torch.Tensor] = {id(loss): torch.ones_like(loss.value)}
        for entry in reversed(self.entries):
            cots = []
            needed = False
            for o in entry.outputs:
                g = grads.get(id(o))
                if g is None:
                    g = torch.zeros_like(o.value)
                else:
                    needed = True
                cots.append(g)
            if not needed:
                continue
            traced = entry.fn if isinstance(entry.fn, _Traced) else _Traced(entry.fn,
                                                                            entry.inputs)
            live = [(out, cot) for out, cot in zip(traced.outs, cots) if out.requires_grad]
            wants = [(k, leaf) for k, leaf in enumerate(traced.leaves) if leaf is not None]
            if not live or not wants:
                continue
            in_grads = torch.autograd.grad([o for o, _ in live], [leaf for _, leaf in wants],
                                           [c for _, c in live], retain_graph=retain_graph,
                                           allow_unused=True)
            for (k, leaf), g in zip(wants, in_grads):
                iv = entry.inputs[k]
                if iv.stop_gradient:
                    continue
                if g is None:  # unused: jax.vjp gives zeros
                    g = torch.zeros_like(leaf)
                prev = grads.get(id(iv))
                grads[id(iv)] = g if prev is None else prev + g
                iv.grad = grads[id(iv)]
        if not retain_graph:
            self.entries.clear()


def _apply(name: str, fn: Callable, *inputs: VarBase, n_out: int = 1) -> VarBase:
    """Run fn eagerly on VarBase inputs, record on the tape."""
    tape = _tape()
    if tape is not None and any(not i.stop_gradient for i in inputs):
        call = _Traced(fn, inputs)
        out_vals, multi = call.outs, call.multi
    else:
        call = fn
        with torch.no_grad():
            out_vals, multi = _run(fn, [i.value for i in inputs])
    outs = [VarBase(v.detach()) for v in out_vals]
    if tape is not None:
        tape.record(call, inputs, outs)
    else:
        for o in outs:
            o.stop_gradient = True
    return tuple(outs) if multi else outs[0]


@contextlib.contextmanager
def guard(place=None):
    """reference: fluid.dygraph.guard() — enables eager mode on `place`
    (default CUDAPlace(0))."""
    global _dygraph_tracer, _device
    device = _place_device(place)
    old = _dygraph_tracer, _device
    _dygraph_tracer, _device = Tape(), device
    try:
        yield
    finally:
        _dygraph_tracer, _device = old


def to_variable(value, name=None, zero_copy=None) -> VarBase:
    if isinstance(value, VarBase):
        return value
    if isinstance(value, torch.Tensor):
        return VarBase(value.to(current_device()), stop_gradient=True, name=name)
    return VarBase(np.asarray(value), stop_gradient=True, name=name)
