"""Scope: name -> tensor store (counterpart of paddle_tpu/core/scope.py).

Holds the persistent state between runs (parameters, the RNG generator)
as torch tensors on the place's device; the executor writes a run's
persistable outputs back here.  `Scope._uuid` keys the executor's plan
cache.  Every `set_var` of any scope advances one process-wide write
count (`writes()`): a plan replayed from a CUDA graph reads the tensors it
captured, and it checks them against the scope only when that count moved
since its last run.
"""
from __future__ import annotations

import contextlib
import uuid
from typing import Dict, List, Optional

import numpy as np

from .dtypes import to_numpy

RNG_STATE_VAR = "__rng_state__"

_writes = 0


def writes() -> int:
    """How many `set_var` calls any scope has taken so far."""
    return _writes


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, object] = {}
        self.parent = parent
        self.kids: List["Scope"] = []
        self._uuid = uuid.uuid4().hex

    def new_scope(self) -> "Scope":
        """A child scope: its lookups fall through to this one."""
        kid = Scope(self)
        self.kids.append(kid)
        return kid

    def set_var(self, name: str, value) -> None:
        global _writes
        self._vars[name] = value
        _writes += 1

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def erase(self, names) -> None:
        """Drop `names` from this scope (not from its parents); counts as a
        write, as set_var does."""
        global _writes
        for n in names:
            self._vars.pop(n, None)
        _writes += 1

    def local_var_names(self):
        return list(self._vars)

    def var_names(self) -> List[str]:
        """Every name this scope or a parent holds, sorted."""
        names = set()
        s: Optional[Scope] = self
        while s is not None:
            names.update(s._vars)
            s = s.parent
        return sorted(names)

    def to_numpy(self, name: str) -> np.ndarray:
        v = self.find_var(name)
        if v is None:
            raise KeyError(f"variable {name!r} not in scope")
        return to_numpy(v)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old
