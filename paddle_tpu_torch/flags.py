"""Typed flag registry with FLAGS_* environment passthrough (counterpart of
paddle_tpu/flags.py), holding the flags this port reads so far.  The JAX
package defines 39; each of the others arrives with the module that reads
it."""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, dict] = {}


def _define(name: str, typ, default, help: str):
    value = default
    if name in os.environ:
        value = _coerce(typ, os.environ[name])
    _REGISTRY[name] = {"type": typ, "value": value, "default": default, "help": help}


def _coerce(typ, v):
    if typ is bool and isinstance(v, str):
        return v.lower() in ("1", "true", "yes", "on")
    return typ(v)


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        if k not in _REGISTRY:
            raise KeyError(f"unknown flag {k!r}; known: {sorted(_REGISTRY)}")
        _REGISTRY[k]["value"] = _coerce(_REGISTRY[k]["type"], v)


def get_flags(names) -> Dict[str, Any]:
    if isinstance(names, str):
        names = [names]
    return {n: _REGISTRY[n]["value"] for n in names}


def flag(name: str):
    return _REGISTRY[name]["value"]


_define("FLAGS_check_nan_inf", bool, False,
        "after each run, scan fetched values for NaN/Inf and raise")
_define("FLAGS_integrity_verify_load", bool, True,
        "verify the sha256 + byte-length stamps of a model directory's manifest "
        "whenever it is loaded")
_define("FLAGS_executor_cache_capacity", int, 128,
        "LRU capacity of the executor's plan cache (program x feed signature x "
        "fetch list); an evicted plan drops its CUDA graph and static buffers")
_define("FLAGS_verify_program", str, "structural",
        "static-analysis level applied to programs before they run "
        "(core/analysis.py): 'off' trusts the builder (and turns off the "
        "append_op-time shape/dtype inference), 'structural' (default) runs "
        "the program verifier (def-before-use, dangling vars, unregistered "
        "ops, orphan sub-blocks, duplicate parameter writes, feed/fetch "
        "targets) on every executor plan-cache miss and after every "
        "registered pass, 'full' adds whole-program shape/dtype re-inference "
        "and the hazard lints (donation, recompile, RNG determinism).  "
        "Error-severity findings raise ProgramVerificationError naming the "
        "op, var and block")
