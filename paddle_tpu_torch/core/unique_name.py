"""Unique name generator (counterpart of paddle_tpu/core/unique_name.py).

Per-prefix counters inside a guard-able generator, so two packages building
the same model under fresh guards produce the same variable names.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{self.prefix}{key}_{tmp}"


generator = UniqueNameGenerator()

# name scopes (paddle_tpu/core/unique_name.py:20-51): a path of scope names
# prefixes every generated name without resetting the counters, and repeated
# sibling scopes take suffixes ("encoder", "encoder_1", ...)
_scope_stack: list = []
_scope_children: dict = defaultdict(lambda: defaultdict(int))


def generate(key: str) -> str:
    name = generator(key)
    if _scope_stack:
        return "/".join(_scope_stack) + "/" + name
    return name


@contextlib.contextmanager
def name_scope_guard(prefix: str):
    """Prefix the names generated inside with `prefix` (deduplicated among
    its siblings), below the enclosing scopes."""
    parent = "/".join(_scope_stack)
    n = _scope_children[parent][prefix]
    _scope_children[parent][prefix] += 1
    _scope_stack.append(prefix if n == 0 else f"{prefix}_{n}")
    try:
        yield
    finally:
        _scope_stack.pop()


@contextlib.contextmanager
def guard(new_prefix: str = ""):
    """Swap in a fresh generator (tests, reproducible builds)."""
    global generator
    old = generator
    generator = UniqueNameGenerator(new_prefix)
    try:
        yield
    finally:
        generator = old


def switch(new_generator=None):
    """Swap in `new_generator` (a fresh one when None) and return the old."""
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old
