"""Named lock registry: every lock of the port's data and resilience layers
has a name and a rank (counterpart of paddle_tpu/core/locks.py, the same
names and ranks: `data.recordio_lib` 50, `data.corrupt_budget` 52,
`integrity.state` 46, `faults.io` 48).

    from paddle_tpu_torch.core.locks import named_lock
    _LOCK = named_lock("data.recordio_lib", rank=50)

``name`` is a stable dotted identifier; ``rank`` declares the lock's place
in the process-wide partial order: a thread may only acquire a lock whose
rank is strictly greater than every lock it already holds.  One rank per
name: a second creation site that declares another rank raises.

The JAX package's opt-in telemetry and acquisition deadline
(FLAGS_lock_telemetry, FLAGS_lock_timeout_s) are not ported: a lock here
is the raw ``threading.Lock`` under its name.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["NamedLock", "named_lock"]

_RANKS: Dict[str, int] = {}
_REG_GUARD = threading.Lock()  # guards _RANKS at creation time only


class NamedLock:
    """A ``threading.Lock`` with a registered name and rank; a context
    manager with ``acquire`` / ``release`` / ``locked`` like the raw lock."""

    __slots__ = ("name", "rank", "_lock")

    def __init__(self, name: str, rank: int):
        with _REG_GUARD:
            prev = _RANKS.get(name)
            if prev is not None and prev != rank:
                raise ValueError(
                    f"lock {name!r} already registered with rank {prev}; "
                    f"a second creation site declared rank {rank} — one rank "
                    f"per name")
            _RANKS[name] = int(rank)
        self.name = name
        self.rank = int(rank)
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._lock.acquire(blocking, timeout)

    def release(self):
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def __repr__(self):
        return f"NamedLock({self.name!r}, rank={self.rank})"


def named_lock(name: str, rank: int) -> NamedLock:
    """The way the port's data and resilience layers create a mutex."""
    return NamedLock(name, rank)
