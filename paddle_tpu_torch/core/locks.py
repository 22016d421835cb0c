"""Named lock registry: every lock of the port has a name and a rank
(counterpart of paddle_tpu/core/locks.py, the same names, ranks, flags and
diagnostics).

    from paddle_tpu_torch.core.locks import named_lock
    self._lock = named_lock("serving.registry", rank=14, reentrant=True)

``name`` is a stable dotted identifier (it keys the telemetry counters and
appears in every diagnostic); ``rank`` declares the lock's place in the
process-wide partial order: **a thread may only acquire a lock whose rank
is strictly greater than every lock it already holds** (re-entrant
same-name acquisition through a ``reentrant=True`` lock is exempt).  One
rank per name: a second creation site that declares another rank raises.
The ranks in use:

    serving.publish 10, serving.server 12, serving.registry 14,
    serving.clones 16, inference.predictor 20, integrity.state 46,
    faults.io 48, data.recordio_lib 50, data.corrupt_budget 52,
    monitor.blackbox 60, monitor.rate 62, monitor.registry 64,
    monitor.logger 66

Two opt-in runtime switches, a module-global branch when both are off:

* ``FLAGS_lock_telemetry`` -- per-lock monitor counters
  ``lock.<name>.acquires`` / ``.contended`` / ``.wait_us`` / ``.hold_us``,
  and ``lock.order_inversions`` when an acquisition inverts the declared
  ranks (counted, never raised).  The monitor's own locks opt out
  (``telemetry=False``): a Counter.inc that counted itself would recurse.

* ``FLAGS_lock_timeout_s`` -- every blocking ``acquire`` gets a deadline;
  past it a classified ``errors.LockTimeoutError`` (a FatalError) names the
  wanted lock and every lock the thread holds, with their ranks.

Disabled, ``acquire`` / ``__enter__`` are one global branch and the raw
primitive; ``release`` adds one thread-local read and two falsy checks
(cleanup does not depend on the current flag state, so a flag turned off
mid-hold strands no bookkeeping).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["NamedLock", "NamedCondition", "named_lock", "named_rlock",
           "named_condition", "lock_ranks", "held_locks", "refresh_from_flags"]

# name -> (rank, reentrant); one rank per name, process-wide.  Several
# instances may share a name (every serving.clones lock): one lock class.
_RANKS: Dict[str, Tuple[int, bool]] = {}
# guards _RANKS and _COUNTERS at creation time only; a raw lock, ordering
# nothing a caller sees
_REG_GUARD = threading.Lock()

_TLS = threading.local()

# the flags' values, refreshed by flags.set_flags (refresh_from_flags);
# _ACTIVE gates all slow-path work with one global load
_TELEMETRY = False
_TIMEOUT_S = 0.0
_ACTIVE = False

_MON_REF = None  # the monitor, bound lazily (monitor.core makes its locks here)

# name -> (acquires, contended, wait_us, hold_us) counters
_COUNTERS: Dict[str, tuple] = {}


def refresh_from_flags():
    """Re-read FLAGS_lock_telemetry / FLAGS_lock_timeout_s (flags.set_flags
    calls this; the import below seeds from the environment)."""
    global _TELEMETRY, _TIMEOUT_S, _ACTIVE
    from ..flags import flag

    _TELEMETRY = bool(flag("FLAGS_lock_telemetry"))
    _TIMEOUT_S = float(flag("FLAGS_lock_timeout_s"))
    _ACTIVE = _TELEMETRY or _TIMEOUT_S > 0


def _mon():
    global _MON_REF
    if _MON_REF is None:
        from ..monitor import MONITOR

        _MON_REF = MONITOR
    return _MON_REF


def _counters(name: str) -> tuple:
    c = _COUNTERS.get(name)
    if c is None:
        # made outside _REG_GUARD: Monitor.counter takes monitor.registry,
        # whose creation went through _REG_GUARD; Monitor.counter is
        # idempotent, so a racing double-create is harmless
        mon = _mon()
        tup = (mon.counter(f"lock.{name}.acquires"),
               mon.counter(f"lock.{name}.contended"),
               mon.counter(f"lock.{name}.wait_us"),
               mon.counter(f"lock.{name}.hold_us"))
        with _REG_GUARD:
            c = _COUNTERS.setdefault(name, tup)
    return c


def _held() -> list:
    h = getattr(_TLS, "held", None)
    if h is None:
        h = _TLS.held = []
    return h


def held_locks() -> List[Tuple[str, int]]:
    """[(name, rank)] of the named locks this thread holds; tracked only
    while telemetry or a lock timeout is on."""
    return [(lk.name, lk.rank) for lk in _held()]


def lock_ranks() -> Dict[str, int]:
    """{name: declared rank} of every lock registered in this process."""
    with _REG_GUARD:
        return {n: r for n, (r, _) in sorted(_RANKS.items())}


def _register(name: str, rank: int, reentrant: bool):
    with _REG_GUARD:
        prev = _RANKS.get(name)
        if prev is not None and prev[0] != rank:
            raise ValueError(
                f"lock {name!r} already registered with rank {prev[0]}; "
                f"a second creation site declared rank {rank} — one rank "
                f"per name")
        _RANKS[name] = (int(rank), bool(reentrant))


class NamedLock:
    """A ``threading.Lock`` / ``RLock`` with a registered name and rank: a
    context manager with ``acquire`` / ``release`` / ``locked`` like the
    raw primitive, and usable under a ``threading.Condition``."""

    __slots__ = ("name", "rank", "telemetry", "reentrant", "_lock",
                 "_t_hold", "_depth")

    def __init__(self, name: str, rank: int, *, reentrant: bool = False,
                 telemetry: bool = True):
        _register(name, rank, reentrant)
        self.name = name
        self.rank = int(rank)
        self.reentrant = bool(reentrant)
        self.telemetry = bool(telemetry)
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self._t_hold = 0.0
        self._depth = 0  # re-entry depth of a slow-path hold (holder-only)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _ACTIVE:
            return self._lock.acquire(blocking, timeout)
        return self._acquire_slow(blocking, timeout)

    def release(self):
        h = getattr(_TLS, "held", None)
        if h:
            for i in range(len(h) - 1, -1, -1):
                if h[i] is self:
                    del h[i]
                    break
        if self._depth > 0:
            self._depth -= 1
            last = self._depth == 0
        else:
            last = True
        if self._t_hold and last:
            # only the holder gets here between its acquire and release
            if _TELEMETRY and self.telemetry:
                _counters(self.name)[3].inc(
                    int((time.perf_counter() - self._t_hold) * 1e6))
            self._t_hold = 0.0
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        probe = getattr(self._lock, "locked", None)
        if probe is not None:
            return probe()
        # an RLock before Python 3.14 has no locked(), and acquire(False)
        # by its holder would re-enter: ask about ownership first
        owned = getattr(self._lock, "_is_owned", None)
        if owned is not None and owned():
            return True
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def _acquire_slow(self, blocking, timeout, use_timeout=True) -> bool:
        tel = _TELEMETRY and self.telemetry
        if tel:
            held = _held()
            if held:
                top = max((lk.rank for lk in held if lk.name != self.name),
                          default=-1)
                if top >= self.rank:
                    _mon().counter("lock.order_inversions").inc()
        if not blocking or timeout != -1:
            # the caller's own non-blocking or deadline semantics
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                self._track_acquired(tel, contended=False, t0=0.0)
            return ok
        t0 = time.perf_counter() if tel else 0.0
        contended = False
        timeout_s = _TIMEOUT_S if use_timeout else 0.0
        if tel and not self._lock.acquire(False):
            contended = True
            ok = (self._lock.acquire(True, timeout_s) if timeout_s > 0
                  else self._lock.acquire())
        elif not tel:
            ok = (self._lock.acquire(True, timeout_s) if timeout_s > 0
                  else self._lock.acquire())
        else:
            ok = True
        if not ok:
            self._raise_timeout()
        self._track_acquired(tel, contended, t0)
        return True

    def _track_acquired(self, tel, contended, t0):
        _held().append(self)
        if self.reentrant:
            self._depth += 1
        if tel:
            c = _counters(self.name)
            c[0].inc()
            if contended:
                c[1].inc()
                c[2].inc(int((time.perf_counter() - t0) * 1e6))
            if not self.reentrant or self._depth == 1:
                # hold_us spans the first acquire to the last release
                self._t_hold = time.perf_counter()

    def _raise_timeout(self):
        from ..errors import LockTimeoutError

        held = [(lk.name, lk.rank) for lk in _held() if lk is not self]
        held_s = (", ".join(f"{n!r} (rank {r})" for n, r in held)
                  or "no named locks")
        raise LockTimeoutError(
            f"could not acquire lock {self.name!r} (rank {self.rank}) "
            f"within FLAGS_lock_timeout_s={_TIMEOUT_S}s; this thread "
            f"holds {held_s} — suspected deadlock or lock-order inversion",
            wanted=self.name, wanted_rank=self.rank, held=held,
            timeout_s=_TIMEOUT_S)

    # threading.Condition calls these
    def _release_save(self):
        self.release()

    def _acquire_restore(self, _saved):
        """Condition.wait's re-acquisition, exempt from the deadline: the
        waiter holds nothing (it just released this lock), and raising
        here would leave the with-block releasing a lock it does not
        hold."""
        if not _ACTIVE:
            self._lock.acquire()
            return
        self._acquire_slow(True, -1, use_timeout=False)

    def _is_owned(self) -> bool:
        inner = self._lock
        owned = getattr(inner, "_is_owned", None)
        if owned is not None:
            return owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __repr__(self):
        return (f"NamedLock({self.name!r}, rank={self.rank}"
                f"{', reentrant' if self.reentrant else ''})")


class NamedCondition:
    """``threading.Condition`` over a (non-reentrant) ``NamedLock``: its
    lock takes part in the declared order and the telemetry like any
    other, and ``wait`` releases and re-acquires through the wrapper."""

    __slots__ = ("_nl", "_cond")

    def __init__(self, name: str, rank: int, *, telemetry: bool = True):
        self._nl = NamedLock(name, rank, telemetry=telemetry)
        self._cond = threading.Condition(self._nl)

    @property
    def name(self) -> str:
        return self._nl.name

    @property
    def rank(self) -> int:
        return self._nl.rank

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._nl.acquire(blocking, timeout)

    def release(self):
        self._nl.release()

    def __enter__(self):
        self._cond.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cond.__exit__(*exc)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()

    def __repr__(self):
        return f"NamedCondition({self.name!r}, rank={self.rank})"


def named_lock(name: str, rank: int, *, reentrant: bool = False,
               telemetry: bool = True) -> NamedLock:
    """The way the port creates a mutex; only strictly ascending ranks nest."""
    return NamedLock(name, rank, reentrant=reentrant, telemetry=telemetry)


def named_rlock(name: str, rank: int, *, telemetry: bool = True) -> NamedLock:
    """Re-entrant variant: the holder may take it again (exempt from the
    rank check)."""
    return NamedLock(name, rank, reentrant=True, telemetry=telemetry)


def named_condition(name: str, rank: int, *,
                    telemetry: bool = True) -> NamedCondition:
    """A condition variable whose lock is named and ranked."""
    return NamedCondition(name, rank, telemetry=telemetry)


refresh_from_flags()
