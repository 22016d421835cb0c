"""Monitor core: span tracer, counter/gauge registry, step records and the
flight recorder (counterpart of paddle_tpu/monitor/core.py).

Every layer of the port reports spans and counters into one process-global
`Monitor`; the exporters (exporters.py) render the same state as a
Prometheus text page, a JSON snapshot, a Chrome trace, a summary table or
an appended JSONL stream.

Disabled (the default), `span()` returns a shared do-nothing singleton and
`Counter.inc` / `Gauge.set` / `observe` / `record_step` are one branch.

Flight recorder: besides the capped buffers (which keep the oldest
records), the monitor keeps bounded rings of the NEWEST step records and
span events.  `arm_flight_recorder(path, rank)` names a
`BLACKBOX.p<rank>.json` destination; `dump_blackbox(reason)` writes the
rings and the live counters and gauges there atomically (tmp + fsync +
rename).  The first dump wins.  The resilience layer dumps on a SIGTERM
drain and on a preemption, integrity.py when a divergence latches.

Request traces: the serving runtime (serving/tracing.py) closes one
`serving_trace` record a request into a bounded ring (`record_trace`,
`request_traces`; TRACE_RING_CAP), which also rides the step records, and
keeps the slow or bad ones (shed, timeout, error, late, rejected publish)
in an exemplar ring (`record_exemplar`, `exemplars`; EXEMPLAR_CAP) that
the black box carries under `exemplars`.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..core.locks import named_lock

# caps on buffered span events and step records, so an always-on monitor in
# a long-running trainer cannot grow without bound
EVENT_CAP = 200_000
STEP_CAP = 50_000
# flight-recorder ring depth: the last N step records and span events a
# black box carries
FLIGHT_RECORDER_CAP = 256
# the newest closed request traces kept (serving/tracing.py)
TRACE_RING_CAP = 1024
# the slow / bad-request traces the black box keeps
EXEMPLAR_CAP = 64


class _NullSpan:
    """Shared do-nothing span returned while the monitor is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kw):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """Timed region.  Nesting is tracked per thread: its depth and a tid land
    in the event buffer, so the Chrome trace draws child spans inside their
    parents."""

    __slots__ = ("mon", "name", "args", "t0", "ts")

    def __init__(self, mon: "Monitor", name: str, args: Optional[dict]):
        self.mon = mon
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.ts = 0.0

    def annotate(self, **kw):
        if self.args is None:
            self.args = dict(kw)
        else:
            self.args.update(kw)
        return self

    def __enter__(self):
        tls = self.mon._tls
        tls.depth = getattr(tls, "depth", 0) + 1
        self.ts = time.time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        tls = self.mon._tls
        depth = getattr(tls, "depth", 1)
        tls.depth = depth - 1
        self.mon._record(self.name, self.ts, dur, depth - 1, self.args)
        return False


class Counter:
    """Monotonic counter: `inc` is one branch when disabled, and takes a
    per-counter lock when enabled (`value += n` alone can lose increments
    to a thread switch)."""

    __slots__ = ("mon", "name", "value", "_lock")

    def __init__(self, mon: "Monitor", name: str):
        self.mon = mon
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1):
        if self.mon.enabled:
            with self._lock:
                self.value += n
        return self


class Gauge:
    """Point-in-time value: `set()` explicitly, or `set_fn()` a callable
    read lazily (how the memory gauges stay off the hot path)."""

    __slots__ = ("mon", "name", "value", "fn")

    def __init__(self, mon: "Monitor", name: str):
        self.mon = mon
        self.name = name
        self.value = 0.0
        self.fn: Optional[Callable[[], float]] = None

    def set(self, v: float):
        if self.mon.enabled:
            self.value = v
        return self

    def set_fn(self, fn: Callable[[], float]):
        self.fn = fn
        return self

    def read(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return float("nan")
        return float(self.value)


class Monitor:
    """Process-global telemetry sink (monitor/__init__.py holds the one
    instance)."""

    def __init__(self):
        self.enabled = False
        self._lock = named_lock("monitor.registry", rank=64, telemetry=False)
        self._tls = threading.local()
        # span aggregates: name -> [calls, total_s, max_s, min_s]
        self._agg: Dict[str, list] = {}
        # raw events for the trace: (name, ts_s, dur_s, tid, depth, args)
        self._events: List[tuple] = []
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._steps: List[dict] = []
        self._loggers: List[Any] = []
        # flight recorder: bounded rings of the NEWEST records
        self._bb_steps: deque = deque(maxlen=FLIGHT_RECORDER_CAP)
        self._bb_events: deque = deque(maxlen=FLIGHT_RECORDER_CAP)
        self._bb_path: Optional[str] = None
        self._bb_rank = 0
        self._bb_dumped: Optional[str] = None
        self._traces: deque = deque(maxlen=TRACE_RING_CAP)
        self._exemplars: deque = deque(maxlen=EXEMPLAR_CAP)
        # the dump latch: held across snapshot and write (not self._lock,
        # which the snapshot takes)
        self._bb_dump_lock = named_lock("monitor.blackbox", rank=60,
                                        telemetry=False)
        # this process's lane in a merged multi-process trace
        self.lane = 0
        self.lane_name = "paddle_tpu"
        # the steps/sec EMA has its own lock: record_step also takes the
        # registry lock, and nesting the two would invite deadlock
        self._rate_lock = named_lock("monitor.rate", rank=62, telemetry=False)
        self._last_step_t: Optional[float] = None
        self._steps_per_sec_ema = 0.0

    # -- lifecycle ---------------------------------------------------------
    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def reset(self):
        with self._lock:
            self._agg.clear()
            self._events.clear()
            self._steps.clear()
            self._bb_steps.clear()
            self._bb_events.clear()
            self._traces.clear()
            self._exemplars.clear()
            # a reset starts a fresh run: the dump latch re-opens (the armed
            # path survives)
            self._bb_dumped = None
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                if g.fn is None:
                    g.value = 0.0
            self._last_step_t = None
            self._steps_per_sec_ema = 0.0
        return self

    def set_lane(self, lane: int, name: Optional[str] = None):
        """This process's trace lane (a Chrome-trace pid), so merged traces
        show one lane per worker."""
        self.lane = int(lane)
        if name is not None:
            self.lane_name = str(name)
        return self

    # -- spans -------------------------------------------------------------
    def span(self, name: str, **args):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, args or None)

    def observe(self, name: str, seconds: float, ts: Optional[float] = None, **args):
        """Record a completed duration without a context manager."""
        if not self.enabled:
            return
        self._record(name, ts if ts is not None else time.time() - seconds, seconds,
                     getattr(self._tls, "depth", 0), args or None)

    def _record(self, name, ts, dur, depth, args):
        tid = threading.get_ident() & 0xFFFF
        with self._lock:
            a = self._agg.get(name)
            if a is None:
                self._agg[name] = [1, dur, dur, dur]
            else:
                a[0] += 1
                a[1] += dur
                if dur > a[2]:
                    a[2] = dur
                if dur < a[3]:
                    a[3] = dur
            if len(self._events) < EVENT_CAP:
                self._events.append((name, ts, dur, tid, depth, args))
            self._bb_events.append((name, ts, dur, tid, depth, args))

    def span_stats(self) -> Dict[str, dict]:
        with self._lock:
            return {n: {"calls": a[0], "total_s": a[1], "max_s": a[2], "min_s": a[3]}
                    for n, a in self._agg.items()}

    def events(self) -> List[tuple]:
        with self._lock:
            return list(self._events)

    # -- counters / gauges -------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(self, name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(self, name))
        return g

    def counter_values(self) -> Dict[str, int]:
        return {n: c.value for n, c in sorted(self._counters.items())}

    def gauge_values(self) -> Dict[str, float]:
        return {n: g.read() for n, g in sorted(self._gauges.items())}

    # -- step records ------------------------------------------------------
    def record_step(self, record: dict):
        """Append one record (the executor's kind="step", or train_loop's
        kind="pipeline_step") and hand it to the attached loggers.  Only
        kind="step" records advance the executor.steps counter and the
        steps/sec EMA."""
        if not self.enabled:
            return
        record = dict(record)
        record.setdefault("kind", "step")
        record.setdefault("ts", time.time())
        is_exec_step = record["kind"] == "step"
        steps_counter = self.counter("executor.steps")  # before _lock: counter() locks too
        if is_exec_step:
            rate_gauge = self.gauge("executor.steps_per_sec_ema")
            now = time.perf_counter()
            with self._rate_lock:
                if self._last_step_t is not None:
                    dt = now - self._last_step_t
                    if dt > 0:
                        inst = 1.0 / dt
                        ema = self._steps_per_sec_ema
                        self._steps_per_sec_ema = inst if ema == 0.0 else 0.9 * ema + 0.1 * inst
                        rate_gauge.set(self._steps_per_sec_ema)
                self._last_step_t = now
        record.setdefault("lane", self.lane)
        record["step"] = steps_counter.value
        with self._lock:
            if len(self._steps) < STEP_CAP:
                self._steps.append(record)
            self._bb_steps.append(record)
        if is_exec_step:
            steps_counter.inc()
        for lg in list(self._loggers):
            try:
                lg.on_step(record)
            except Exception:
                pass

    def step_records(self) -> List[dict]:
        with self._lock:
            return list(self._steps)

    # -- request traces ----------------------------------------------------
    def record_trace(self, record: dict):
        """Append one closed request trace (a `serving_trace` record of
        serving/tracing.py) to the bounded ring, and pass it through
        `record_step` so it rides the JSONL stream and the black box."""
        if not self.enabled:
            return
        record = dict(record)
        record.setdefault("kind", "serving_trace")
        with self._lock:
            self._traces.append(record)
        self.record_step(record)

    def request_traces(self) -> List[dict]:
        """The newest TRACE_RING_CAP closed request traces."""
        with self._lock:
            return list(self._traces)

    def record_exemplar(self, record: dict):
        """Keep a slow or bad request's trace (deadline miss, shed, error,
        rejected publish) in the exemplar ring the black box carries."""
        if not self.enabled:
            return
        with self._lock:
            self._exemplars.append(dict(record))

    def exemplars(self) -> List[dict]:
        with self._lock:
            return list(self._exemplars)

    # -- flight recorder ---------------------------------------------------
    def arm_flight_recorder(self, path: str, rank: int = 0) -> "Monitor":
        """Name the black-box destination (`BLACKBOX.p<rank>.json`).  Arming
        does not enable the monitor."""
        self._bb_path = str(path)
        self._bb_rank = int(rank)
        return self

    def flight_recorder_path(self) -> Optional[str]:
        return self._bb_path

    def blackbox_snapshot(self, reason: str = "manual") -> dict:
        """The flight-recorder rings as one JSON-able document: the last
        FLIGHT_RECORDER_CAP step records and span events, and the live
        counters and gauges."""
        with self._lock:
            steps = list(self._bb_steps)
            exemplars = list(self._exemplars)
            events = [{"name": n, "ts": ts, "dur_s": dur, "tid": tid, "depth": depth,
                       "args": ({k: str(v) for k, v in args.items()} if args else None)}
                      for (n, ts, dur, tid, depth, args) in self._bb_events]
        try:
            gauges = self.gauge_values()
        except Exception:
            gauges = {}
        return {"kind": "blackbox", "reason": str(reason), "rank": self._bb_rank,
                "pid": os.getpid(), "ts": time.time(), "lane": self.lane,
                "lane_name": self.lane_name, "steps": steps, "events": events,
                "exemplars": exemplars, "counters": self.counter_values(), "gauges": gauges}

    def dump_blackbox(self, reason: str = "manual", path: Optional[str] = None) -> Optional[str]:
        """Write the black box atomically (tmp + fsync + rename) and return
        its path; None when unarmed.  The first dump wins, so a cascade of
        failures keeps the first one's reason.  Never raises: it runs on
        crash paths."""
        with self._bb_dump_lock:
            if self._bb_dumped is not None:
                return self._bb_dumped
            p = path or self._bb_path
            if p is None:
                return None
            try:
                snap = self.blackbox_snapshot(reason)
                tmp = f"{p}.tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(snap, f, default=str)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, p)
                self._bb_dumped = p
                return p
            except Exception:
                return None

    # -- loggers -----------------------------------------------------------
    def attach_logger(self, logger):
        self._loggers.append(logger)
        return logger

    def detach_logger(self, logger):
        if logger in self._loggers:
            self._loggers.remove(logger)
        close = getattr(logger, "close", None)
        if callable(close):
            close()
