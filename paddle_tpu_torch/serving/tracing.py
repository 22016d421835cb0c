"""Per-request flight tracing of the serving runtime (counterpart of
paddle_tpu/serving/tracing.py).

Every `Server.submit` takes a `RequestTrace`: a trace id and the spans of
the request's flight,

    admission -> queue -> batch_build -> device -> fetch -> respond

(`batch_build` carries the pad attribution: the bucket the batch padded
to and its pad rows; `device` is the predictor call, which on the card
folds the feed upload, the graph replay and the pinned host copy into one
phase; `fetch` is the host-side split of the results).  A request that
never completes still gets a closed trace: shed, timeout, error, shutdown
and the door's rejections close it with the reason code the raised
`ServingError` carries, so `requests == completed + shed + timeouts +
errors + shutdowns` holds in the trace stream as in the server's ledger
(`tools/serve_trace.py --check` reads it).

With the monitor disabled `maybe_trace` is one attribute load and a branch
returning the shared `NULL_TRACE`, whose methods do nothing.  Enabled, a
trace is a few `perf_counter` marks and one `Monitor.record_trace` at its
close.  Publish and rollback get control ids (`control_trace_id`) on the
same timeline as the requests they raced.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional

__all__ = ["RequestTrace", "NULL_TRACE", "maybe_trace", "control_trace_id",
           "TRACE_PHASES"]

# canonical phase order of a completed request's span tree
TRACE_PHASES = ("admission", "queue", "batch_build", "device", "fetch",
                "respond")

# terminal outcomes a closed trace may carry; "rejected" covers the
# admission-door refusals (bad_request / oversize / model_missing) that
# never enter the server's `requests` ledger
TERMINAL_OUTCOMES = ("completed", "shed", "timeout", "error", "shutdown",
                     "rejected")

_ids = itertools.count(1)          # next() is atomic under the GIL
_ctl_ids = itertools.count(1)


def control_trace_id(prefix: str) -> str:
    """Trace id for a control-plane action (publish/rollback) so reload
    episodes are addressable in `serve_trace --request` next to the
    requests they raced."""
    return f"{prefix}-{next(_ctl_ids):04d}"


class _NullTrace:
    """Shared do-nothing trace returned while the monitor is disabled —
    the disabled serving hot path must not allocate per request."""

    __slots__ = ()
    enabled = False
    trace_id = None

    def phase(self, name, t=None):
        return self

    def annotate(self, **kw):
        return self

    def close(self, outcome, reason=None, final=None, **annot):
        return None


NULL_TRACE = _NullTrace()


def maybe_trace(mon, model: str, rows=None,
                deadline_ms: Optional[float] = None):
    """The submit-door entry point: `NULL_TRACE` (no allocation) when the
    monitor is disabled, a live `RequestTrace` when it is on."""
    if not mon.enabled:
        return NULL_TRACE
    return RequestTrace(model, rows=rows, deadline_ms=deadline_ms)


class RequestTrace:
    """One request's span tree, built from phase BOUNDARIES: the trace
    opens at submit (wall `ts` + perf_counter `t0`); each `phase(name)`
    closes the currently-open phase under that name; `close(outcome)`
    seals the final phase and renders the record.  First close wins —
    the worker-loop catch-all may try to error-close a request a
    deadline already cancelled."""

    __slots__ = ("trace_id", "model", "rows", "deadline_ms", "ts", "t0",
                 "marks", "args", "outcome", "reason")

    enabled = True

    def __init__(self, model: str, rows=None,
                 deadline_ms: Optional[float] = None):
        self.trace_id = f"r{next(_ids):06d}"
        self.model = model
        self.rows = rows
        self.deadline_ms = deadline_ms
        self.ts = time.time()
        self.t0 = time.perf_counter()
        self.marks = []          # [(phase_name, perf_counter_at_end), ...]
        self.args = {}
        self.outcome = None      # set exactly once, by close()
        self.reason = None

    def phase(self, name: str, t: Optional[float] = None):
        """Close the currently-open phase as `name` (ended now, or at the
        shared timestamp `t` a batch-level boundary passes to every
        member request)."""
        if self.outcome is None:
            self.marks.append((name, time.perf_counter() if t is None
                               else t))
        return self

    def annotate(self, **kw):
        self.args.update(kw)
        return self

    def close(self, outcome: str, reason: Optional[str] = None,
              final: Optional[str] = None, **annot):
        """Seal the trace: record the final phase (`final`, default
        "respond"), stamp outcome + stable reason code, and return the
        JSON-able `serving_trace` record (None on a repeat close)."""
        if self.outcome is not None:
            return None
        self.marks.append((final or "respond", time.perf_counter()))
        self.outcome = outcome
        self.reason = reason
        if annot:
            self.args.update(annot)
        return self._record()

    def _record(self) -> dict:
        spans, prev = [], self.t0
        for name, t in self.marks:
            spans.append({"name": name,
                          "t_ms": round((prev - self.t0) * 1e3, 4),
                          "dur_ms": round(max(t - prev, 0.0) * 1e3, 4)})
            prev = t
        total_ms = round((prev - self.t0) * 1e3, 4)
        rec = {"kind": "serving_trace", "trace_id": self.trace_id,
               "model": self.model, "rows": self.rows,
               "outcome": self.outcome, "ts": self.ts,
               "total_ms": total_ms, "spans": spans}
        if self.reason is not None:
            rec["reason"] = self.reason
        if self.deadline_ms:
            rec["deadline_ms"] = self.deadline_ms
        rec.update(self.args)
        return rec
