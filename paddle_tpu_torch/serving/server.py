"""The serving runtime: a bounded request queue drained into continuous
batches (counterpart of paddle_tpu/serving/server.py).

`Server` stands between callers and the registry's predictors:

  * admission control: the queue is bounded (`max_queue`, default
    FLAGS_serving_max_queue).  A submit past the bound is shed at once
    with ServingError(reason="overload") and counted (`serving.shed`), so
    under overload the queue wait stays bounded.

  * deadlines: `submit(deadline_ms=...)` (default
    FLAGS_serving_default_deadline_ms; 0 = none).  A request still queued
    when its deadline passes ends with ServingError(reason="timeout") at
    batch-build time and its batch goes on without it; a request picked
    in time is served to the end (a graph replay is not cancellable).

  * continuous batching: worker threads drain the FIFO, coalesce requests
    of one model up to the largest bucket, pad to the next bucket
    (batcher.py), run one predictor call and split the outputs back.  The
    registry warmed every bucket into a CUDA graph at load, so a novel
    request size builds no plan and captures no graph: on the card
    `executor.graph_capture` and `executor.cache_miss` stay flat.

  * the exact ledger: `requests == completed + shed + timeouts + errors +
    shutdowns` at rest (`ledger()`; `rejected` counts the door's refusals,
    which never enter `requests`), kept whether the monitor is on or not.

  * observability through the monitor: the serving.* counters, the lazy
    gauges (`serving.queue_depth`, `serving.p50_ms`, `serving.p99_ms`,
    `serving.queue_wait_frac`, `serving.slo_good_frac`,
    `serving.slo_burn_rate`, `serving.bucket[N].pad_frac`), one
    `serving_batch` record a batch and one `serving_event` a shed, timeout
    or reload; with the monitor on, a request trace a request
    (tracing.py) closed with the reason code of its outcome, and
    exemplars of the slow or bad ones in the black box.
"""
from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np

from ..core import locks
from ..errors import ServingError, classify
from ..flags import flag as _flag
from ..monitor import MONITOR as _MON
from . import batcher as _bk
from . import publisher as _pub
from . import tracing as _tr
from .registry import ModelRegistry

__all__ = ["Future", "Server"]


class Future:
    """Completion handle for one submitted request."""

    __slots__ = ("_ev", "_result", "_exc", "t_enqueue")

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc = None
        self.t_enqueue = time.monotonic()

    def done(self) -> bool:
        return self._ev.is_set()

    def set_result(self, result):
        if not self._ev.is_set():  # first completion wins
            self._result = result
            self._ev.set()

    def set_exception(self, exc: BaseException):
        if not self._ev.is_set():
            self._exc = exc
            self._ev.set()

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        if not self._ev.wait(timeout):
            raise TimeoutError("serving Future.result: not done yet")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None):
        self._ev.wait(timeout)
        return self._exc


class _Request:
    __slots__ = ("model", "feeds", "rows", "deadline", "future", "trace",
                 "t_dequeue")

    def __init__(self, model, feeds, rows, deadline, future,
                 trace=_tr.NULL_TRACE):
        self.model = model
        self.feeds = feeds
        self.rows = rows
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.future = future
        self.trace = trace        # NULL_TRACE when the monitor is off
        self.t_dequeue = 0.0      # monotonic at batch pick (queue end)


class Server:
    """Continuous-batching model server over a `ModelRegistry`.

        registry = serving.ModelRegistry()          # CUDAPlace(0)
        with serving.Server(registry, buckets=(1, 4, 8)) as srv:
            srv.load_model("m", "/models/m")           # graphs every bucket
            out = srv.infer("m", {"x": batch})          # sync
            fut = srv.submit("m", {"x": batch}, deadline_ms=50)
            srv.publish("m", ckpt_manager)              # verified hot reload
    """

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 buckets=None, max_queue: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 workers: int = 1, start: bool = True):
        self.registry = registry if registry is not None else ModelRegistry()
        self.buckets = _bk.parse_buckets(buckets)
        self.max_queue = int(max_queue if max_queue is not None
                             else _flag("FLAGS_serving_max_queue"))
        if default_deadline_ms is None:
            default_deadline_ms = _flag("FLAGS_serving_default_deadline_ms")
        self.default_deadline_ms = float(default_deadline_ms or 0.0)
        # SLO target: the fraction of SLO-tracked requests that must be
        # good; burn rate = bad_frac / (1 - target), so 1.0 means the run
        # is burning its error budget exactly as fast as the SLO allows
        self.slo_target = min(max(
            float(_flag("FLAGS_serving_slo_target") or 0.0), 0.0), 0.9999)
        self._n_workers = max(int(workers), 1)
        self._q: collections.deque = collections.deque()
        self._cv = locks.named_condition("serving.server", rank=12)
        self._threads: List[threading.Thread] = []
        self._running = False
        # accepting from construction: a not-yet-started server queues
        # (admission control still applies); workers drain once start()
        # runs.  stop() is what closes the door.
        self._accepting = True
        self._inflight = 0
        # server-local exact ledger (monitor counters mirror it when the
        # monitor is enabled; admission accounting must not depend on that)
        # ledger identity (at rest): requests == completed + shed +
        # timeouts + errors + shutdowns (`rejected` counts the
        # admission-door refusals that never enter `requests`; slo_good +
        # slo_bad covers every SLO-tracked terminal outcome)
        self._stats = {"requests": 0, "completed": 0, "shed": 0,
                       "timeouts": 0, "errors": 0, "shutdowns": 0,
                       "rejected": 0, "slo_good": 0, "slo_bad": 0,
                       "batches": 0, "rows": 0, "padded_rows": 0}
        self._lat_ms: collections.deque = collections.deque(maxlen=4096)
        # windowed SLO / queue-wait attribution (same sliding-window role
        # as _lat_ms): good/bad flags and (queue_s, total_s) samples
        self._slo_window: collections.deque = collections.deque(maxlen=4096)
        self._qwin: collections.deque = collections.deque(maxlen=4096)
        # per-bucket attribution ledger: bucket -> batches/requests/rows/
        # pad_rows/queue_s/total_s/infer_s (exact, unconditional; the
        # pad_frac gauges and bucket_attribution read it)
        self._bucket_attr: Dict[int, dict] = {}
        # gauges close over a WEAK ref (the global monitor must not keep a
        # dead server — queue, latency window, registry — alive forever)
        # and are released by stop() if still ours; gauge names are
        # process-global, so with several servers the newest owner wins
        w = weakref.ref(self)
        self._gauge_fns = {
            "serving.queue_depth":
                lambda: (lambda s: float(len(s._q)) if s else 0.0)(w()),
            "serving.p50_ms":
                lambda: (lambda s: s._pct(50.0) if s else 0.0)(w()),
            "serving.p99_ms":
                lambda: (lambda s: s._pct(99.0) if s else 0.0)(w()),
            "serving.queue_wait_frac":
                lambda: (lambda s: s._queue_wait_frac_win() if s else 0.0)(w()),
            "serving.slo_good_frac":
                lambda: (lambda s: s._slo_good_frac() if s else 1.0)(w()),
            "serving.slo_burn_rate":
                lambda: (lambda s: s._slo_burn_rate() if s else 0.0)(w()),
        }
        # the bucket ladder is fixed at construction, so the per-bucket
        # pad-waste gauges can register up front
        for b in self.buckets:
            self._gauge_fns[f"serving.bucket[{b}].pad_frac"] = (
                lambda bb=b: (lambda s: s._bucket_pad_frac(bb)
                              if s else 0.0)(w()))
        for n, f in self._gauge_fns.items():
            _MON.gauge(n).set_fn(f)
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        with self._cv:
            if self._running:
                return self
            self._running = True
            self._accepting = True
        for i in range(self._n_workers):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"serving-worker-{i}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop accepting; with `drain` (default) serve out everything
        already admitted first.  Requests still queued at a drain-less
        stop fail with reason="shutdown"."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._accepting = False
            if drain and self._threads:  # no workers -> nothing can drain
                while (self._q or self._inflight) and \
                        time.monotonic() < deadline:
                    self._cv.wait(0.05)
            self._running = False
            self._cv.notify_all()
            leftovers = list(self._q)
            self._q.clear()
        for r in leftovers:
            # the leftover died still queued: its open phase IS the queue
            self._finish_trace(r.trace, "shutdown", reason="shutdown",
                               final="queue")
            r.future.set_exception(ServingError(
                "server stopped before this request was served",
                reason="shutdown", model=r.model,
                trace_id=r.trace.trace_id))
        if leftovers:
            with self._cv:
                self._stats["shutdowns"] += len(leftovers)
                self._stats["slo_bad"] += len(leftovers)
                self._slo_window.extend(0.0 for _ in leftovers)
            _MON.counter("serving.shutdowns").inc(len(leftovers))
            _MON.counter("serving.slo_bad").inc(len(leftovers))
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        for n, f in self._gauge_fns.items():
            g = _MON.gauge(n)
            if g.fn is f:  # release only if a newer server hasn't taken over
                g.fn = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- model management (delegates) --------------------------------------
    def load_model(self, name: str, model_dir: str, config=None,
                   warm: bool = True):
        """Registry load; `warm` (default) graphs every serving bucket up
        front, so the first requests replay."""
        return self.registry.load(
            name, model_dir, config=config,
            warm_buckets=self.buckets if warm else None)

    def publish(self, name: str, src, warm: bool = True, **kw):
        """Verified hot reload (publisher.publish): staged verification,
        the pre-swap bucket warm, an atomic swap, the old version kept."""
        kw.setdefault("warm_buckets", self.buckets if warm else ())
        return _pub.publish(self.registry, name, src, **kw)

    def rollback(self, name: str):
        return self.registry.rollback(name)

    # -- request path ------------------------------------------------------
    @staticmethod
    def _finish_trace(tr, outcome, reason=None, final=None, exemplar=False,
                      **annot):
        """Close a request's trace (idempotent — first close wins) and
        record it; `exemplar` additionally retains it in the black box's
        slow/bad-request ring.  No-op end to end on NULL_TRACE."""
        rec = tr.close(outcome, reason=reason, final=final, **annot)
        if rec is not None:
            _MON.record_trace(rec)
            if exemplar:
                _MON.record_exemplar(rec)
        return rec

    def submit(self, model: str, feeds: Dict[str, np.ndarray],
               deadline_ms: Optional[float] = None) -> Future:
        """Admit one request (all feeds batched on axis 0) or shed it.
        Sheds raise immediately — an overloaded server answers 'no' in
        O(1), it does not answer late.  Malformed requests (unknown
        model, wrong feed names/shapes, oversize) are rejected HERE so
        they can never poison the batch they would be coalesced into.
        Every terminal outcome — including the rejections this door
        raises — closes the request's trace with its reason code, and
        the raised ServingError carries the trace id."""
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        tr = _tr.maybe_trace(_MON, model,
                             deadline_ms=float(deadline_ms or 0.0) or None)
        try:
            version = self.registry.acquire(model)  # model_missing: the door
            rows = _bk.batch_rows(feeds)
            _bk.bucket_for(rows, self.buckets)  # oversize rejects at the door
            _bk.validate_feeds(feeds, version.feed_names,
                               version.program.global_block())
        except ServingError as e:
            e.trace_id = tr.trace_id
            self._finish_trace(tr, "rejected", reason=e.reason,
                               final="admission")
            with self._cv:
                self._stats["rejected"] += 1
            _MON.counter("serving.rejected").inc()
            raise
        tr.annotate(rows=rows)
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms and deadline_ms > 0 else None)
        fut = Future()
        req = _Request(model, feeds, rows, deadline, fut, tr)
        with self._cv:
            if not self._accepting:
                self._stats["rejected"] += 1
                _MON.counter("serving.rejected").inc()
                self._finish_trace(tr, "rejected", reason="shutdown",
                                   final="admission")
                raise ServingError("server is not accepting requests",
                                   reason="shutdown", model=model,
                                   trace_id=tr.trace_id)
            self._stats["requests"] += 1
            if len(self._q) >= self.max_queue:
                self._stats["shed"] += 1
                self._stats["slo_bad"] += 1
                self._slo_window.append(0.0)
                _MON.counter("serving.requests").inc()
                _MON.counter("serving.shed").inc()
                _MON.counter("serving.slo_bad").inc()
                _MON.record_step({"kind": "serving_event", "action": "shed",
                                  "model": model, "rows": rows,
                                  "queue_depth": len(self._q),
                                  "trace_id": tr.trace_id})
                self._finish_trace(tr, "shed", reason="overload",
                                   final="admission", exemplar=True,
                                   queue_depth=len(self._q))
                raise ServingError(
                    f"queue depth {len(self._q)} at the admission bound "
                    f"({self.max_queue}); request shed", reason="overload",
                    model=model, trace_id=tr.trace_id)
            tr.phase("admission")
            self._q.append(req)
            _MON.counter("serving.requests").inc()
            self._cv.notify()
        return fut

    def infer(self, model: str, feeds: Dict[str, np.ndarray],
              deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous submit + wait."""
        return self.submit(model, feeds, deadline_ms).result(timeout)

    # -- worker ------------------------------------------------------------
    def _take_batch(self):
        """Under the lock: wait for work, then pick a same-model batch
        (FIFO head defines the model; batcher.coalesce fills up to the
        largest bucket)."""
        with self._cv:
            while self._running and not self._q:
                self._cv.wait(0.05)
            if not self._q:
                return None
            model, picked = _bk.coalesce(self._q, self.buckets[-1])
            now = time.monotonic()
            tq = time.perf_counter()  # one shared queue-end boundary
            for r in picked:
                self._q.remove(r)
                r.t_dequeue = now
                r.trace.phase("queue", t=tq)
            self._inflight += 1
            return model, picked

    def _expire(self, picked):
        """Split expired-vs-live at batch-build time; expired requests are
        cancelled (classified timeout) and the batch proceeds without
        them."""
        now = time.monotonic()
        live = []
        for r in picked:
            if r.deadline is not None and now > r.deadline:
                late_ms = round((now - r.deadline) * 1e3, 3)
                with self._cv:  # the ledger is exact even with N workers
                    self._stats["timeouts"] += 1
                    self._stats["slo_bad"] += 1
                    self._slo_window.append(0.0)
                _MON.counter("serving.timeouts").inc()
                _MON.counter("serving.slo_bad").inc()
                _MON.record_step({"kind": "serving_event",
                                  "action": "timeout", "model": r.model,
                                  "rows": r.rows, "late_ms": late_ms,
                                  "trace_id": r.trace.trace_id})
                self._finish_trace(r.trace, "timeout", reason="timeout",
                                   final="batch_build", exemplar=True,
                                   late_ms=late_ms)
                r.future.set_exception(ServingError(
                    f"deadline expired {round((now - r.deadline) * 1e3, 1)} ms "
                    f"before the request reached a batch", reason="timeout",
                    model=r.model, trace_id=r.trace.trace_id))
            else:
                live.append(r)
        return live

    def _worker_loop(self):
        while True:
            taken = self._take_batch()
            if taken is None:
                return
            model, picked = taken
            try:
                self._run_batch(model, picked)
            except BaseException as e:  # noqa: BLE001
                # a worker must survive ANYTHING (a logger's disk-full
                # OSError in record_step, a result-splitting bug): a dead
                # worker strands every future it picked and — at
                # workers=1 — wedges the whole server.  Fail the batch's
                # unresolved futures classified and keep serving.
                ce = classify(e)
                reason = getattr(ce, "reason", None) or type(ce).__name__
                n = sum(1 for r in picked if not r.future.done())
                for r in picked:
                    if not r.future.done():
                        self._finish_trace(r.trace, "error", reason=reason,
                                           final="error", exemplar=True)
                    r.future.set_exception(ce)
                if n:
                    with self._cv:
                        self._stats["errors"] += n
                        self._stats["slo_bad"] += n
                        self._slo_window.extend(0.0 for _ in range(n))
                    _MON.counter("serving.errors").inc(n)
                    _MON.counter("serving.slo_bad").inc(n)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _run_batch(self, model: str, picked):
        live = self._expire(picked)
        if not live:
            return
        t0p = time.perf_counter()
        try:
            # hold ONCE per batch: a publish() swapping, an unload or an
            # eviction mid-batch never touches us — this version and its
            # plans stay until we finish
            with self.registry.hold(model) as version:
                padded, rows, bucket, pad_rows = _bk.build_batch(
                    live, self.buckets)
                tb = time.perf_counter()  # batch built (shared phase boundary)
                for r in live:
                    r.trace.phase("batch_build", t=tb)
                    r.trace.annotate(bucket=bucket, pad_rows=pad_rows,
                                     batch_rows=rows)
                with _MON.span("serving.batch", model=model, bucket=bucket,
                               rows=rows, pad_rows=pad_rows):
                    outs = version.run(padded)
            td = time.perf_counter()  # device done (dispatch+run+fetch of
            # the synchronous predictor fold into this one phase: upload,
            # replay and the pinned host copy)
        except BaseException as e:
            ce = classify(e)
            reason = getattr(ce, "reason", None) or type(ce).__name__
            with self._cv:
                self._stats["errors"] += len(live)
                self._stats["slo_bad"] += len(live)
                self._slo_window.extend(0.0 for _ in live)
            _MON.counter("serving.errors").inc(len(live))
            _MON.counter("serving.slo_bad").inc(len(live))
            for r in live:
                self._finish_trace(r.trace, "error", reason=reason,
                                   final="error", exemplar=True)
                r.future.set_exception(ce)
            return
        offsets, at = [], 0
        for r in live:
            offsets.append((at, at + r.rows))
            at += r.rows
        per_req = _bk.split_rows(outs, offsets, bucket)
        tf = time.perf_counter()  # host-side result split done
        now = time.monotonic()
        lat_max = queue_ms_max = 0.0
        queue_s_sum = total_s_sum = 0.0
        good_flags, qwin_items, trace_recs = [], [], []
        for r, vals in zip(live, per_req):
            r.trace.phase("device", t=td)
            r.trace.phase("fetch", t=tf)
            r.future.set_result(vals)
            lat = (now - r.future.t_enqueue) * 1e3
            lat_max = max(lat_max, lat)
            self._lat_ms.append(lat)
            q_s = max(r.t_dequeue - r.future.t_enqueue, 0.0)
            tot_s = max(now - r.future.t_enqueue, 1e-9)
            queue_s_sum += q_s
            total_s_sum += tot_s
            queue_ms_max = max(queue_ms_max, q_s * 1e3)
            qwin_items.append((q_s, tot_s))
            # SLO accounting: a request with no deadline is good by
            # completing at all; one with a deadline must make it — a
            # picked-in-time request that finished LATE burns budget too
            good = r.deadline is None or now <= r.deadline
            good_flags.append(good)
            rec = r.trace.close("completed", lat_ms=round(lat, 3),
                                queue_ms=round(q_s * 1e3, 3),
                                slo_miss=not good)
            if rec is not None:
                trace_recs.append((rec, not good))
        good_n = sum(good_flags)
        t_build_s = tb - t0p
        t_infer_s = td - tb
        t_fetch_s = tf - td
        with self._cv:
            self._stats["completed"] += len(live)
            self._stats["batches"] += 1
            self._stats["rows"] += rows
            self._stats["padded_rows"] += pad_rows
            self._stats["slo_good"] += good_n
            self._stats["slo_bad"] += len(live) - good_n
            self._slo_window.extend(1.0 if g else 0.0 for g in good_flags)
            self._qwin.extend(qwin_items)
            a = self._bucket_attr.setdefault(
                bucket, {"batches": 0, "requests": 0, "rows": 0,
                         "pad_rows": 0, "queue_s": 0.0, "total_s": 0.0,
                         "infer_s": 0.0})
            a["batches"] += 1
            a["requests"] += len(live)
            a["rows"] += rows
            a["pad_rows"] += pad_rows
            a["queue_s"] += queue_s_sum
            a["total_s"] += total_s_sum
            a["infer_s"] += t_infer_s
        _MON.counter("serving.completed").inc(len(live))
        _MON.counter("serving.batches").inc()
        _MON.counter("serving.rows").inc(rows)
        _MON.counter("serving.padded_rows").inc(pad_rows)
        # `serving.pad_rows` is the pad-waste counter; `padded_rows` is its
        # older name, kept as the JAX package keeps it
        _MON.counter("serving.pad_rows").inc(pad_rows)
        _MON.counter("serving.slo_good").inc(good_n)
        if len(live) - good_n:
            _MON.counter("serving.slo_bad").inc(len(live) - good_n)
        occupancy = rows / bucket
        _MON.observe(f"serving.bucket[{bucket}].occupancy", occupancy)
        for rec, slo_miss in trace_recs:
            _MON.record_trace(rec)
            if slo_miss:  # completed, but late: an SLO-burn exemplar
                _MON.record_exemplar(rec)
        record = {
            "kind": "serving_batch", "model": model, "bucket": bucket,
            "rows": rows, "requests": len(live),
            "pad_rows": pad_rows, "pad_frac": round(pad_rows / bucket, 4),
            "occupancy": round(occupancy, 4),
            "t_build_s": round(t_build_s, 6),
            "t_infer_s": round(t_infer_s, 6),
            "t_fetch_s": round(t_fetch_s, 6),
            "queue_ms_mean": round(queue_s_sum * 1e3 / len(live), 3),
            "queue_ms_max": round(queue_ms_max, 3),
            "queue_wait_frac": round(queue_s_sum / total_s_sum, 4)
            if total_s_sum > 0 else 0.0,
            "lat_ms_max": round(lat_max, 3),
            "queue_depth": len(self._q)}
        if live[0].trace.enabled:
            record["trace_ids"] = [r.trace.trace_id for r in live[:32]]
        _MON.record_step(record)

    # -- stats -------------------------------------------------------------
    def _pct(self, q: float) -> float:
        lat = list(self._lat_ms)
        if not lat:
            return 0.0
        return float(np.percentile(np.asarray(lat), q))

    def _slo_good_frac(self) -> float:
        win = list(self._slo_window)
        return (sum(win) / len(win)) if win else 1.0

    def _slo_burn_rate(self) -> float:
        denom = 1.0 - self.slo_target
        if denom <= 0:
            return 0.0
        return (1.0 - self._slo_good_frac()) / denom

    def _queue_wait_frac_win(self) -> float:
        win = list(self._qwin)
        tot = sum(t for _, t in win)
        return (sum(q for q, _ in win) / tot) if tot > 0 else 0.0

    def _bucket_pad_frac(self, bucket: int) -> float:
        a = self._bucket_attr.get(bucket)
        if not a:
            return 0.0
        denom = a["rows"] + a["pad_rows"]
        return a["pad_rows"] / denom if denom else 0.0

    def queue_wait_frac(self) -> float:
        """Lifetime queue-wait fraction: of all the wall time completed
        requests spent in the server, the share spent QUEUED (the
        gauge's sliding-window cousin)."""
        with self._cv:
            q = sum(a["queue_s"] for a in self._bucket_attr.values())
            t = sum(a["total_s"] for a in self._bucket_attr.values())
        return q / t if t > 0 else 0.0

    def bucket_attribution(self) -> Dict[int, dict]:
        """Per-bucket latency/pad attribution from the exact server-local
        ledger: where each bucket's wall time went (queued vs on device)
        and how much of its compute was pad waste."""
        with self._cv:
            attr = {b: dict(a) for b, a in self._bucket_attr.items()}
        out = {}
        for b, a in sorted(attr.items()):
            denom = a["rows"] + a["pad_rows"]
            out[b] = {
                "batches": a["batches"], "requests": a["requests"],
                "rows": a["rows"], "pad_rows": a["pad_rows"],
                "pad_frac": round(a["pad_rows"] / denom, 4) if denom else 0.0,
                "occupancy": round(a["rows"] / denom, 4) if denom else 0.0,
                "queue_ms_mean": round(
                    a["queue_s"] * 1e3 / max(a["requests"], 1), 3),
                "infer_ms_mean": round(
                    a["infer_s"] * 1e3 / max(a["batches"], 1), 3),
                "queue_wait_frac": round(a["queue_s"] / a["total_s"], 4)
                if a["total_s"] > 0 else 0.0,
            }
        return out

    def latency_ms(self) -> Dict[str, float]:
        return {"p50": round(self._pct(50.0), 3),
                "p99": round(self._pct(99.0), 3),
                "samples": len(self._lat_ms)}

    def ledger(self) -> dict:
        """The exact request ledger and its at-rest identity verdict.  `requests ==
        completed + shed + timeouts + errors + shutdowns` holds whenever
        no request is in flight (`rejected` counts admission-door
        refusals that never enter `requests`); `balanced` evaluates it
        so callers need not re-derive the identity."""
        with self._cv:
            s = dict(self._stats)
        out = {k: s[k] for k in ("requests", "completed", "shed",
                                 "timeouts", "errors", "shutdowns",
                                 "rejected")}
        out["balanced"] = (
            out["requests"] == out["completed"] + out["shed"]
            + out["timeouts"] + out["errors"] + out["shutdowns"])
        return out

    def stats(self) -> dict:
        with self._cv:
            s = dict(self._stats)
        s["queue_depth"] = len(self._q)
        s["pad_rows"] = s["padded_rows"]  # the documented alias
        s["queue_wait_frac"] = round(self.queue_wait_frac(), 4)
        s["slo"] = {"target": self.slo_target,
                    "good": s["slo_good"], "bad": s["slo_bad"],
                    "good_frac": round(self._slo_good_frac(), 4),
                    "burn_rate": round(self._slo_burn_rate(), 4)}
        s.update({f"lat_{k}_ms" if k != "samples" else "lat_samples": v
                  for k, v in self.latency_ms().items()})
        s["models"] = self.registry.models()
        return s
