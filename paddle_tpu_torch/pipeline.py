"""Overlapped training loop (counterpart of paddle_tpu/pipeline.py):
feed staging, device compute and fetch run concurrently, K steps deep.

`Executor.run_async` enqueues a step on the card (a CUDA-graph replay, or
the eager ops) and returns lazy `FetchHandle`s at once, so Python
prepares and dispatches the NEXT step while the card runs this one;
`train_loop` below bounds how many dispatched-but-unresolved steps may be
in flight and copies fetches to the host only on logging steps -- the
others `wait()` on the step's CUDA event without a host copy.

Monitor: the `pipeline.inflight` gauge, the `pipeline.host_blocked` span
(time the host waited on the card: the overlap metric) and one
`kind="pipeline_step"` record per drained step.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import errors as _errors
from .monitor import MONITOR as _MON


@dataclass
class PipelineStats:
    """What `train_loop` hands back: per-logged-step fetch values plus the
    overlap accounting bench.py / perf tooling report."""

    steps: int = 0
    logged: List[Tuple[int, List[np.ndarray]]] = field(default_factory=list)
    wall_s: float = 0.0
    host_blocked_s: float = 0.0
    max_inflight_seen: int = 0

    @property
    def host_blocked_frac(self) -> float:
        """Fraction of wall time the host spent blocked on the device
        (resolving or waiting on handles).  A serial exe.run loop sits
        near 1.0 whenever the device step dominates; the pipelined loop's
        win is exactly how far below that it lands."""
        return self.host_blocked_s / self.wall_s if self.wall_s > 0 else 0.0


def train_loop(
    exe,
    program,
    loader: Iterable,
    fetch_list: Sequence,
    scope=None,
    max_inflight: int = 2,
    log_period: int = 1,
    on_logged: Optional[Callable[[int, List[np.ndarray]], Any]] = None,
    max_steps: Optional[int] = None,
    step_offset: int = 0,
    on_dispatch: Optional[Callable[[int, Dict], Any]] = None,
    resolve_all: bool = False,
) -> PipelineStats:
    """Drive a training program over `loader` with up to `max_inflight`
    steps dispatched ahead of resolution.

        stats = train_loop(exe, main, batches, [loss], scope=scope,
                           max_inflight=3, log_period=10)

    `loader` yields feed dicts (numpy arrays, or tensors already on the
    card).  Step N+1 is
    dispatched BEFORE step N's handles resolve; state write-back and RNG
    threading stay correct because the scope holds each step's output
    buffers, not the handles.  Every `log_period`-th step (step 0, then
    log_period, ...) is resolved to numpy and collected in
    `stats.logged` (or passed to `on_logged(step, values)`); other steps
    only `wait()` for device completion, skipping the host copy
    entirely.  `max_inflight` bounds the feeds and fetch tensors held in
    flight, so a deep pipeline cannot run the card out of memory.

    Note the skip trade-off: the FLAGS_check_nan_inf guard runs at
    resolution, so non-logged steps are not NaN-checked (a NaN in the
    params still surfaces at the next logged step's loss).  Passing
    `resolve_all=True` closes that window — every step pays the host
    copy + guard, which is what the resilience layer's NaN modes need to
    attribute a NaN to the exact step that produced it.

    Resilience hooks: `step_offset` shifts step numbering (logging phase,
    records, error context) so a restarted segment keeps GLOBAL step
    indices; `on_dispatch(step, feed)` runs just before each dispatch
    (snapshot/checkpoint/fault-injection point — an exception it raises
    aborts the loop like any other).  Whenever the loop exits abnormally,
    still-in-flight steps are waited on and discarded before the error
    propagates, so abandoned handles never keep device buffers pinned;
    errors raised while draining carry their step index
    (`errors.get_context`)."""
    if not fetch_list:
        raise ValueError("train_loop needs a non-empty fetch_list (the "
                         "handles are also the pipeline's backpressure)")
    if max_inflight < 1:
        raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    if log_period < 1:
        raise ValueError(f"log_period must be >= 1, got {log_period}")

    stats = PipelineStats()
    inflight: deque = deque()  # (step index, [FetchHandle, ...])
    gauge = _MON.gauge("pipeline.inflight")
    t_wall0 = time.perf_counter()
    last_drain_t = t_wall0

    def drain_one():
        nonlocal last_drain_t
        step_i, handles = inflight.popleft()
        gauge.set(len(inflight))
        want_log = step_i % log_period == 0
        must_resolve = want_log or resolve_all
        t_b0 = time.perf_counter()
        with _MON.span("pipeline.host_blocked", step=step_i, logged=want_log):
            try:
                if must_resolve:
                    vals = [h.numpy() for h in handles]
                else:
                    handles[0].wait()  # all handles share one pending dispatch
            except BaseException as e:
                # a resolution failure (sticky NaN guard, a CUDA error)
                # belongs to THIS step; recovery rewinds to it
                raise _errors.attach_context(e, step=step_i)
        now = time.perf_counter()
        stats.host_blocked_s += now - t_b0
        if _MON.enabled:
            # per-step wall time of the async path
            _MON.gauge("pipeline.last_step_wall_s").set(now - last_drain_t)
            _MON.record_step({
                "kind": "pipeline_step",
                "pipeline_step": step_i,
                "t_host_blocked_s": now - t_b0,
                "t_step_wall_s": now - last_drain_t,
                "inflight": len(inflight),
                "logged": want_log,
            })
        last_drain_t = now
        if want_log:
            if on_logged is not None:
                on_logged(step_i, vals)
            else:
                stats.logged.append((step_i, vals))

    it = iter(loader)
    try:
        while max_steps is None or stats.steps < max_steps:
            # bound checked BEFORE pulling: a shared/resumable loader must
            # not lose a batch the loop will never dispatch
            try:
                feed = next(it)
            except StopIteration:
                break
            while len(inflight) >= max_inflight:
                drain_one()
            step_i = step_offset + stats.steps
            try:
                if on_dispatch is not None:
                    on_dispatch(step_i, feed)
                handles = exe.run_async(program, feed=feed,
                                        fetch_list=fetch_list, scope=scope)
            except BaseException as e:
                # a synchronous dispatch failure (hook, compile/enqueue
                # path) belongs to this step — but OLDER steps still in
                # flight have unresolved guards (sticky NaN check).
                # Drain them FIRST: if one fails,
                # ITS error propagates and supersedes this one, because
                # recovery must rewind to the OLDEST failure — keying
                # recovery on the newer step would restore a snapshot
                # that already embeds the older step's unguarded update
                # and silently commit it.
                err = _errors.attach_context(e, step=step_i)
                while inflight:
                    drain_one()
                raise err
            inflight.append((step_i, handles))
            stats.steps += 1
            stats.max_inflight_seen = max(stats.max_inflight_seen,
                                          len(inflight))
            gauge.set(len(inflight))
        while inflight:
            drain_one()
    finally:
        # abnormal exit: the remaining in-flight handles would otherwise
        # be abandoned still pinning device buffers (a whole batch and
        # its fetches each).  wait() for execution and discard — values
        # already landed in the scope at dispatch; resolution errors here
        # are secondary to the one propagating.
        while inflight:
            _, handles = inflight.popleft()
            try:
                handles[0].wait()
            except Exception:
                pass
        gauge.set(0)
    stats.wall_s = time.perf_counter() - t_wall0
    return stats
