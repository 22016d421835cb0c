"""Fault-tolerant training: RetryPolicy + resilient_train_loop (counterpart
of paddle_tpu/resilience.py, one device).

Composes `CheckpointManager` (atomic snapshots, deferred SIGTERM flush),
`Executor.run_async` (sticky in-flight errors), `pipeline.train_loop`
(bounded overlap) and the monitor into one loop that survives the failure
classes of errors.py:

    DataError             drop the batch and pull the next, within
                          `RetryPolicy.max_bad_batches`
    NumericError          `nan_mode`: "raise" (default), "skip_step"
                          (undo the poisoned update, drop that batch,
                          continue), or "rollback" (restore the last
                          checkpoint at or before the failure and replay)
    TransientDeviceError  seeded-jitter exponential backoff + retry the
                          same step; RESOURCE_EXHAUSTED (the card's
                          allocator out of memory) also halves the
                          in-flight depth
    PreemptionError       flush one checkpoint with resume info and
                          return gracefully (`stats.preempted`)
    StorageError          handled inside CheckpointManager.save (retry,
                          fallback dir, degraded mode); the loop sees only
                          the terminal lag-bound conversion
    IntegrityError        restore the newest committed checkpoint at or
                          before the verdict's `safe_step`
    anything else         re-raised untouched

Correctness under async dispatch: `run_async` hands the scope a step's
state at dispatch, so when a failure surfaces at the resolution of step
K, steps K+1..K+m have already been enqueued on poisoned state.  Recovery
restores the state at the dispatch boundary of step K -- a snapshot the
`on_dispatch` hook took (skip_step / device retry; a window of
`max_inflight + 2` is kept) or a checkpoint (rollback / resume) -- and
re-feeds the affected batches from a bounded replay window, or from a
rebuilt loader when the caller passed a factory.

Snapshots are by value: each tensor of the scope is cloned on its device,
enqueued behind the steps dispatched so far (no host wait), and the
scope's generator is captured with `get_state()`.  A restore copies the
saved values into the tensors the scope holds and sets the generator's
state in place, so a plan's captured CUDA graph replays on the restored
state without a new capture.

Step numbering is global across recoveries: a skip_step run's parameters
are bit-identical to a fault-free run over the surviving batches, and a
rollback / resume run's to an uninterrupted run (the generator state
rides in snapshots and checkpoints).

Data-stream state: when the loader factory returns a source speaking the
stream-state protocol (reader.is_checkpointable), every checkpoint's
RESUME.json also carries the pickled state of its next batch, and
rollback / resume rewinds by an O(1) `load_state_dict` seek.  Stateless
sources keep the replay fast-forward, loud (`resilience.replay_fallback`
/ `resilience.replayed_batches` counters, a `replay_fast_forward` span and
event) and guarded: a replayed batch that differs from what the replay
window recorded raises.

Monitor surface: `resilience.skipped_batches / skipped_steps / retries /
rollbacks / degraded_inflight / preemptions` counters, `resilience.
snapshot / recover / backoff` spans, one `kind="resilience_event"` record
per recovery action.  A preemption's drain dumps the monitor's flight
recorder, where one is armed (reason "sigterm_drain").  The elastic resume
of a gang comes with ROADMAP A10.
"""
from __future__ import annotations

__all__ = ["RetryPolicy", "ResilienceStats", "resilient_train_loop",
           "RESUME_FILE", "resume_sidecar_name"]

import json
import logging
import os
import random
import signal as _signal
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field as _field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import errors as _errors
from . import io as _io
from . import pipeline as _pipeline
from .errors import (DataError, IntegrityError, NumericError,
                     PreemptionError, TrainingError, TransientDeviceError)
from .monitor import MONITOR as _MON

RESUME_FILE = "RESUME.json"

_log = logging.getLogger("paddle_tpu_torch.resilience")


def resume_sidecar_name(rank: int = 0, world_size: int = 1) -> str:
    """The RESUME sidecar's file name.  Coordinated checkpoints share one
    pending dir across ranks, and CheckpointManager requires rank-unique
    sidecar names — each rank's data-stream cursor is its own (sharded
    sources), so a fixed name would let the last writer clobber every
    other rank's stream state."""
    if world_size > 1:
        return f"RESUME.p{rank}.json"
    return RESUME_FILE


@dataclass
class RetryPolicy:
    """Per-class recovery budgets + seeded backoff.  Budgets are totals
    for one `resilient_train_loop` call; exhausting one re-raises the
    classified error.  Backoff is exponential with deterministic jitter
    (seeded, so chaos tests replay identical schedules)."""

    max_bad_batches: int = 8
    max_skipped_steps: int = 4
    max_rollbacks: int = 2
    max_device_retries: int = 3
    # transient-storage retries PER SAVE ROUND (CheckpointManager.save)
    # — exhausting them enters degraded mode rather than
    # re-raising, so this budget is per attempt sequence, not per run
    max_storage_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.1
    seed: int = 0

    def backoff_s(self, attempt: int) -> float:
        """Delay before retry number `attempt` (0-based)."""
        base = self.backoff_base_s * (self.backoff_factor ** attempt)
        if base <= 0:
            return 0.0
        r = random.Random(self.seed * 1_000_003 + attempt)
        return base * (1.0 + self.backoff_jitter * (2.0 * r.random() - 1.0))


@dataclass
class ResilienceStats:
    """What `resilient_train_loop` hands back: the PipelineStats-style
    aggregates plus the recovery ledger."""

    steps: int = 0
    logged: List[Tuple[int, List[np.ndarray]]] = _field(default_factory=list)
    wall_s: float = 0.0
    preempted: bool = False
    resume_step: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    skipped_batches: int = 0
    skipped_steps: int = 0
    retries: int = 0
    rollbacks: int = 0
    degraded_inflight: int = 0
    final_max_inflight: int = 0
    segments: int = 0
    publishes: int = 0
    publish_failures: int = 0


def _snapshot_value(v):
    """A copy of one scope value that later steps cannot touch."""
    from .core.selected_rows import SelectedRows

    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, torch.Generator):
        return ("generator", v.get_state())
    if isinstance(v, SelectedRows):
        return SelectedRows(v.rows.clone(), v.values.clone(), v.height)
    if isinstance(v, np.ndarray):
        return v.copy()
    return v  # non-array odds and ends: keep the reference


def _snapshot_scope(scope) -> Dict[str, Any]:
    """Every scope-local var by value: tensors cloned on their device (the
    clones are enqueued behind the steps dispatched so far, so a snapshot
    at a dispatch boundary is exactly the state after those steps, with no
    host wait), the generator by its state."""
    return {name: _snapshot_value(scope.find_var(name)) for name in scope.local_var_names()}


def _restore_scope(scope, snap: Dict[str, Any]):
    """Put a snapshot back.  A tensor goes into the tensor the scope holds
    when shape, dtype and device agree (a captured CUDA graph keeps
    reading it), the generator's state into the scope's generator; the
    snapshot itself stays untouched for a second restore."""
    for name, v in snap.items():
        cur = scope.find_var(name)
        if isinstance(v, tuple) and len(v) == 2 and v[0] == "generator":
            if isinstance(cur, torch.Generator):
                cur.set_state(v[1])
                continue
            raise RuntimeError(f"resilience: snapshot of {name!r} is a generator state but the "
                               f"scope holds {type(cur).__name__}")
        if isinstance(v, torch.Tensor):
            if (isinstance(cur, torch.Tensor) and cur.shape == v.shape and cur.dtype == v.dtype
                    and cur.device == v.device):
                cur.copy_(v)
            else:
                scope.set_var(name, v.clone())
            continue
        scope.set_var(name, _snapshot_value(v))


def _feeds_equal(a, b) -> bool:
    """Best-effort bit comparison of two feeds (dicts of arrays or tensors,
    tuples, bare arrays).  Uncomparable shapes answer True — the divergence
    guard must never false-positive on exotic feed types."""
    def same(x, y):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            y = y if isinstance(y, torch.Tensor) else torch.as_tensor(np.asarray(y))
            return x.shape == y.shape and x.dtype == y.dtype and bool(
                torch.equal(x.cpu(), y.cpu()))
        return bool(np.array_equal(np.asarray(x), np.asarray(y)))

    try:
        if isinstance(a, dict) or isinstance(b, dict):
            if not (isinstance(a, dict) and isinstance(b, dict)):
                return False
            if set(a) != set(b):
                return False
            return all(same(a[k], b[k]) for k in a)
        return same(a, b)
    except Exception:
        return True


def _as_iter(src):
    """A data source may be an iterable (DataLoader, list) or a
    decorator-style reader (zero-arg callable yielding items)."""
    if hasattr(src, "__iter__"):
        return iter(src)
    if callable(src):
        return iter(src())
    raise TypeError(f"resilience: cannot iterate data source {type(src)!r}")


def _event(action: str, cls: str, step=None, batch=None, **extra):
    if not _MON.enabled:
        return
    rec = {"kind": "resilience_event", "action": action, "class": cls}
    if step is not None:
        rec["at_step"] = step
    if batch is not None:
        rec["at_batch"] = batch
    rec.update(extra)
    _MON.record_step(rec)


def resilient_train_loop(
    exe,
    program,
    loader,
    fetch_list: Sequence,
    scope=None,
    *,
    policy: Optional[RetryPolicy] = None,
    nan_mode: str = "raise",
    checkpoint_manager=None,
    resume: bool = False,
    injector=None,
    max_inflight: int = 2,
    log_period: int = 1,
    on_logged: Optional[Callable[[int, List[np.ndarray]], Any]] = None,
    max_steps: Optional[int] = None,
    snapshot_state: bool = True,
    publish_hook: Optional[Callable[[int], Any]] = None,
    publish_period_steps: Optional[int] = None,
) -> ResilienceStats:
    """Drive `pipeline.train_loop` under a supervision loop that survives
    classified failures.

        cm = fluid.CheckpointManager(root, program=main, scope=scope,
                                     save_every_steps=50)
        stats = fluid.resilient_train_loop(
            exe, main, lambda: make_loader(), [loss], scope=scope,
            policy=fluid.RetryPolicy(max_device_retries=3),
            nan_mode="skip_step", checkpoint_manager=cm)
        if stats.preempted:
            ...exit; the next process passes resume=True and continues...

    `loader` is an iterable of feed dicts or (preferred) a zero-arg
    callable returning a fresh one.  The callable form is REQUIRED for
    `nan_mode="rollback"` and for `resume=True` — both must rewind the
    data stream further back than the bounded replay window reaches — and
    the stream must be deterministic (same batches in the same order each
    call; seeded shuffles qualify).

    `checkpoint_manager` enables rollback, periodic dispatch-boundary
    saves (every `cm.save_every_steps` steps; each checkpoint includes the
    RNG key and a RESUME.json recording the data-stream position), and
    the preemption flush.  `resume=True` restores the newest valid
    checkpoint into `scope` and fast-forwards the loader before training.

    `publish_hook` (the online-learning cadence contract) is
    called at the dispatch boundary every `publish_period_steps` steps
    (default `FLAGS_publish_period_steps`; 0 disables) with the step
    number — typically it snapshots the model (dense + SelectedRows
    tables) and pushes it through the serving publish ladder.  The hook
    runs at the same consistent cut checkpoints use.  A FAILED publish
    never kills training: the exception is counted
    (`serving.publish_errors`), recorded (`publish_failed` event), and
    the cadence resumes at the next period — the publisher's own
    quarantine/rollback machinery already made the failure loud, and
    the training timeline is not poisoned by a bad SNAPSHOT.  The
    `serving.publish_staleness_steps` gauge tracks trained-step minus
    last-published-step at every dispatch, so a silently stalled
    cadence is visible.

    `injector` (faults.py) threads a deterministic fault
    schedule through the loop; defaults to `FaultInjector.from_flags()`
    so `FLAGS_fault_spec=...` chaos-tests any entry point that reaches
    this loop.  SIGTERM (real or injected) is latched by a handler and
    honored at the next dispatch boundary: in-flight steps drain, one
    checkpoint flushes, and the loop returns with `stats.preempted=True`
    and `stats.resume_step`."""
    policy = policy or RetryPolicy()
    if nan_mode not in ("raise", "skip_step", "rollback"):
        raise ValueError(f"nan_mode must be raise | skip_step | rollback, "
                         f"got {nan_mode!r}")
    factory = loader if callable(loader) else None
    cm = checkpoint_manager
    if nan_mode == "rollback" and cm is None:
        raise ValueError("nan_mode='rollback' needs a checkpoint_manager")
    if nan_mode == "rollback" and factory is None:
        raise ValueError("nan_mode='rollback' needs `loader` to be a "
                         "zero-arg factory (the replay must rewind the "
                         "data stream past the in-flight window)")
    if resume and (cm is None or factory is None):
        raise ValueError("resume=True needs a checkpoint_manager and a "
                         "loader factory")
    if nan_mode == "skip_step" and not snapshot_state:
        raise ValueError("nan_mode='skip_step' undoes the poisoned update "
                         "from a dispatch-boundary snapshot; it cannot run "
                         "with snapshot_state=False (use nan_mode='rollback' "
                         "with a checkpoint_manager, or 'raise')")
    if injector is None:
        from .faults import FaultInjector

        injector = FaultInjector.from_flags()
    if scope is None:
        from .core.scope import global_scope

        scope = global_scope()
    if cm is not None and cm.scope is None:
        cm.scope = scope
    if cm is not None and getattr(cm, "retry_policy", None) is None:
        # one backoff schedule for the whole loop: the manager's storage
        # retries follow the same seeded policy as the device retries
        cm.retry_policy = policy
    if injector is not None:
        # storage faults fire inside the io.py choke point;
        # arming is idempotent and disarmed in the finally below
        injector.arm_io()

    # silent-corruption sentinel: amortized content digests over the whole
    # training state.  Period 0 (the default) arms NOTHING — the hot path pays one
    # `is None` branch, the same contract as the fault injector.
    digester = None
    from .flags import flag as _flag

    _integrity_period = int(_flag("FLAGS_integrity_check_period"))
    if _integrity_period > 0:
        from . import integrity as _integrity_mod

        digester = _integrity_mod.arm_live_digests(
            scope, period=_integrity_period, rank=getattr(cm, "rank", 0))

    # publish cadence: period from the kwarg, else the flag;
    # no hook (or period 0) disables the whole path at one `if`
    _pub_period = (int(_flag("FLAGS_publish_period_steps") or 0)
                   if publish_period_steps is None
                   else int(publish_period_steps))
    if publish_hook is None:
        _pub_period = 0
    pub = {"at": 0, "fired_at": -1}

    stats = ResilienceStats()
    eff_inflight = max_inflight
    window = max_inflight + 2
    snapshots_on = snapshot_state and (
        nan_mode == "skip_step" or policy.max_device_retries > 0)
    resolve_all = nan_mode != "raise"

    # ---- data cursor: one pass + bounded replay --------------------------
    it_box: Dict[str, Any] = {"it": None}
    src_box: Dict[str, Any] = {"src": None, "stateful": False}
    consumed = 0                     # raw batches pulled from the source
    replay: "OrderedDict[int, dict]" = OrderedDict()    # batch idx -> feed
    # batch idx -> the RAW pull, kept only where the fault injector mutated
    # the feed: `replay` holds the batch AS DISPATCHED (so a device retry
    # re-presents corrupt data instead of healing it), but loader-
    # determinism verification must compare against what the source yielded
    raw_overlay: Dict[int, dict] = {}
    pending: deque = deque()         # (batch idx, feed) queued for re-feed
    skipped_raw: set = set()         # raw batch indices dropped as bad
    stream = {"suspect": False}      # a producer-side error likely killed it
    step_batch: Dict[int, int] = {}  # global step -> raw batch idx it used
    # batch idx -> the source's stream state BEFORE pulling it (checkpoints
    # store the state of their next batch, making resume an O(1) seek)
    state_at: "OrderedDict[int, Any]" = OrderedDict()
    # after a replay fast-forward: batches the OLD replay window recorded
    # that the rebuilt loader is about to re-yield — each refetch is
    # compared so a non-deterministic factory dies loudly, not silently
    verify_replay: Dict[int, Any] = {}
    snaps: "OrderedDict[int, dict]" = OrderedDict()     # step -> state snap
    start_step = 0                   # global step the next segment starts at
    preempt = {"hit": False}

    def _fresh_iter():
        from .reader import is_checkpointable

        src = factory() if factory is not None else loader
        src_box["src"] = src
        src_box["stateful"] = is_checkpointable(src)
        return _as_iter(src)

    def _pull_raw():
        nonlocal consumed
        bi = consumed
        if src_box["stateful"]:
            try:
                state_at[bi] = src_box["src"].state_dict()
            except Exception:
                state_at[bi] = None
            while len(state_at) > window:
                state_at.popitem(last=False)
        try:
            feed = next(it_box["it"])
        except StopIteration:
            raise
        except BaseException as e:
            raise _errors.attach_context(e, batch_index=bi)
        consumed += 1
        ref = verify_replay.pop(bi, None)
        if ref is not None and not _feeds_equal(ref, feed):
            raise RuntimeError(
                f"resilience: replay divergence at batch {bi}: the rebuilt "
                f"loader yielded a different batch than the replay window "
                f"recorded — the factory is non-deterministic, and recovery "
                f"would silently train on different data.  Seed the source "
                f"(or use a checkpointable reader, which seeks instead of "
                f"replaying)")
        if injector is not None:
            injector.on_batch(bi, feed)  # may raise DataError
        return bi, feed

    def _next_good_batch():
        """Pull until a batch survives, spending the bad-batch budget."""
        while True:
            try:
                out = _pull_raw()
                stream["suspect"] = False  # it survived: not dead after all
                return out
            except StopIteration:
                raise
            except BaseException as e:
                ce = _errors.classify(e)
                if not isinstance(ce, DataError):
                    raise
                if getattr(ce, "budget_exhausted", False) or \
                        getattr(e, "budget_exhausted", False):
                    # the data layer already spent its own corruption
                    # budget (recordio FLAGS_data_corrupt_budget): terminal
                    # by design, not one more skippable batch
                    _reraise(ce, e)
                if stats.skipped_batches >= policy.max_bad_batches:
                    # budget exhausted: terminal — surface the DataError
                    if ce is e:
                        raise
                    raise ce from e
                stats.skipped_batches += 1
                if ce.batch_index is not None and ce.batch_index < consumed:
                    skipped_raw.add(ce.batch_index)
                else:
                    # the pull itself failed (producer thread / generator
                    # frame) — most iterators are dead after raising, so
                    # the next pull's StopIteration may be an early end,
                    # not a real end of data
                    stream["suspect"] = True
                _MON.counter("resilience.skipped_batches").inc()
                _event("skip_batch", "DataError", batch=ce.batch_index)

    def _segment_feeds(seg_start: int):
        """Feeds for one train_loop attempt: replayed batches first, then
        fresh pulls; records the step->batch mapping and applies the NaN
        injection for the step each feed is about to become."""
        step = seg_start
        while True:
            if pending:
                bi, feed = pending.popleft()
            else:
                try:
                    bi, feed = _next_good_batch()
                except StopIteration:
                    if stream["suspect"]:
                        # skipped a producer-side failure and the stream
                        # ended right after: almost certainly the iterator
                        # died mid-run, not a genuine end of data — say so
                        # instead of "completing" short silently
                        _log.warning(
                            "resilience: data stream ended at batch %d "
                            "immediately after a producer-side error was "
                            "skipped — the iterator likely died mid-run; "
                            "the run is ending early, not at end-of-data",
                            consumed)
                        _MON.counter("resilience.stream_died").inc()
                        _event("stream_died", "DataError", batch=consumed)
                    return
            if injector is not None:
                # inject BEFORE the replay window stores the feed: the
                # window must hold the batch AS DISPATCHED, or a device
                # retry at the same step replays a corrupt batch clean
                # (the once-only latch is already spent) and trains the
                # sample the uninterrupted run would have dropped
                raw = feed
                feed = injector.on_feed(step, feed)
                if feed is not raw:
                    raw_overlay[bi] = raw
            replay[bi] = feed
            while len(replay) > window:
                evicted, _ = replay.popitem(last=False)
                raw_overlay.pop(evicted, None)
            step_batch[step] = bi
            if len(step_batch) > 8 * window:
                # only entries near the in-flight window are read at
                # recovery (rollback/resume fall back to RESUME.json);
                # prune so a long run doesn't leak one entry per step
                for s in [s for s in step_batch if s < step - 2 * window]:
                    del step_batch[s]
            yield feed
            step += 1

    def _flush_checkpoint(step: int) -> Optional[str]:
        """Dispatch-boundary save: scope == state after `step` steps (the
        save's host copies block on anything still in flight).  RESUME.json
        records where the data stream stands — and, for a checkpointable
        source, its pickled stream state, so resume is an O(1) seek
        instead of a replay.  Written as a `save(sidecars=...)` so the
        snapshot and its cursor commit atomically.

        Returns None when the save round was skipped (storage degraded
        mode): training continues unprotected, the manager's
        lag gauge is loud, and the next period retries."""
        cm._step = step
        nb = step_batch.get(step, consumed)
        info = {"step": step, "next_batch": nb,
                "skipped_batches": stats.skipped_batches}
        st = state_at.get(nb) if src_box["stateful"] else None
        if st is not None:
            info["stream_state"] = _io.pack_stream_state(st)
        name = resume_sidecar_name(getattr(cm, "rank", 0),
                                   getattr(cm, "world_size", 1))
        out = cm.save(step=step, sidecars={name: json.dumps(info)})
        if injector is not None and out is not None:
            injector.on_commit(out)  # rot_shard@N fires post-COMMIT
        return out

    def _read_resume(step: int) -> dict:
        """The RESUME sidecar of the checkpoint that actually restored
        (not latest() — restore may have walked past a corrupt newer one
        whose sidecar would misalign the data stream): this rank's
        namespaced name first, then the single-process name.  A checkpoint
        of another world size needs its cursors re-split (the elastic
        resume), which comes with ROADMAP A10."""
        d = getattr(cm, "last_restored_dir", None) or cm._dir(step)
        saved_world = getattr(cm, "restored_world", None)
        cur_world = getattr(cm, "world_size", 1)
        if saved_world and saved_world != cur_world:
            raise NotImplementedError(
                f"resilience: checkpoint {d} was written by world size {saved_world}, this "
                f"run has {cur_world}: re-splitting its stream cursors (the elastic resume) "
                "comes with ROADMAP A10")
        names = [resume_sidecar_name(getattr(cm, "rank", 0), cur_world),
                 RESUME_FILE]
        for name in names:
            try:
                with open(os.path.join(d, name)) as f:
                    return json.load(f)
            except OSError:
                continue
        return {}

    def _on_dispatch(step: int, feed):
        time.sleep(0)  # let a just-delivered SIGTERM reach the handler
        if preempt["hit"]:
            raise PreemptionError("preemption notice received",
                                  step=step, phase="dispatch")
        if injector is not None:
            injector.on_dispatch(step)  # may raise / deliver SIGTERM
            time.sleep(0)
            if preempt["hit"]:
                raise PreemptionError("preemption notice received",
                                      step=step, phase="dispatch")
        if (cm is not None and cm.save_every_steps and step > 0
                and step % cm.save_every_steps == 0 and cm._step != step):
            _flush_checkpoint(step)
        if _pub_period:
            # publish cadence: fire at the same consistent cut
            # the checkpoint flush uses.  A retried step must not publish
            # twice (fired_at latch), and a FAILED publish must not kill
            # training — count it, record it, resume the cadence next
            # period; the publisher's quarantine already went loud.
            if step > 0 and step % _pub_period == 0 \
                    and pub["fired_at"] != step:
                pub["fired_at"] = step
                try:
                    with _MON.span("serving.publish_hook", step=step):
                        publish_hook(step)
                    pub["at"] = step
                    stats.publishes += 1
                    _MON.counter("serving.publishes").inc()
                    _event("publish", "Serving", step=step)
                except Exception as pe:
                    stats.publish_failures += 1
                    _MON.counter("serving.publish_errors").inc()
                    # staleness stamped on the event: the gauge reads 0
                    # after the NEXT success, so failed periods are the
                    # durable evidence --max-publish-staleness-steps gates
                    _event("publish_failed", type(pe).__name__, step=step,
                           staleness=step - pub["at"],
                           detail=str(pe)[:300])
            _MON.gauge("serving.publish_staleness_steps").set(
                step - pub["at"])
        if injector is not None:
            # flip_bit strikes AFTER the flush: the classic silent-
            # corruption timeline is a clean committed checkpoint, then
            # a flipped bit, then steps training on poison
            injector.on_state(step, scope)
        if digester is not None:
            # raises a latched divergence verdict as IntegrityError, and
            # digests the chunk due at this boundary
            digester.on_step(step)
        if snapshots_on:
            with _MON.span("resilience.snapshot", step=step):
                snaps[step] = _snapshot_scope(scope)
            while len(snaps) > window:
                snaps.popitem(last=False)

    def _queue_replay_from(batch_idx: int):
        """Re-feed raw batches [batch_idx, consumed) from the replay
        window (they belong to steps that are being redone).  Batches the
        loader already dropped as bad leave holes in the range — those
        stay dropped; only a batch that is neither replayable nor known
        to be skipped means the window failed to cover the in-flight
        depth."""
        pending.clear()
        missing = [bi for bi in range(batch_idx, consumed)
                   if bi not in replay and bi not in skipped_raw]
        if missing:
            raise RuntimeError(
                f"resilience: replay window lost batches {missing} "
                f"(window={window}); the window must cover the in-flight "
                f"depth — this is a bug")
        for bi in range(batch_idx, consumed):
            if bi in replay:
                pending.append((bi, replay[bi]))

    def _rewind_source_to(batch_idx: int, stream_state=None):
        """Position the data stream so the next raw pull is `batch_idx`
        (rollback/resume reach further back than the replay window).

        With `stream_state` (a checkpointable source's saved cursor) this
        is an O(1) seek: rebuild from the factory, load_state_dict, done —
        bit-identical even for shuffled sources, since the state carries
        the RNG/buffer cursor.  Without it, fall back to the historical
        replay: rebuild and pull `batch_idx` batches just to discard them
        — O(dataset), loud (`resilience.replay_fast_forward` span + event,
        `resilience.replayed_batches` counter), and guarded: a replayed
        batch that differs from what the replay window recorded means the
        factory is non-deterministic, and recovery raises instead of
        silently training on different data."""
        nonlocal consumed
        if factory is None:
            raise RuntimeError(
                "resilience: recovery needs to rewind the data stream to "
                f"batch {batch_idx}, but `loader` is a bare iterable — "
                "pass a zero-arg factory")
        pending.clear()
        # the verification refs must be what the SOURCE yielded: undo the
        # injector's mutations so a poisoned batch doesn't read as a
        # non-deterministic factory when the rebuilt loader re-pulls it
        old_replay = {bi: raw_overlay.get(bi, f) for bi, f in replay.items()}
        replay.clear()
        raw_overlay.clear()
        state_at.clear()
        verify_replay.clear()
        if stream_state is not None:
            from .reader import is_checkpointable

            src = factory()
            if is_checkpointable(src):
                with _MON.span("resilience.stream_seek", batch=batch_idx):
                    src.load_state_dict(stream_state)
                src_box["src"] = src
                src_box["stateful"] = True
                it_box["it"] = _as_iter(src)
                consumed = batch_idx
                state_at[batch_idx] = stream_state
                _MON.counter("resilience.stream_seek").inc()
                _event("stream_seek", "DataStream", batch=batch_idx)
                return
            _log.warning(
                "resilience: a stream state was saved but the rebuilt "
                "loader is not checkpointable (factory changed?); falling "
                "back to replay fast-forward")
        _MON.counter("resilience.replay_fallback").inc()
        if batch_idx > 0:
            _log.warning(
                "resilience: data source is not checkpointable — replaying "
                "%d batch(es) to fast-forward (O(dataset) resume; give the "
                "loop a stateful reader to make this an O(1) seek)",
                batch_idx)
        it_box["it"] = _fresh_iter()
        consumed = 0
        with _MON.span("resilience.replay_fast_forward", batches=batch_idx):
            while consumed < batch_idx:
                try:
                    feed = next(it_box["it"])
                except StopIteration:
                    raise RuntimeError(
                        f"resilience: loader exhausted at batch {consumed} "
                        f"while fast-forwarding to {batch_idx} — the factory "
                        f"must replay the same deterministic stream")
                ref = old_replay.get(consumed)
                if ref is not None and not _feeds_equal(ref, feed):
                    raise RuntimeError(
                        f"resilience: replay divergence at batch {consumed}: "
                        f"the rebuilt loader yielded a different batch than "
                        f"the replay window recorded — the factory is "
                        f"non-deterministic, and recovery would silently "
                        f"train on different data.  Seed the source (or use "
                        f"a checkpointable reader, which seeks instead of "
                        f"replaying)")
                consumed += 1
        # batches past the fast-forward point that the old window recorded
        # will be re-pulled for the redone steps — verify those refetches too
        verify_replay.update(
            {bi: f for bi, f in old_replay.items() if bi >= batch_idx})
        if batch_idx > 0:
            _MON.counter("resilience.replayed_batches").inc(batch_idx)
            _event("replay_fast_forward", "DataStream", batch=batch_idx,
                   batches=batch_idx)

    def _reraise(ce, orig):
        if ce is orig:
            raise ce
        raise ce from orig

    def _recover(e: BaseException) -> str:
        """Route one classified failure; returns "continue" (another
        segment) or "preempted" (graceful exit), re-raises otherwise."""
        nonlocal eff_inflight, start_step
        ce = _errors.classify(e)
        if isinstance(ce, PreemptionError):
            step = ce.step if ce.step is not None else start_step
            stats.preempted = True
            stats.resume_step = step
            _MON.counter("resilience.preemptions").inc()
            if cm is not None:
                with _MON.span("resilience.recover", action="preempt_flush"):
                    stats.checkpoint_dir = _flush_checkpoint(step)
            _event("preempt_flush", "PreemptionError", step=step,
                   checkpoint=stats.checkpoint_dir)
            # the drain is this process's last act: the black box goes out
            # after the flush's records reached the ring
            _MON.dump_blackbox("sigterm_drain")
            start_step = step
            return "preempted"
        if not isinstance(ce, TrainingError) or isinstance(ce, DataError):
            # unmapped exceptions and FatalError are never retried;
            # a DataError escaping the feed path means budget exhausted
            _reraise(ce, e)
        step = ce.step if ce.step is not None else \
            _errors.get_context(e).get("step")
        if isinstance(ce, IntegrityError):
            # wrong-but-finite state: the in-memory params are poison and
            # no retry fixes them — restore the newest COMMITTED
            # checkpoint the digests PROVE clean (safe_step: a later one
            # may have committed the corruption) and rewind the data
            # stream to match.  Shares the rollback budget: both are
            # whole-timeline rewinds.
            if cm is None or factory is None:
                _reraise(ce, e)
            # safe_step is the ONLY trustworthy bound: a verdict without
            # one means no epoch ever agreed bit-exactly before the
            # divergence, so nothing on disk is provably clean — falling
            # back to the failing step would restore (or leave
            # unquarantined) a checkpoint that may hold the corruption.
            # Re-raise terminally rather than guess.
            bound = ce.safe_step
            if bound is None:
                _reraise(ce, e)
            # quarantine first, in EVERY path: a checkpoint committed
            # after the proven-clean boundary may hold the corruption,
            # and its at-rest digests cannot tell — they hash what was
            # saved.  Idempotent, so every rank of a gang can do it.
            cm.reject_unsafe(bound)
            if getattr(cm, "world_size", 1) > 1:
                # a gang cannot roll back per rank in process: its
                # rollback is the gang restart (ROADMAP A10)
                _reraise(ce, e)
            if stats.rollbacks >= policy.max_rollbacks:
                _reraise(ce, e)
            with _MON.span("resilience.recover", action="integrity_rollback",
                           step=step):
                restored = cm.restore(scope=scope, max_step=bound)
                if restored is None:
                    _reraise(ce, e)  # no clean checkpoint predates it
                info = _read_resume(restored)
                bi = step_batch.get(restored)
                if bi is None:  # checkpoint predates this process
                    bi = int(info.get("next_batch",
                                      restored + stats.skipped_batches))
                sst = info.get("stream_state")
                _rewind_source_to(
                    bi, _io.unpack_stream_state(sst) if sst else None)
            snaps.clear()
            if digester is not None:
                digester.reset()  # new generation: the old timeline died
            stats.rollbacks += 1
            _MON.counter("resilience.rollbacks").inc()
            _MON.counter("integrity.rollbacks").inc()
            _event("rollback", "IntegrityError", step=step,
                   restored_step=restored,
                   corrupt_ranks=ce.corrupt_ranks,
                   attributed=ce.attributed)
            start_step = restored
            return "continue"
        if isinstance(ce, NumericError):
            if nan_mode == "raise" or step is None:
                _reraise(ce, e)
            if nan_mode == "skip_step":
                if stats.skipped_steps >= policy.max_skipped_steps:
                    _reraise(ce, e)
                snap = snaps.get(step)
                if snap is None:
                    _reraise(ce, e)
                with _MON.span("resilience.recover", action="skip_step",
                               step=step):
                    _restore_scope(scope, snap)
                    _queue_replay_from(step_batch[step] + 1)
                snaps.clear()
                stats.skipped_steps += 1
                _MON.counter("resilience.skipped_steps").inc()
                _event("skip_step", "NumericError", step=step,
                       batch=step_batch.get(step))
                start_step = step
                return "continue"
            # rollback
            if stats.rollbacks >= policy.max_rollbacks:
                _reraise(ce, e)
            with _MON.span("resilience.recover", action="rollback",
                           step=step):
                restored = cm.restore(scope=scope, max_step=step)
                if restored is None:
                    _reraise(ce, e)  # nothing at or before the failure
                info = _read_resume(restored)
                bi = step_batch.get(restored)
                if bi is None:  # checkpoint predates this process: sidecar
                    bi = int(info.get("next_batch",
                                      restored + stats.skipped_batches))
                sst = info.get("stream_state")
                _rewind_source_to(
                    bi, _io.unpack_stream_state(sst) if sst else None)
            snaps.clear()
            if digester is not None:
                digester.reset()
            stats.rollbacks += 1
            _MON.counter("resilience.rollbacks").inc()
            _event("rollback", "NumericError", step=step,
                   restored_step=restored)
            start_step = restored
            return "continue"
        if isinstance(ce, TransientDeviceError):
            if stats.retries >= policy.max_device_retries or step is None:
                _reraise(ce, e)
            delay = policy.backoff_s(stats.retries)
            if delay > 0:
                with _MON.span("resilience.backoff", attempt=stats.retries):
                    time.sleep(delay)
            if ce.resource_exhausted and eff_inflight > 1:
                eff_inflight = max(1, eff_inflight // 2)
                stats.degraded_inflight += 1
                _MON.counter("resilience.degraded_inflight").inc()
                _MON.gauge("resilience.max_inflight").set(eff_inflight)
                _event("degrade_inflight", "TransientDeviceError", step=step,
                       max_inflight=eff_inflight)
            with _MON.span("resilience.recover", action="retry", step=step):
                snap = snaps.get(step)
                if snap is not None:
                    # resolution-time failure: later steps already ran on
                    # this state; rewind to the dispatch boundary of `step`
                    _restore_scope(scope, snap)
                _queue_replay_from(step_batch[step])  # retry the same batch
            snaps.clear()
            stats.retries += 1
            _MON.counter("resilience.retries").inc()
            _event("retry", "TransientDeviceError", step=step,
                   code=ce.code)
            start_step = step
            return "continue"
        _reraise(ce, e)

    # ---- SIGTERM latch ---------------------------------------------------
    prev_handler = None
    installed = False
    if threading.current_thread() is threading.main_thread():
        prev_handler = _signal.getsignal(_signal.SIGTERM)
        _signal.signal(_signal.SIGTERM, lambda s, f: preempt.update(hit=True))
        installed = True

    # a new training run opens a fresh data-corruption budget window
    # (FLAGS_data_corrupt_budget is per-run, spent by recordio scanners)
    try:
        from . import recordio as _recordio

        _recordio.reset_corrupt_spent()
    except Exception:
        pass

    nan_check_prev = None
    if resolve_all:
        # can't skip/rollback a NaN the guard never sees: force the guard
        # on (and per-step resolution) for the duration
        from .flags import get_flags, set_flags

        nan_check_prev = get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
        set_flags({"FLAGS_check_nan_inf": True})

    t0 = time.perf_counter()
    try:
        if resume:
            restored = cm.restore(scope=scope)
            if restored is not None:
                start_step = restored
                info = _read_resume(restored)
                stats.skipped_batches = int(info.get("skipped_batches", 0))
                sst = info.get("stream_state")
                _rewind_source_to(
                    int(info.get("next_batch", restored)),
                    _io.unpack_stream_state(sst) if sst else None)
                _event("resume", "PreemptionError", step=restored)
            else:
                it_box["it"] = _fresh_iter()
        else:
            it_box["it"] = _fresh_iter()

        while True:
            stats.segments += 1
            seg_start = start_step
            remaining = None if max_steps is None else max_steps - seg_start
            if remaining is not None and remaining <= 0:
                break
            collect = (on_logged if on_logged is not None
                       else lambda s, v: stats.logged.append((s, v)))
            try:
                seg = _pipeline.train_loop(
                    exe, program, _segment_feeds(seg_start), fetch_list,
                    scope=scope, max_inflight=eff_inflight,
                    log_period=log_period, on_logged=collect,
                    max_steps=remaining, step_offset=seg_start,
                    on_dispatch=_on_dispatch, resolve_all=resolve_all)
            except BaseException as e:
                if _recover(e) == "preempted":
                    break
                continue
            start_step = seg_start + seg.steps
            # a SIGTERM that landed after the last dispatch (tail drain,
            # loader exhausted) was latched but never hit a dispatch
            # boundary — honor it here or the notice is silently dropped
            if preempt["hit"]:
                stats.preempted = True
                stats.resume_step = start_step
                _MON.counter("resilience.preemptions").inc()
                if cm is not None:
                    stats.checkpoint_dir = _flush_checkpoint(start_step)
                _event("preempt_flush", "PreemptionError", step=start_step,
                       checkpoint=stats.checkpoint_dir)
                _MON.dump_blackbox("sigterm_drain")
            break
        stats.steps = start_step
        stats.final_max_inflight = eff_inflight
        return stats
    finally:
        stats.wall_s = time.perf_counter() - t0
        if installed:
            _signal.signal(_signal.SIGTERM, prev_handler)
        if injector is not None:
            injector.disarm_io()
        if digester is not None:
            from . import integrity as _integrity_mod

            _integrity_mod.disarm_live_digests(digester)
        if nan_check_prev is not None:
            from .flags import set_flags

            set_flags({"FLAGS_check_nan_inf": nan_check_prev})
