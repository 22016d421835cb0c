"""Checkpoint manager with a preemption story (counterpart of
paddle_tpu/checkpoint_manager.py, single rank).

Periodic snapshots in the JAX package's sharded format
(`io.save_sharded`) with atomic directory commit (a `.tmp` dir renamed
into place after its `STEP` and `COMMITTED` markers), keep-last-N
rotation, a SIGTERM hook that flushes one final snapshot (deferred while a
save is in flight, never re-entered), and `latest()` / `restore()` for
resume.  `restore` walks backwards past corrupt, unreadable or
integrity-quarantined checkpoints (`reject_unsafe`) to the newest one that
loads.  A checkpoint written by either package restores in the other.

The scope's generator (`RNG_STATE_VAR`) rides along as its state, a uint8
array, so a resumed run draws the same dropout masks (io.py
`_restore_generator`; a JAX checkpoint's PRNG key seeds the generator
deterministically and is counted).  `restore` copies into the tensors the
scope already holds where shape and dtype agree, so a plan's captured CUDA
graph trains on the restored state without a new capture; vars the scope
lacks land on `place` (default: the device of the scope's tensors, else
`CUDAPlace(0)`, which raises without a card).

Storage faults do not kill a save: transient errors (ENOSPC / EIO /
EAGAIN / ETIMEDOUT, classified as `errors.StorageError` off the io.py
choke point) are retried with the seeded-backoff `RetryPolicy`; terminal
ones (EROFS / EACCES) skip the retries.  A save that still cannot commit
tries `FLAGS_ckpt_fallback_dir` (restore merges both roots), then enters
degraded mode: `save` returns None, training continues, the
`resilience.ckpt_lag_steps` gauge and a `storage_degraded` event go loud,
and `FLAGS_max_ckpt_lag_steps` bounds how long unprotected training may
run before the lag becomes a terminal StorageError.  The next commit
clears the latch.

Coordinated multi-rank commits (`world_size > 1`), a `mesh` and elastic
N->M restores come with data parallelism (ROADMAP A10) and raise.
"""
from __future__ import annotations

import contextlib as _contextlib
import logging
import os
import re
import shutil
import signal
import time
from typing import Optional

from . import io as _io
from .core.scope import RNG_STATE_VAR
from .errors import IntegrityError as _IntegrityError
from .monitor import MONITOR as _MON

log = logging.getLogger("paddle_tpu_torch.checkpoint")

COMMITTED_MARKER = "COMMITTED"
DIST_MARKER = "DIST"
# integrity quarantine: a checkpoint whose step postdates a
# detected corruption window may have COMMITTED the corruption — its
# at-rest digests verify (they hash what was saved), so the only safe
# treatment is an explicit marker restore refuses, exactly like an
# uncommitted distributed save.  Written by `reject_unsafe` when the
# live digest sentinel's verdict names a safe_step.
INTEGRITY_REJECTED_MARKER = "INTEGRITY_REJECTED"

class CheckpointManager:
    def __init__(self, root: str, program=None, scope=None, keep: int = 3,
                 save_every_steps: int = 0, mesh=None,
                 rank: int = 0, world_size: int = 1,
                 commit_timeout_s: float = 60.0, elastic: bool = False,
                 retry_policy=None, fallback_dir: Optional[str] = None, place=None):
        if int(world_size) > 1 or int(rank) != 0:
            raise NotImplementedError(
                f"CheckpointManager(rank={rank}, world_size={world_size}): coordinated "
                "multi-rank commits come with data parallelism (ROADMAP A10)")
        if mesh is not None:
            raise NotImplementedError("CheckpointManager(mesh=...): sharded placement comes "
                                      "with data parallelism (ROADMAP A10)")
        if elastic:
            raise NotImplementedError("CheckpointManager(elastic=True): N->M re-sharding "
                                      "comes with ROADMAP A10")
        self.root = root
        self.place = place
        self.program = program
        self.scope = scope
        self.keep = keep
        self.save_every_steps = save_every_steps
        self.rank = int(rank)
        self.world_size = int(world_size)
        # storage resilience: transient-save retry budget +
        # backoff schedule (resilience.RetryPolicy; None = defaults, and
        # resilient_train_loop shares its own policy in), the optional
        # secondary root (None = FLAGS_ckpt_fallback_dir at save time),
        # and the degraded-mode latch + lag ledger
        self.retry_policy = retry_policy
        self._fallback_dir = fallback_dir
        self.degraded = False
        self.ckpt_lag_steps = 0
        # monitor-independent ledger: failed/skipped save rounds and
        # degraded->recovered transitions
        self.storage_rounds_skipped = 0
        self.storage_recoveries = 0
        self._last_commit_step: Optional[int] = None
        # set by restore(): the world size that wrote the restored
        # checkpoint and its directory
        self.restored_world: Optional[int] = None
        self.last_restored_dir: Optional[str] = None
        self._step = 0
        self._prev_handlers = {}
        self._saving = False
        self._deferred_signal = None
        os.makedirs(root, exist_ok=True)

    @property
    def fallback_dir(self) -> Optional[str]:
        """The secondary checkpoint root tried when the primary store
        fails (ctor arg wins, else FLAGS_ckpt_fallback_dir, else None)."""
        if self._fallback_dir:
            return self._fallback_dir
        from .flags import flag

        return flag("FLAGS_ckpt_fallback_dir") or None

    def _policy(self):
        if self.retry_policy is None:
            from .resilience import RetryPolicy

            self.retry_policy = RetryPolicy()
        return self.retry_policy

    # -- saving ------------------------------------------------------------
    def _device(self, scope):
        """Where restored vars the scope lacks go: `place`, else the device
        of the scope's tensors, else the card."""
        import torch

        if self.place is not None:
            return self.place.device if hasattr(self.place, "device") else torch.device(self.place)
        for name in scope.local_var_names():
            v = scope.find_var(name)
            if isinstance(v, (torch.Tensor, torch.Generator)):
                return v.device
        from .core.executor import CUDAPlace

        return CUDAPlace(0).device

    def _dir(self, step: int, root: Optional[str] = None) -> str:
        return os.path.join(root or self.root, f"ckpt-{step:010d}")

    def _var_names(self, scope):
        """Persistables plus the generator when the scope holds one, so a
        restore rewinds the random stream too (None -> io's default when
        no program is attached)."""
        if self.program is None:
            return None
        names = [v.name for v in _io._persistables(self.program)]
        if scope is not None and scope.find_var(RNG_STATE_VAR) is not None:
            names.append(RNG_STATE_VAR)
        return names

    def save(self, step: Optional[int] = None, sidecars=None):
        """Atomic snapshot: write to a temp dir, rename into place (a
        preempted half-written save can never be mistaken for a valid
        checkpoint), then rotate old ones.  Not interrupted by its own
        preemption hook: a SIGTERM landing mid-save is deferred until this
        save commits (re-entering would trash the .tmp dir under the
        first writer).

        `sidecars` (name -> str contents, e.g. the resilience layer's
        RESUME.json) are written into the temp dir BEFORE the commit
        marker/rename, so a checkpoint can never exist without its
        sidecars (a post-rename write used to leave a crash window where
        the snapshot committed but the data-stream cursor did not).

        Storage faults do not propagate: transients are retried per
        `retry_policy`, terminal ones fall through to the fallback dir,
        and a save that still cannot commit returns None with the manager
        in DEGRADED MODE (see the module docstring).  Other failures
        raise."""
        step = self._step if step is None else step
        self._saving = True
        try:
            with _MON.span("checkpoint.save", step=step, rank=self.rank):
                out = self._save_resilient(step, sidecars)
            if out is not None:
                _MON.counter("checkpoint.saves").inc()
        finally:
            self._saving = False
            deferred = self._deferred_signal
            self._deferred_signal = None
            if deferred is not None:
                # replay the preemption notice whether or not this save
                # committed — a failed save must not swallow a SIGTERM
                self._on_preempt(*deferred)
        return out

    def _save_resilient(self, step: int, sidecars=None) -> Optional[str]:
        """One save round under the storage-resilience ladder: primary
        (with transient retries) -> fallback dir -> degraded mode.
        Returns the committed dir, or None when the round was skipped
        (degraded).  Raises non-storage failures untouched, and a
        terminal StorageError when the degraded lag exceeds
        FLAGS_max_ckpt_lag_steps."""
        from .errors import StorageError, classify

        policy = self._policy()
        attempt = 0
        cause = None
        while True:
            try:
                return self._save_once(step, sidecars, self.root)
            except Exception as e:
                ce = classify(e)
                if not isinstance(ce, StorageError):
                    raise
                cause = ce
                _MON.counter("resilience.ckpt_storage_errors").inc()
                if ce.transient and attempt < policy.max_storage_retries:
                    delay = policy.backoff_s(attempt)
                    attempt += 1
                    _MON.counter("resilience.ckpt_save_retries").inc()
                    log.warning(
                        "checkpoint step %d: transient storage failure "
                        "(%s); retry %d/%d in %.3fs", step, ce, attempt,
                        policy.max_storage_retries, delay)
                    if delay > 0:
                        with _MON.span("resilience.ckpt_save_backoff",
                                       attempt=attempt):
                            time.sleep(delay)
                    continue
                break
        # retries exhausted (or terminal errno): try the fallback store
        # before degrading
        fb = self.fallback_dir
        if fb:
            try:
                os.makedirs(fb, exist_ok=True)
                # the fallback dir models a DIFFERENT device: injected
                # primary-store faults must not follow the save there
                with _io.fault_exempt(fb):
                    out = self._save_once(step, sidecars, fb)
                _MON.counter("resilience.ckpt_fallback_saves").inc()
                _MON.record_step({
                    "kind": "resilience_event", "action": "ckpt_fallback",
                    "class": "StorageError", "at_step": step, "dir": out,
                    "rank": self.rank})
                log.warning("checkpoint step %d: primary root failed (%s); "
                            "committed to fallback %s", step, cause, out)
                return out
            except Exception as e:
                ce = classify(e)
                if not isinstance(ce, StorageError):
                    raise
                log.warning("checkpoint step %d: fallback dir failed too "
                            "(%s)", step, ce)
                cause = ce
        return self._enter_degraded(step, cause)

    def _save_once(self, step: int, sidecars, root: str) -> str:
        """One commit attempt into `root` (the historical save body)."""
        final = self._dir(step, root)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        _io.save_sharded(tmp, var_names=self._var_names(self.scope),
                         scope=self.scope, program=self.program)
        for name, body in (sidecars or {}).items():
            _io.atomic_write(os.path.join(tmp, name), body)
        _io.atomic_write(os.path.join(tmp, "STEP"), str(step))
        _io.atomic_write(os.path.join(tmp, COMMITTED_MARKER), str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._note_commit(step)
        self._rotate(root)
        self._gc_stale_tmp(step, root)
        return final

    def _enter_degraded(self, step: int, cause=None,
                        action: str = "storage_degraded") -> None:
        """Latch degraded mode for one failed save round: training
        continues, the lag gauge and event go loud, and the bounded-lag
        conversion keeps unprotected training finite.  Returns None (what
        `save` hands back for a skipped round)."""
        from .errors import StorageError
        from .flags import flag

        last = self._last_commit_step
        lag = max(0, step - (last if last is not None else 0))
        first = not self.degraded
        self.degraded = True
        self.storage_rounds_skipped += 1
        self.ckpt_lag_steps = lag
        _MON.gauge("resilience.ckpt_lag_steps").set(lag)
        if first:
            _MON.counter("resilience.storage_degraded").inc()
        _MON.record_step({
            "kind": "resilience_event", "action": action,
            "class": "StorageError", "at_step": step, "lag_steps": lag,
            "last_commit_step": last, "rank": self.rank,
            "cause": str(cause) if cause is not None else None})
        log.warning(
            "checkpoint step %d: save failed (%s) — DEGRADED MODE: "
            "training continues UNPROTECTED, %d step(s) past the last "
            "committed checkpoint (%s)", step, cause, lag,
            last if last is not None else "none")
        bound = int(flag("FLAGS_max_ckpt_lag_steps"))
        if bound > 0 and lag > bound:
            since = (f"since the step-{last} commit" if last is not None
                     else "since the start of the run (nothing ever "
                          "committed)")
            err = StorageError(
                f"checkpoint lag of {lag} step(s) exceeds "
                f"FLAGS_max_ckpt_lag_steps={bound}: the store has been "
                f"failing {since} and unprotected training may not "
                f"continue — fix the store (or widen the bound)",
                transient=False, op="write", step=step)
            err.__cause__ = cause
            raise err
        return None

    def _note_commit(self, step: int):
        """Successful-commit bookkeeping: reset the lag ledger and clear
        the degraded latch (recovery goes as loud as the failure did)."""
        self._last_commit_step = step
        self.ckpt_lag_steps = 0
        _MON.gauge("resilience.ckpt_lag_steps").set(0)
        if self.degraded:
            self.degraded = False
            self.storage_recoveries += 1
            _MON.counter("resilience.ckpt_recovered").inc()
            _MON.record_step({
                "kind": "resilience_event", "action": "storage_recovered",
                "class": "StorageError", "at_step": step,
                "rank": self.rank})
            log.info("checkpoint step %d: storage recovered — degraded "
                     "mode cleared", step)

    def _rotate(self, root: Optional[str] = None):
        root = root or self.root
        ckpts = self.checkpoints(root)
        for d in ckpts[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)

    # -- checkpoint GC -----------------------------------------------------
    def _gc_stale_tmp(self, committed_step: int,
                      root: Optional[str] = None) -> int:
        """Sweep uncommitted pending dirs at or below the just-committed
        step: debris of dead incarnations (a process killed mid-save
        leaves its `.tmp` behind).  Pending dirs for LATER steps are left
        alone."""
        removed = 0
        root = root or self.root
        for name in os.listdir(root):
            if not (name.startswith("ckpt-") and name.endswith(".tmp")):
                continue
            try:
                step = int(name[len("ckpt-"):-len(".tmp")])
            except ValueError:
                continue
            if step <= committed_step:
                shutil.rmtree(os.path.join(root, name),
                              ignore_errors=True)
                removed += 1
        if removed:
            _MON.counter("resilience.ckpt_gc").inc(removed)
            log.info("checkpoint GC: swept %d stale pending dir(s) at or "
                     "below step %d", removed, committed_step)
        return removed

    def reject_unsafe(self, max_safe_step: int) -> int:
        """Quarantine every checkpoint — COMMITTED or still pending —
        whose step postdates `max_safe_step` (the newest boundary the
        integrity digests PROVE clean): such a snapshot may have
        committed the corruption, and its content digests cannot tell —
        they faithfully hash what was saved.  Pending `.tmp` dirs get the
        marker too (it rides their rename).  Idempotent; a LATER save that
        reuses the step replaces the whole dir, marker included.  Scans
        the primary root and the fallback dir, which `restore`'s merged
        walk reaches as well."""
        marked = 0
        roots = [self.root]
        fb = self.fallback_dir
        if fb and os.path.abspath(fb) != os.path.abspath(self.root):
            roots.append(fb)
        body = f"unsafe: newer than proven-clean step {max_safe_step}"
        for root in roots:
            try:
                names = os.listdir(root)
            except OSError:
                continue
            steps = {}
            for name in names:
                m = re.match(r"^ckpt-(\d+)(\.tmp)?$", name)
                if m and int(m.group(1)) > max_safe_step:
                    steps.setdefault(int(m.group(1)), set()).add(name)
            for step, found in sorted(steps.items()):
                final = f"ckpt-{step:010d}"
                # EVERY live name gets a marker — a reused step can exist
                # as a committed final AND a pending tmp at once, and the
                # tmp's commit would wholesale-replace the final (marker
                # included); the trailing final attempt covers a tmp
                # renamed mid-scan
                for name in (*sorted(found), final):
                    d = os.path.join(root, name)
                    marker = os.path.join(d, INTEGRITY_REJECTED_MARKER)
                    try:
                        if os.path.isdir(d) and not os.path.exists(marker):
                            with open(marker, "w") as f:
                                f.write(body)
                            marked += 1
                    except OSError:
                        continue  # renamed/rotated under us: next name
        if marked:
            log.warning("integrity: quarantined %d checkpoint(s) newer "
                        "than proven-clean step %d", marked, max_safe_step)
        return marked

    def saved_world(self, ckpt_dir: str) -> int:
        """World size that wrote `ckpt_dir` (the DIST marker; absent or
        unreadable = a single-process save)."""
        try:
            with open(os.path.join(ckpt_dir, DIST_MARKER)) as f:
                return int(f.read().strip() or 1)
        except (OSError, ValueError):
            return 1

    def checkpoints(self, root: Optional[str] = None):
        """Committed checkpoint names under `root` (default: the primary
        root).  An unlistable PRIMARY root raises — a restore that
        silently saw [] on a transiently-down store would restart
        training from scratch and abandon all committed progress."""
        return sorted(d for d in os.listdir(root or self.root)
                      if d.startswith("ckpt-") and not d.endswith(".tmp"))

    def _candidates(self):
        """[(name, root)] of every committed checkpoint dir across the
        primary root and (when configured) the fallback dir, sorted by
        step — the restore walk iterates it newest-first.  On a step
        present in both roots the PRIMARY copy sorts newer (it is the
        store of record; the fallback copy of the same step was a
        redundant earlier commit).  Only the OPTIONAL fallback root may
        be unlistable without consequence (never configured to exist, or
        its device is gone — the primary copies still restore)."""
        out = [(n, self.root) for n in self.checkpoints()]
        fb = self.fallback_dir
        if fb and os.path.abspath(fb) != os.path.abspath(self.root):
            try:
                out.extend((n, fb) for n in self.checkpoints(fb))
            except OSError:
                pass
        out.sort(key=lambda t: (t[0], t[1] == self.root))
        return out

    def latest(self) -> Optional[str]:
        c = self._candidates()
        return os.path.join(c[-1][1], c[-1][0]) if c else None

    def restore(self, scope=None, mesh=None,
                max_step: Optional[int] = None,
                elastic: Optional[bool] = None) -> Optional[int]:
        """Load the newest loadable snapshot; returns its step (None if
        none exist).  A corrupt newest checkpoint (missing STEP,
        unreadable shard, truncated manifest) is logged and skipped — the
        walk continues backwards to the previous valid one instead of
        killing the resume (exactly the moment a half-dead pod needs it
        least).  Only raises when checkpoints exist but none load.

        `max_step` bounds the walk: the resilience layer's rollback must
        not restore a checkpoint taken AFTER the failing step (its state
        already contains the poison it is rolling back from).

        A checkpoint written by another world size raises a classified
        `CheckpointError` naming both sizes; the elastic path that would
        re-shard it (`elastic=True`) and a `mesh` come with ROADMAP A10."""
        from .errors import CheckpointError

        if mesh is not None or elastic:
            raise NotImplementedError("CheckpointManager.restore(mesh=..., elastic=True): "
                                      "re-sharded restores come with ROADMAP A10")
        elastic = False
        ckpts = self._candidates()
        errors = []
        for name, base in reversed(ckpts):
            d = os.path.join(base, name)
            # a distributed checkpoint (the JAX package's gang) without its
            # rank-0 COMMITTED marker may mix steps: skip it outright
            if (os.path.exists(os.path.join(d, DIST_MARKER))
                    and not os.path.exists(os.path.join(d, COMMITTED_MARKER))):
                _MON.counter("checkpoint.uncommitted_skipped").inc()
                log.warning("checkpoint %s is uncommitted (distributed save "
                            "missing its COMMITTED marker); falling back to "
                            "the previous one", d)
                continue
            if os.path.exists(os.path.join(d, INTEGRITY_REJECTED_MARKER)):
                # quarantined by the live digest sentinel: it may have
                # committed corruption its own at-rest digests cannot see
                _MON.counter("integrity.ckpt_rejected").inc()
                _MON.record_step({
                    "kind": "integrity_event", "action": "ckpt_rejected",
                    "dir": d, "file": INTEGRITY_REJECTED_MARKER,
                    "rank": self.rank})
                log.warning("checkpoint %s is integrity-quarantined "
                            "(committed inside a detected corruption "
                            "window); falling back to the previous one", d)
                continue
            try:
                with open(os.path.join(d, "STEP")) as f:
                    step = int(f.read())
            except Exception as e:
                errors.append((name, e))
                _MON.counter("checkpoint.restore_skipped").inc()
                log.warning("checkpoint %s is unreadable (%s: %s); falling "
                            "back to the previous one", d, type(e).__name__, e)
                continue
            if max_step is not None and step > max_step:
                continue
            saved_world = self.saved_world(d)
            if saved_world != self.world_size and not elastic:
                raise CheckpointError(
                    f"checkpoint {d} was saved by world size {saved_world} "
                    f"but this manager restores for world size "
                    f"{self.world_size} — refusing the non-elastic load "
                    f"(shards would be mispositioned); elastic re-sharding "
                    f"comes with ROADMAP A10",
                    saved_world=saved_world, current_world=self.world_size,
                    step=step)
            try:
                with _MON.span("checkpoint.restore", step=step,
                               saved_world=saved_world,
                               world=self.world_size), \
                        _io.fault_exempt(base) if base != self.root \
                        else _contextlib.nullcontext():
                    target = scope or self.scope
                    _io.load_sharded(d, scope=target, device=self._device(target),
                                     into_existing=True)
            except Exception as e:
                errors.append((name, e))
                _MON.counter("checkpoint.restore_skipped").inc()
                if isinstance(e, _IntegrityError):
                    # a flipped-yet-finite byte: the shards load cleanly
                    # but the content digest disagrees — exactly as dead
                    # as a truncated shard, and named
                    _MON.counter("integrity.ckpt_rejected").inc()
                    _MON.record_step({
                        "kind": "integrity_event",
                        "action": "ckpt_rejected", "dir": d,
                        "file": getattr(e, "file", None), "step": step,
                        "rank": self.rank})
                    log.warning("checkpoint %s REJECTED by content digest "
                                "(%s); falling back to the previous one",
                                d, e)
                else:
                    log.warning("checkpoint %s is unreadable (%s: %s); "
                                "falling back to the previous one", d,
                                type(e).__name__, e)
                continue
            self._step = step
            self.restored_world = saved_world
            self.last_restored_dir = d
            # the restored checkpoint is a durable point: degraded-lag
            # accounting (and a later bounded-lag verdict) measure from it
            self._last_commit_step = step
            if errors:
                log.warning("restored %s after skipping %d corrupt "
                            "checkpoint(s): %s", d, len(errors),
                            [n for n, _ in errors])
            return step
        if errors:
            raise RuntimeError(
                f"no loadable checkpoint under {self.root}: all "
                f"{len(errors)} candidates failed "
                f"({[(n, str(e)) for n, e in errors]})")
        return None

    # -- step-driven + preemption hooks ------------------------------------
    def step(self, n: int = 1):
        """Advance the step counter; saves when save_every_steps divides."""
        self._step += n
        if self.save_every_steps and self._step % self.save_every_steps == 0:
            self.save()
        return self._step

    def _on_preempt(self, signum, frame):
        try:
            self.save()
        finally:
            # chain the previous handler's behavior even when the flush
            # fails: the process was told to die, and eating the signal
            # because the disk was full would leave it a zombie
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

    def install_preemption_handler(self, signals=(signal.SIGTERM,)):
        """On SIGTERM (the preemption notice), flush one final snapshot and
        re-raise the previous handler's behavior.  A notice that lands
        while `save()` is mid-flight is deferred until that save commits
        (then flushed and chained as usual) — the handler never re-enters
        a half-written snapshot."""
        def handler(signum, frame):
            if self._saving:
                self._deferred_signal = (signum, frame)
                return
            self._on_preempt(signum, frame)

        for sig in signals:
            self._prev_handlers[sig] = signal.getsignal(sig)
            signal.signal(sig, handler)

    def uninstall_preemption_handler(self):
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()
