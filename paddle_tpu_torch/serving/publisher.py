"""Verified hot model reload: publish / verify / swap / rollback
(counterpart of paddle_tpu/serving/publisher.py).

`publish()` points a live server at either

  * a `CheckpointManager` committed checkpoint directory (or the manager
    itself: its `latest()`), a weights-only reload into the model's
    program, or
  * an inference-model directory (`io.save_inference_model` of either
    package), program and weights.

Nothing touches traffic until the staged snapshot passes the ladder:

  1. commit integrity: a distributed checkpoint without its COMMITTED
     marker (or a `.tmp` pending dir) is torn;
  2. content digests: every manifest-stamped file re-hashes to its sha256
     and byte length before anything is staged;
  3. manifest and shards: the manifest parses and every shard it names
     loads fully onto the registry's device;
  4. program verification: `core/analysis.check_program` (structural) with
     the model's feed and fetch targets;
  5. weight health: a non-finite value in a staged float weight rejects;
     SelectedRows vars take the sparse rung (`integrity.check_selected_
     rows`), and their digest is stamped on the publish event;
  6. the golden smoke: the staged predictor must give finite outputs on a
     golden batch (the caller's, or synthesized), equal to `golden_expect`
     when the caller pins one;
  7. quantized-snapshot parity: a quantized dir (`__quant__.json`) whose
     feed and fetch names are the active version's must give the active
     version's outputs on the smoke's feeds within FLAGS_serving_quant_atol
     (a shape mismatch or a larger drift rejects, as a NaN weight does); a
     pass records the `quant_parity` serving_event with its max_abs_diff;
  8. the pre-swap warm: each serving bucket of the staged version is run
     until its plan holds a CUDA graph (Predictor.warm), so the
     traffic after the swap captures nothing.

A content failure quarantines the snapshot: its dir joins the registry's
quarantine set and gets a `__quarantined__.json` marker (repeat publishes
reject fast), a `publish_rejected` event and counter record why, the plans
the staged scope got are released, and ServingError(reason=
"publish_rejected") raises while the old version serves on.  On success
the swap is atomic (registry lock), batches in flight finish on the
version they acquired, and the previous version is kept for `rollback()`.

Store I/O is not a content failure: a transient StorageError while
hashing or staging retries the whole ladder with backoff
(`serving.publish_retries`), and exhausting the retries, or a terminal
StorageError, raises ServingError(reason="publish_io") with no quarantine.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import integrity as _integrity
from ..checkpoint_manager import COMMITTED_MARKER, DIST_MARKER, CheckpointManager
from ..core.analysis import check_program
from ..core.scope import Scope
from ..errors import ServingError, StorageError, classify
from ..inference import Predictor
from ..monitor import MONITOR as _MON
from .. import io as _io
from . import tracing as _tr
from ..flags import flag as _flag
from .registry import ModelRegistry, ModelVersion, quant_manifest, synthetic_feeds

__all__ = ["publish", "rollback", "verify_snapshot_dir",
           "QUARANTINE_MARKER", "quarantine_marker"]

# A content rejection also writes this marker next to the snapshot, so
# every other process serving from the same store rejects it fast without
# paying the ladder again.  Written through io.atomic_write; best effort (a
# read-only store cannot take it, and the in-memory set still protects
# this process).
QUARANTINE_MARKER = "__quarantined__.json"

# transient store I/O retries of one publish() (the ladder is idempotent up
# to the swap, so it reruns whole)
PUBLISH_IO_ATTEMPTS = 3


class _RetryableStoreIO(Exception):
    """Internal: a ladder rung hit transient store I/O — retry the
    ladder, do NOT quarantine."""


def _store_io_failure(e: BaseException) -> Optional[StorageError]:
    """The StorageError behind `e` (transient OR terminal), walking the
    cause chain (verify/stage helpers may wrap the raw OSError), else
    None.  Either flavor is a verdict about the STORE, not the snapshot
    — neither may quarantine."""
    seen = set()
    cur: Optional[BaseException] = e
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        ce = classify(cur)
        if isinstance(ce, StorageError):
            return ce
        cur = cur.__cause__ or cur.__context__
    return None


def _fail_publish_io(name: str, src: str, cause, attempts: int,
                     trace_id=None):
    """Classified store-I/O publish failure: loud, NO quarantine — the
    snapshot may be fine, the store is not."""
    _MON.counter("serving.publish_io_failed").inc()
    _MON.record_step({
        "kind": "serving_event", "action": "publish_io_failed",
        "model": name, "src": src, "attempts": attempts,
        "detail": str(cause), "trace_id": trace_id})
    raise ServingError(
        f"publish of {src!r} into model {name!r} failed on store I/O "
        f"after {attempts} attempt(s) ({cause}); NOT quarantined — the "
        f"snapshot may be fine, the store is not",
        reason="publish_io", model=name, trace_id=trace_id) from cause


def quarantine_marker(src: str) -> Optional[dict]:
    """The persisted quarantine verdict next to snapshot `src`, or None.
    Tolerates a torn/garbage marker (it still quarantines — the verdict
    is the file's existence; the payload is advisory detail)."""
    path = os.path.join(src, QUARANTINE_MARKER)
    if not os.path.exists(path):
        return None
    try:
        doc = _io.read_json(path)
        return doc if isinstance(doc, dict) else {}
    except Exception:
        return {}


def _write_quarantine_marker(src: str, name: str, detail: str, trace_id):
    """Best-effort persisted verdict (see QUARANTINE_MARKER).  Exempt
    from INJECTED io faults: the marker is the fleet-wide record OF a
    content rejection — a chaos spec aimed at the snapshot's data path
    must not eat the verdict it just provoked.  Real OSErrors (read-only
    store, full disk) are counted, not fatal: the in-memory set still
    protects this process."""
    doc = {"model": name, "detail": detail, "trace_id": trace_id,
           "ts": time.time(), "pid": os.getpid(),
           "rank": os.environ.get("PADDLE_TRAINER_ID")}
    try:
        with _io.fault_exempt(src):
            _io.atomic_write(os.path.join(src, QUARANTINE_MARKER),
                             json.dumps(doc, default=str))
    except OSError:
        _MON.counter("serving.quarantine_marker_errors").inc()


def _reject(registry: ModelRegistry, name: str, src: str, trace_id,
            detail: str, marker: bool = True):
    registry.quarantined.add(os.path.realpath(src))
    if marker and os.path.isdir(src):
        _write_quarantine_marker(src, name, detail, trace_id)
    _MON.counter("serving.publish_rejected").inc()
    _MON.record_step({"kind": "serving_event", "action": "publish_rejected",
                      "model": name, "src": src, "detail": detail,
                      "trace_id": trace_id})
    # a rejected publish is what a post-mortem starts from: keep it in the
    # black box's exemplar ring
    _MON.record_exemplar({"kind": "serving_trace", "trace_id": trace_id,
                          "model": name, "outcome": "error",
                          "reason": "publish_rejected", "src": src,
                          "detail": detail})
    raise ServingError(
        f"publish of {src!r} into model {name!r} REJECTED and quarantined "
        f"({detail}); the previous version keeps serving",
        reason="publish_rejected", model=name, trace_id=trace_id)


def verify_snapshot_dir(src: str) -> str:
    """Static integrity checks every publish source must pass; returns
    the snapshot kind ('inference' | 'checkpoint' | 'vars').  Raises
    ValueError naming the defect — publish() maps that to a classified
    rejection."""
    if not os.path.isdir(src):
        raise ValueError(f"{src!r} is not a directory")
    if src.rstrip(os.sep).endswith(".tmp"):
        raise ValueError("pending (.tmp) checkpoint dir — not committed")
    # a distributed checkpoint must carry rank 0's COMMITTED marker; its
    # absence means some rank's shards never arrived (torn commit)
    if (os.path.exists(os.path.join(src, DIST_MARKER))
            and not os.path.exists(os.path.join(src, COMMITTED_MARKER))):
        raise ValueError("distributed checkpoint without COMMITTED marker "
                         "(torn commit)")
    if os.path.exists(os.path.join(src, _io.MODEL_FILENAME)):
        return "inference"
    if os.path.exists(os.path.join(src, _io.SHARDED_MANIFEST)):
        return "checkpoint"
    if os.path.exists(os.path.join(src, _io.MANIFEST)):
        return "vars"
    raise ValueError("no __model__.json, sharded manifest, or manifest — "
                     "not a model or checkpoint directory")


def _stage(registry: ModelRegistry, current: ModelVersion, src: str,
           kind: str):
    """Load the snapshot into a fresh scope on the registry's device;
    returns (program, feed_names, fetch_names, scope).  Any load failure
    (truncated shard, bad manifest, missing parameter) raises."""
    staged = Scope()
    device = registry.executor.place.device
    # verify=False: the digest rung just re-hashed every stamped file
    if kind == "inference":
        program, feed_names, fetch_names = _io.load_inference_model(
            src, registry.executor, scope=staged, verify=False)
        return program, feed_names, fetch_names, staged
    # weights-only: the program and its feed / fetch contract are the
    # serving version's
    params = [v.name for v in _io._persistables(current.program)]
    if kind == "checkpoint":
        _io.load_sharded(src, var_names=params, scope=staged, verify=False,
                         device=device)
    else:
        _io.load_vars(src, var_names=params, scope=staged, verify=False,
                      device=device)
    return (current.program, current.feed_names, current.fetch_names, staged)


def _nonfinite(value) -> bool:
    """A float tensor or array holding NaN or Inf (bfloat16 included)."""
    if isinstance(value, torch.Tensor):
        return value.is_floating_point() and not bool(torch.isfinite(value).all())
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr.dtype.kind == "f" and not np.isfinite(arr).all()


def _as_float(value) -> np.ndarray:
    arr = np.asarray(value)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def publish(registry: ModelRegistry, name: str, src,
            golden_feeds: Optional[Dict[str, np.ndarray]] = None,
            golden_expect: Optional[Sequence[np.ndarray]] = None,
            golden_rtol: float = 1e-4, golden_atol: float = 1e-5,
            warm_buckets: Optional[Sequence[int]] = None,
            stage_only: bool = False) -> ModelVersion:
    """Verify `src` and swap it in atomically as model `name`'s served
    version (the old one kept for rollback()).  Every failure raises a
    classified ServingError with the old version still serving.

    `stage_only=True` runs the whole ladder, the pre-swap warm included,
    and holds the verified version in the registry's staged slot instead
    of swapping; `registry.activate_staged(name)` swaps it in."""
    if isinstance(src, CheckpointManager):
        latest = src.latest()
        if latest is None:
            # a verdict about the manager, not about a snapshot: no marker
            _reject(registry, name, src.root,
                    "CheckpointManager has no committed checkpoint",
                    marker=False)
        src = latest
    src = str(src)
    # one ladder at a time per model, marked in flight rather than locked:
    # staging and the warm take seconds and nothing should queue on a lock
    with registry._publish_cv:
        while name in registry._publishing:
            registry._publish_cv.wait(0.1)
        registry._publishing.add(name)
    # one control trace id per publish episode, retries included
    ctl = _tr.control_trace_id("pub")
    try:
        attempt = 0
        while True:
            try:
                return _publish_ladder(registry, name, src, golden_feeds,
                                       golden_expect, golden_rtol,
                                       golden_atol, warm_buckets, ctl,
                                       stage_only=stage_only)
            except _RetryableStoreIO as e:
                cause = e.__cause__
                attempt += 1
                if attempt >= PUBLISH_IO_ATTEMPTS:
                    _fail_publish_io(name, src, cause, attempt,
                                     trace_id=ctl)
                _MON.counter("serving.publish_retries").inc()
                _MON.record_step({
                    "kind": "serving_event", "action": "publish_io_retry",
                    "model": name, "src": src, "attempt": attempt,
                    "detail": str(cause), "trace_id": ctl})
                from ..resilience import RetryPolicy

                time.sleep(RetryPolicy().backoff_s(attempt - 1))
    finally:
        with registry._publish_cv:
            registry._publishing.discard(name)
            registry._publish_cv.notify_all()


def _publish_ladder(registry, name, src, golden_feeds, golden_expect,
                    golden_rtol, golden_atol, warm_buckets, ctl=None,
                    stage_only=False):
    with _MON.span("serving.publish", model=name, trace_id=ctl):
        # publish reloads an existing model: a missing one is the caller's
        # error (model_missing), not the snapshot's
        active = registry.acquire(name)
        if os.path.realpath(src) in registry.quarantined:
            _reject(registry, name, src, ctl,
                    "source already quarantined by an earlier rejected "
                    "publish")
        mk = quarantine_marker(src)
        if mk is not None:
            registry.quarantined.add(os.path.realpath(src))
            who = mk.get("rank")
            _reject(registry, name, src, ctl,
                    f"source carries a persisted quarantine marker"
                    f"{f' (rejected by replica {who})' if who is not None else ''}"
                    f": {mk.get('detail', 'no detail recorded')}",
                    marker=False)
        try:
            kind = verify_snapshot_dir(src)
        except ValueError as e:
            _reject(registry, name, src, ctl, f"integrity: {e}")
        try:
            with _MON.span("serving.publish_digest_check", model=name):
                _integrity.verify_manifest_digests(src)
        except Exception as e:
            se = _store_io_failure(e)
            if se is not None and se.transient:
                raise _RetryableStoreIO(str(e)) from e
            if se is not None:
                # terminal store I/O: no retry, and no content verdict
                _fail_publish_io(name, src, se, attempts=1, trace_id=ctl)
            _reject(registry, name, src, ctl,
                    f"integrity: manifest digest check failed ({e})")
        try:
            program, feed_names, fetch_names, staged = _stage(
                registry, active, src, kind)
        except Exception as e:
            se = _store_io_failure(e)
            if se is not None and se.transient:
                raise _RetryableStoreIO(str(e)) from e
            if se is not None:
                _fail_publish_io(name, src, se, attempts=1, trace_id=ctl)
            _reject(registry, name, src, ctl,
                    f"staging failed ({type(e).__name__}: {e})")
        try:
            version, sparse_digest = _verify_staged(
                registry, name, src, ctl, active, program, feed_names,
                fetch_names, staged, golden_feeds, golden_expect,
                golden_rtol, golden_atol, warm_buckets)
        except BaseException:
            # the smoke and the warm gave the staged scope plans: let them go
            registry.executor.release_scope(staged)
            raise
        if stage_only:
            registry.stage_version(name, version)
            _MON.record_step({"kind": "serving_event",
                              "action": "publish_staged", "model": name,
                              "src": src, "version": version.version,
                              "precision": version.precision,
                              "sparse_digest": sparse_digest,
                              "trace_id": ctl})
            return version
        prev = registry.publish_version(name, version)
        _MON.counter("serving.reloads").inc()
        _MON.record_step({"kind": "serving_event", "action": "publish",
                          "model": name, "src": src,
                          "version": version.version,
                          "prev_version": prev.version,
                          "precision": version.precision,
                          "sparse_digest": sparse_digest,
                          "trace_id": ctl})
    return version


def _verify_staged(registry, name, src, ctl, active, program, feed_names,
                   fetch_names, staged, golden_feeds, golden_expect,
                   golden_rtol, golden_atol, warm_buckets):
    """Rungs 4-8 over a staged scope; returns (version, sparse digest)."""
    try:
        check_program(program, level="structural",
                      feed_names=feed_names, fetch_names=fetch_names)
    except Exception as e:
        _reject(registry, name, src, ctl, f"program verification: {e}")
    from ..core.selected_rows import SelectedRows as _SR

    for vname in staged.local_var_names():
        v = staged.find_var(vname)
        if isinstance(v, _SR):
            defect = _integrity.check_selected_rows(vname, v)
            if defect is not None:
                _reject(registry, name, src, ctl,
                        f"sparse table rung: {defect}")
            continue
        if _nonfinite(v):
            _reject(registry, name, src, ctl,
                    f"non-finite values in staged weight {vname!r}")
    sparse_digest = _integrity.sparse_state_digest(staged)
    # the golden smoke on the staged predictor (the shared executor: the
    # smoke run is also the bucket-1 plan's warm-up)
    predictor = Predictor(active.predictor.config,
                          _shared=(program, feed_names, fetch_names, staged),
                          executor=registry.executor)
    feeds = golden_feeds
    if feeds is None:
        feeds = synthetic_feeds(program, feed_names, rows=1)
    try:
        outs = predictor.run(feeds)
    except Exception as e:
        _reject(registry, name, src, ctl,
                f"golden smoke inference failed "
                f"({type(e).__name__}: {e})")
    for fname, o in zip(fetch_names, outs):
        if _nonfinite(o):
            _reject(registry, name, src, ctl,
                    f"golden smoke produced non-finite {fname!r}")
    if golden_expect is not None:
        if len(golden_expect) != len(fetch_names):
            # zip() would stop at the shorter list, leaving fetches unchecked
            _reject(registry, name, src, ctl,
                    f"golden_expect carries {len(golden_expect)} "
                    f"entries but the model fetches "
                    f"{len(fetch_names)} ({fetch_names})")
        for fname, got, want in zip(fetch_names, outs, golden_expect):
            if not np.allclose(_as_float(got), _as_float(want),
                               rtol=golden_rtol, atol=golden_atol):
                _reject(registry, name, src, ctl,
                        f"golden output {fname!r} drifted past "
                        f"rtol={golden_rtol}")
    _quant_parity(registry, name, src, ctl, active, feed_names, fetch_names,
                  feeds, outs)
    version = ModelVersion(program, feed_names, fetch_names, staged,
                           predictor, src=src)
    # the pre-swap warm: each serving bucket of the staged version graphed,
    # so the traffic after the swap captures nothing; a model that cannot
    # run its buckets is not servable
    try:
        for b in sorted(set(int(b) for b in (warm_buckets or ()))):
            with _MON.span("serving.warm", model=name, bucket=b):
                predictor.warm(synthetic_feeds(program, feed_names, b))
    except Exception as e:
        _reject(registry, name, src, ctl,
                f"pre-swap bucket warm failed "
                f"({type(e).__name__}: {e})")
    return version, sparse_digest


def _quant_parity(registry, name, src, ctl, active, feed_names, fetch_names,
                  feeds, outs):
    """Rung 7: a quantized snapshot publishing over a version of the same
    feed and fetch names must reproduce its outputs on the smoke's feeds
    within FLAGS_serving_quant_atol; quantization drift past it is a
    content defect, rejected as a NaN weight is."""
    if (quant_manifest(src) is None or active.feed_names != list(feed_names)
            or active.fetch_names != list(fetch_names)):
        return
    atol = float(_flag("FLAGS_serving_quant_atol") or 0.0)
    if atol <= 0:
        return
    try:
        ref = active.run(feeds)
    except Exception:
        # the active version cannot run these feeds: nothing to hold it to
        return
    worst, worst_name = 0.0, None
    for fname, got, want in zip(fetch_names, outs, ref):
        g = _as_float(got).astype(np.float64)
        w = _as_float(want).astype(np.float64)
        if g.shape != w.shape:
            _reject(registry, name, src, ctl,
                    f"quant parity: output {fname!r} shape {g.shape} != "
                    f"serving parent's {w.shape}")
        d = float(np.max(np.abs(g - w))) if g.size else 0.0
        if d > worst:
            worst, worst_name = d, fname
    if worst > atol:
        _reject(registry, name, src, ctl,
                f"quant parity: output {worst_name!r} drifted "
                f"max|diff|={worst:.3e} past FLAGS_serving_quant_atol={atol:g} "
                f"vs the serving parent's outputs")
    _MON.record_step({"kind": "serving_event", "action": "quant_parity",
                      "model": name, "src": src, "max_abs_diff": worst,
                      "atol": atol, "trace_id": ctl})


def rollback(registry: ModelRegistry, name: str) -> ModelVersion:
    """Re-activate the kept previous version at once."""
    return registry.rollback(name)
