"""Multi-model co-residency under a device-memory budget (counterpart of
paddle_tpu/serving/registry.py).

The registry owns every loaded model's (program, scope, Predictor),
versioned so the publisher (publisher.py) can swap a verified snapshot in
atomically and keep the old version for an instant rollback.

  * One shared Executor for every model, version and clone: the plan cache
    is keyed by (program, feed shapes, fetches, scope), so the clones of
    one version serve each bucket from one plan, and a name aliasing a
    loaded directory shares its version and plans.

  * A warmed bucket is a graphed bucket.  On the card a plan's first run is
    eager and its second captures the CUDA graph (core/executor.py), so
    `warm` runs each bucket through `Executor.warm`, which leaves its plan
    holding a graph: the first real request of a bucket replays, and
    `executor.graph_capture` and `executor.cache_miss` stay flat under
    traffic.

  * Dropping a version releases its plans.  A graphed plan holds the
    scope's weight tensors, its static feeds and outputs and the graph's
    private memory pool; the executor keeps up to
    FLAGS_executor_cache_capacity plans.  So `unload`, an eviction, a
    version trimmed past `keep_versions` and a discarded staged version
    each call `Executor.release_scope` for every version no registry entry
    still holds.  A batch holding such a version keeps its plans: the
    server takes the version with `hold`, which counts the batch as in
    flight from the moment it is taken (under the registry's lock, so no
    release can slip in before it), and the release happens when the last
    holder lets go, so nothing is torn down under a batch.

  * A budget (FLAGS_serving_hbm_budget_mb, or `hbm_budget_mb`): a load is
    costed first, in order, by the static resource plan of the saved
    program at the largest bucket it will warm (weights, live activations,
    staged feeds: core/resource_plan.py, `plan_model_bytes`), by the
    manifest's weight bytes, or not at all (counted in
    `serving.unbudgeted_loads`).  A load past the budget evicts the least
    recently used models (never the one loading), then refuses with
    ServingError(reason="hbm_budget").  The ledger (`used_bytes`,
    `serving.hbm_used_mb`) counts each version's weight bytes; a graphed
    bucket's pool is not in it, which is why chip_smoke phase 59 prints the
    estimate, the ledger and the allocator side by side.

A quantized model directory (`io.save_quantized_inference_model`: int8
payloads, `__quant__.json`) loads and publishes like any other: its weights
are dequantized into their serve dtype at load, both estimates price them
at that dtype, and its version's `precision` (e.g. "int8->bfloat16") is on
`models()` and on the load and publish events.

The default place is `CUDAPlace(0)`; pass `CPUPlace()` to serve on the
CPU through the kernels' plain versions.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import io as _io
from ..core import locks
from ..core.dtypes import _numpy_bfloat16, canonical_dtype
from ..core.executor import CUDAPlace, Executor
from ..core.scope import Scope
from ..errors import ServingError
from ..flags import flag as _flag
from ..inference import AnalysisConfig, Predictor
from ..monitor import MONITOR as _MON
from . import tracing as _tr

__all__ = ["ModelVersion", "ModelRegistry", "synthetic_feeds",
           "manifest_weight_bytes", "plan_model_bytes", "quant_manifest",
           "model_precision"]


def quant_manifest(model_dir: str) -> Optional[dict]:
    """The dir's __quant__.json when it names at least one quantized weight,
    else None (also for an unreadable manifest)."""
    try:
        with open(os.path.join(model_dir, _io.QUANT_MANIFEST)) as f:
            q = json.load(f)
        return q if q.get("weights") else None
    except (OSError, ValueError):
        return None


def model_precision(model_dir: str) -> str:
    """Serving precision label of a model dir: "float32" for plain models,
    "int<bits>-><serve dtype>" (e.g. "int8->bfloat16") from a quant
    manifest; mixed records join with "/"."""
    q = quant_manifest(model_dir)
    if q is None:
        return "float32"
    recs = list(q["weights"].values())
    bits = "/".join(str(b) for b in sorted(
        {int(r.get("bits", 8)) for r in recs}))
    dts = "/".join(sorted({str(r.get("dtype", "float32")) for r in recs}))
    return f"int{bits}->{dts}"


def _np_dtype(dtype) -> np.dtype:
    name = canonical_dtype(dtype)
    return np.dtype(_numpy_bfloat16() if name == "bfloat16" else name)


def _dtype_itemsize(name: str) -> int:
    try:
        return _np_dtype(name or "float32").itemsize
    except (TypeError, ValueError):
        return 2


def synthetic_feed_shapes(program, feed_names: Sequence[str], rows: int
                          ) -> Dict[str, tuple]:
    """The bucket-shape rule shared by the warm-up feeds and the pre-load
    plan: the batch dim becomes `rows`, other dynamic (-1) dims 1."""
    block = program.global_block()
    shapes = {}
    for name in feed_names:
        var = block.var(name)
        shape = [int(d) for d in (var.shape or [])]
        if not shape:
            shape = [rows]
        else:
            shape = [1 if d < 0 else d for d in shape]
            shape[0] = int(rows)
        shapes[name] = tuple(shape)
    return shapes


def synthetic_feeds(program, feed_names: Sequence[str], rows: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic warm-up / golden feeds shaped by the program's feed
    vars: float feeds small positive values (0 sits on poles such as log),
    int feeds zeros (id 0 is a row of any table)."""
    block = program.global_block()
    rng = np.random.RandomState(seed)
    feeds = {}
    for name, shape in synthetic_feed_shapes(program, feed_names,
                                             rows).items():
        dtype = _np_dtype(block.var(name).dtype)
        if dtype.kind in "iu":
            feeds[name] = np.zeros(shape, dtype)
        elif dtype.kind == "b":
            feeds[name] = np.zeros(shape, bool)
        else:
            feeds[name] = (rng.rand(*shape) * 0.1 + 0.05).astype(dtype)
    return feeds


def plan_model_bytes(model_dir: str, rows: int) -> int:
    """Pre-load estimate from the static resource plan of the saved program
    at the `rows`-row bucket: weights, live activations and staged feeds
    (core/resource_plan.py).  Reads only `__model__.json` (and a quantized
    dir's `__quant__.json`: the plan prices a weight at the program's dtype,
    the load dequantizes it into its serve dtype, so the narrowing is taken
    off).  0 when the program is absent or cannot be planned; callers fall
    back to `manifest_weight_bytes`."""
    try:
        with open(os.path.join(model_dir, _io.MODEL_FILENAME)) as f:
            doc = json.load(f)
        from ..core.program import Program
        from ..core.resource_plan import plan_program

        program = Program.from_dict(doc)
        feed_shapes = synthetic_feed_shapes(program, doc.get("feed_names", []),
                                            rows)
        plan = plan_program(program, feed_shapes, doc.get("fetch_names", []))
        total = int(plan.peak_bytes)
        qweights = (quant_manifest(model_dir) or {}).get("weights", {})
        if qweights:
            block = program.global_block()
            for wname, rec in qweights.items():
                try:
                    var = block.var(wname)
                except Exception:
                    continue
                elems = 1
                for d in (var.shape or []):
                    elems *= max(int(d), 1)
                orig = _dtype_itemsize(var.dtype or "float32")
                total -= elems * max(orig - _dtype_itemsize(rec.get("dtype", "float32")), 0)
        return total
    except Exception:
        return 0


def manifest_weight_bytes(model_dir: str) -> int:
    """Pre-load estimate from the dir's manifest (shape x dtype a
    persistable; a weight the quant manifest names at its serve dtype), the
    fallback when the program cannot be planned; activations are invisible
    to it.  0 when the manifest is unreadable."""
    total = 0
    qweights = (quant_manifest(model_dir) or {}).get("weights", {})
    try:
        with open(os.path.join(model_dir, _io.MANIFEST)) as f:
            manifest = json.load(f)
        for entry in manifest.get("vars", []):
            n = 1
            for d in entry.get("shape", []):
                n *= max(int(d), 1)
            qrec = qweights.get(entry.get("name"))
            dtype = (qrec.get("dtype", "float32") if qrec
                     else entry.get("dtype", "float32"))
            total += n * _dtype_itemsize(dtype)
    except (OSError, ValueError, KeyError):
        return 0
    return total


class ModelVersion:
    """One immutable served version: program, weights scope and the
    predictor bound to the registry's shared executor.  `run` serves from a
    clone per thread (a Predictor serialises on its own lock; clones share
    the weights and the plans).  Its holders (`held`, the registry's
    `hold`, and every `run` and `warm`) are counted, so that a version the
    registry let go releases its plans when the last holder lets go."""

    _ids = iter(range(1, 1 << 62))

    def __init__(self, program, feed_names, fetch_names, scope: Scope,
                 predictor: Predictor, src: str,
                 precision: Optional[str] = None):
        self.version = next(ModelVersion._ids)
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.scope = scope
        self.predictor = predictor
        self.src = src
        self.precision = precision or model_precision(src)
        self.created_ts = time.time()
        self.bytes = self._weight_bytes()
        self._clones: Dict[int, Predictor] = {}
        self._clones_lock = locks.named_lock("serving.clones", rank=16)
        self._running = 0
        self._retired = False

    def _weight_bytes(self) -> int:
        total = 0
        for n in self.scope.local_var_names():
            v = self.scope.find_var(n)
            nb = getattr(v, "nbytes", None)
            if nb is None and not isinstance(v, torch.Generator):
                try:
                    nb = np.asarray(v).nbytes
                except Exception:
                    nb = 0
            total += int(nb or 0)
        return total

    def _predictor(self) -> Predictor:
        tid = threading.get_ident()
        with self._clones_lock:
            p = self._clones.get(tid)
            if p is None:
                # the first thread serves from the base predictor, later ones
                # from clones
                p = self.predictor if not self._clones else self.predictor.clone()
                self._clones[tid] = p
            return p

    def _enter(self):
        with self._clones_lock:
            self._running += 1

    def _exit(self):
        with self._clones_lock:
            self._running -= 1
            release = self._retired and self._running == 0
        if release:
            self._release_plans()

    @contextlib.contextmanager
    def held(self):
        """Keep this version's plans until the block ends."""
        self._enter()
        try:
            yield self
        finally:
            self._exit()

    def run(self, feeds, fetch_names=None):
        with self.held():
            return self._predictor().run(feeds, fetch_names=fetch_names)

    def warm(self, feeds):
        """Run `feeds` until their plan replays a CUDA graph
        (Executor.warm)."""
        with self.held():
            return self._predictor().warm(feeds)

    def retire(self):
        """The registry let this version go: release its plans now, or when
        the last run in flight ends."""
        with self._clones_lock:
            self._retired = True
            release = self._running == 0
        if release:
            self._release_plans()

    def _release_plans(self):
        self.predictor.exe.release_scope(self.scope)


class _Model:
    def __init__(self, name: str, version: ModelVersion):
        self.name = name
        self.versions: List[ModelVersion] = [version]
        self.active = version
        self.last_used = time.monotonic()
        # pinned while its load() still warms: a concurrent load's eviction
        # must not take a model from under its own warm-up
        self.pinned = False


class ModelRegistry:
    def __init__(self, place=None, hbm_budget_mb: Optional[float] = None,
                 executor: Optional[Executor] = None, keep_versions: int = 2):
        self.place = place if place is not None else CUDAPlace(0)
        self.executor = executor if executor is not None else Executor(self.place)
        self._budget_mb = hbm_budget_mb
        self.keep_versions = max(int(keep_versions), 1)
        self._models: Dict[str, _Model] = {}
        self._lock = locks.named_rlock("serving.registry", rank=14)
        # publish() ladders in flight, by model (publisher.py): losers wait
        # on the condition; the ladder itself runs without a lock
        self._publishing: set = set()
        self._publish_cv = locks.named_condition("serving.publish", rank=10)
        # verified, warmed, not yet active versions (two-phase publish)
        self._staged: Dict[str, ModelVersion] = {}
        # source dirs whose publish was rejected (publisher.py)
        self.quarantined: set = set()
        # weak: the global monitor's gauges must not keep a dead registry
        # (and every scope it holds) alive
        w = weakref.ref(self)
        _MON.gauge("serving.models").set_fn(
            lambda: (lambda r: float(len(r._models)) if r else 0.0)(w()))
        _MON.gauge("serving.hbm_used_mb").set_fn(
            lambda: (lambda r: r.used_bytes() / 1e6 if r else 0.0)(w()))

    # -- budget ------------------------------------------------------------
    def budget_bytes(self) -> int:
        mb = self._budget_mb
        if mb is None:
            mb = _flag("FLAGS_serving_hbm_budget_mb")
        return int(float(mb or 0) * 1e6)

    def used_bytes(self) -> int:
        with self._lock:
            seen, total = set(), 0
            for m in self._models.values():
                for v in m.versions:
                    if id(v) not in seen:  # aliased dirs share versions
                        seen.add(id(v))
                        total += v.bytes
            return total

    def _event(self, action: str, **kw):
        _MON.record_step({"kind": "serving_event", "action": action, **kw})

    @staticmethod
    def _sparse_digest(version) -> Optional[str]:
        """Content digest of the version's SelectedRows vars (None without
        sparse state), stamped on load and activate events."""
        from .. import integrity as _integrity

        try:
            return _integrity.sparse_state_digest(version.scope)
        except Exception:
            return None

    def _retire_dropped(self, dropped):
        """Retire each of `dropped` that no entry (an alias, the staged slot)
        still holds; call under self._lock."""
        held = {id(v) for m in self._models.values() for v in m.versions}
        held.update(id(m.active) for m in self._models.values())
        held.update(id(v) for v in self._staged.values())
        for v in {id(v): v for v in dropped}.values():
            if id(v) not in held:
                v.retire()

    def _make_room(self, need: int, loading: str):
        """Evict cold models (LRU, never `loading`) until `need` more bytes
        fit the budget; refuse when they cannot."""
        budget = self.budget_bytes()
        if not budget:
            return
        while self.used_bytes() + need > budget:
            victims = sorted(
                (m for n, m in self._models.items()
                 if n != loading and not m.pinned),
                key=lambda m: m.last_used)
            if not victims:
                raise ServingError(
                    f"loading {loading!r} needs ~{need/1e6:.1f} MB but the "
                    f"budget is {budget/1e6:.1f} MB with "
                    f"{self.used_bytes()/1e6:.1f} MB resident and nothing "
                    f"left to evict — raise FLAGS_serving_hbm_budget_mb or "
                    f"shrink the model", reason="hbm_budget", model=loading)
            victim = victims[0]
            del self._models[victim.name]
            self._retire_dropped(victim.versions + [victim.active])
            _MON.counter("serving.evictions").inc()
            self._event("evict", model=victim.name,
                        freed_bytes=sum(v.bytes for v in victim.versions),
                        for_model=loading)

    # -- loading -----------------------------------------------------------
    def load(self, name: str, model_dir: str,
             config: Optional[AnalysisConfig] = None,
             warm_buckets: Optional[Sequence[int]] = None) -> ModelVersion:
        """Load an inference-model dir (io.save_inference_model of either
        package) under `name`.  A dir already loaded under another name is
        aliased: the new name shares its ModelVersion, plans and bytes.
        `warm_buckets` graphs those buckets before the load returns."""
        real = os.path.realpath(model_dir)
        # estimated outside the lock: planning reads the saved program, and
        # a worker's acquire() must not wait on that
        need = (plan_model_bytes(model_dir, max(warm_buckets))
                if warm_buckets else 0)
        if not need:
            need = manifest_weight_bytes(model_dir)
        with self._lock:
            alias = next((m for m in self._models.values()
                          if os.path.realpath(m.active.src) == real), None)
            if alias is not None:
                entry = _Model(name, alias.active)
                entry.versions = alias.versions
                entry.pinned = True
                self._models[name] = entry
                self._event("load", model=name, alias_of=alias.name,
                            version=alias.active.version)
                version = alias.active
            else:
                if not need and self.budget_bytes():
                    _MON.counter("serving.unbudgeted_loads").inc()
                    self._event("unbudgeted_load", model=name, src=model_dir)
                self._make_room(need, name)
        if alias is None:
            # the weights stream in outside the lock
            cfg = config or AnalysisConfig(model_dir, place=self.place)
            predictor = Predictor(cfg, executor=self.executor)
            version = ModelVersion(predictor.program,
                                   predictor.feed_names,
                                   predictor.fetch_names,
                                   predictor.scope,
                                   predictor, src=model_dir)
            with self._lock:
                # other loads may have landed meanwhile, and the loaded
                # bytes may differ from the estimate: check again
                budget = self.budget_bytes()
                if budget and self.used_bytes() + version.bytes > budget:
                    self._make_room(version.bytes, name)
                    if self.used_bytes() + version.bytes > budget:
                        raise ServingError(
                            f"{name!r} loaded at {version.bytes/1e6:.1f} "
                            f"MB, past the {budget/1e6:.1f} MB budget "
                            f"even after eviction", reason="hbm_budget",
                            model=name)
                entry = _Model(name, version)
                entry.pinned = True  # not evictable until this load returns
                self._models[name] = entry
                _MON.counter("serving.model_loads").inc()
                self._event("load", model=name, version=version.version,
                            bytes=version.bytes, src=model_dir,
                            precision=version.precision,
                            sparse_digest=self._sparse_digest(version))
        try:
            if warm_buckets:
                self.warm(name, warm_buckets)
        finally:
            with self._lock:
                m = self._models.get(name)
                if m is not None:
                    m.pinned = False
        return version

    def warm(self, name: str, buckets: Sequence[int]) -> int:
        """Run a synthetic batch of each bucket through `name`'s active
        version until its plan is graphed (ModelVersion.warm); returns the
        number of buckets."""
        with self.hold(name) as version:
            for b in sorted(set(int(b) for b in buckets)):
                with _MON.span("serving.warm", model=name, bucket=b):
                    version.warm(synthetic_feeds(version.program, version.feed_names, b))
        return len(set(buckets))

    # -- lookup / lifecycle ------------------------------------------------
    def acquire(self, name: str) -> ModelVersion:
        """The active version (bumps recency).  Hold it for the whole batch:
        a swap or an eviction never invalidates it."""
        with self._lock:
            m = self._models.get(name)
            if m is None:
                raise ServingError(f"no model {name!r} loaded "
                                   f"(loaded: {sorted(self._models)})",
                                   reason="model_missing", model=name)
            m.last_used = time.monotonic()
            return m.active

    @contextlib.contextmanager
    def hold(self, name: str):
        """`acquire`, and keep the version's plans until the block ends (a
        batch): an unload, eviction or trim meanwhile releases them only
        then.  The hold starts under the registry's lock, which every
        release is decided under, so none can come between the two."""
        with self._lock:
            version = self.acquire(name)
            version._enter()
        try:
            yield version
        finally:
            version._exit()

    def models(self) -> Dict[str, dict]:
        with self._lock:
            return {n: {"version": m.active.version,
                        "versions": [v.version for v in m.versions],
                        "bytes": m.active.bytes, "src": m.active.src,
                        "precision": m.active.precision}
                    for n, m in self._models.items()}

    def unload(self, name: str):
        with self._lock:
            m = self._models.pop(name, None)
            if m is not None:
                self._retire_dropped(m.versions + [m.active])
        if m is None:
            raise ServingError(f"no model {name!r} to unload",
                               reason="model_missing", model=name)
        self._event("unload", model=name)

    # -- version swap (publisher.py drives this) ---------------------------
    def publish_version(self, name: str, version: ModelVersion) -> ModelVersion:
        """Atomically make `version` the served one; returns the previous
        active (kept for rollback; older history trimmed to keep_versions
        and released)."""
        with self._lock:
            m = self._models.get(name)
            if m is None:
                raise ServingError(f"no model {name!r} to publish into",
                                   reason="model_missing", model=name)
            prev = m.active
            m.versions.append(version)
            m.active = version
            if len(m.versions) > self.keep_versions:
                trimmed = m.versions[:-self.keep_versions]
                m.versions = m.versions[-self.keep_versions:]
                self._retire_dropped(trimmed)
            return prev

    def stage_version(self, name: str, version: ModelVersion) -> ModelVersion:
        """Hold a verified, warmed version without swapping it in (phase one
        of a two-phase publish); re-staging replaces (and releases) the held
        one."""
        with self._lock:
            if name not in self._models:
                raise ServingError(f"no model {name!r} to stage into",
                                   reason="model_missing", model=name)
            old = self._staged.get(name)
            self._staged[name] = version
            if old is not None and old is not version:
                self._retire_dropped([old])
        self._event("stage", model=name, version=version.version,
                    src=version.src)
        return version

    def staged(self, name: str) -> Optional[ModelVersion]:
        with self._lock:
            return self._staged.get(name)

    def activate_staged(self, name: str) -> ModelVersion:
        """Atomically swap the staged version in (phase two); the previous
        active is kept for rollback()."""
        with self._lock:
            version = self._staged.pop(name, None)
        if version is None:
            raise ServingError(
                f"model {name!r} has no staged version to activate — "
                f"stage_version/publish(stage_only=True) first",
                reason="model_missing", model=name)
        prev = self.publish_version(name, version)
        _MON.counter("serving.reloads").inc()
        self._event("activate_staged", model=name, version=version.version,
                    prev_version=prev.version, src=version.src,
                    sparse_digest=self._sparse_digest(version))
        return version

    def discard_staged(self, name: str) -> bool:
        """Drop (and release) a staged version without serving it; returns
        whether one was held."""
        with self._lock:
            version = self._staged.pop(name, None)
            if version is not None:
                self._retire_dropped([version])
        if version is not None:
            self._event("discard_staged", model=name,
                        version=version.version, src=version.src)
        return version is not None

    def rollback(self, name: str) -> ModelVersion:
        """Re-activate the kept previous version (instant: its weights and
        graphed plans are still there)."""
        with self._lock:
            m = self._models.get(name)
            if m is None:
                raise ServingError(f"no model {name!r} to roll back",
                                   reason="model_missing", model=name)
            older = [v for v in m.versions if v is not m.active]
            if not older:
                raise ServingError(
                    f"model {name!r} has no retained previous version",
                    reason="model_missing", model=name)
            m.active = older[-1]
            _MON.counter("serving.rollbacks").inc()
            self._event("rollback", model=name, version=m.active.version,
                        trace_id=_tr.control_trace_id("rb"))
            return m.active
