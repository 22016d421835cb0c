"""Failure taxonomy (paddle_tpu/errors.py without the distributed classes;
same names, bases and messages).

    TrainingError         base: RuntimeError with step / batch / phase context
    DataError             a batch the input pipeline could not produce or
                          parse (reader.py, recordio.py): skippable within a
                          budget
    NumericError          the FLAGS_check_nan_inf guard tripped (NaN/Inf in
                          a fetched value)
    TransientDeviceError  a failure the next attempt may not see; on the
                          card, the caching allocator running out of memory
                          (`torch.cuda.OutOfMemoryError`)
    PreemptionError       the process got its preemption notice (SIGTERM):
                          flush a checkpoint and exit resumable
    FatalError            what `classify` cannot place in a recoverable class
    LockTimeoutError      a named lock not acquired within its deadline
                          (a FatalError; FLAGS_lock_timeout_s, core/locks.py)
    ResourceError         the program cannot fit in device memory (a
                          FatalError; the port has no static planner yet)
    CheckpointError       a checkpoint that must not be loaded as asked
    StorageError          the storage layer failed an I/O operation
                          (phase="storage", the io.py choke point): transient
                          errnos are retried, terminal ones skip to the
                          fallback dir / degraded mode
    IntegrityError        a file named by a manifest no longer hashes to
                          its recorded sha256 and byte length (io.load_vars)
    ParamServerError      the host sparse-table tier (param_server.py) failed
                          an RPC (phase="pserver"): transient errnos are
                          retried with reconnect, terminal ones (protocol
                          violations) are not
    ServingError          the serving runtime (serving/) refused or failed a
                          request or a control action on purpose; `reason`
                          carries the stable code clients route on

The build-time analysis failures (StaticAnalysisError and its subclasses,
FatalErrors) live with the verifier in core/analysis.py, as in the JAX
package.

`attach_context` leaves step breadcrumbs on an exception without changing
its type; `get_context` reads them; `classify` maps an exception onto the
classes above.  `pipeline.train_loop` and the executor's deferred fetches
use them.
"""
from __future__ import annotations

import errno as _errno
from typing import Optional

import torch

__all__ = ["TrainingError", "DataError", "NumericError", "TransientDeviceError",
           "PreemptionError", "FatalError", "CheckpointError", "ResourceError",
           "LockTimeoutError", "IntegrityError", "StorageError", "ServingError",
           "ParamServerError", "attach_context",
           "get_context", "classify", "TRANSIENT_STORAGE_ERRNOS", "TERMINAL_STORAGE_ERRNOS",
           "TRANSIENT_PS_ERRNOS"]

# The storage-failure split: transient errnos may pass (space freed, a
# flapping mount); terminal ones need another destination or an operator.
TRANSIENT_STORAGE_ERRNOS = (_errno.ENOSPC, _errno.EIO, _errno.EAGAIN, _errno.ETIMEDOUT)
TERMINAL_STORAGE_ERRNOS = (_errno.EROFS, _errno.EACCES)

# The pserver-failure split: the socket died because the pserver process
# did (its supervisor is restarting it) or the network flapped, so
# reconnect and retry.  A socket TimeoutError maps transient too (KVClient
# checks the type, not only the errno).  Anything else on the wire, above
# all a protocol violation, is terminal.
TRANSIENT_PS_ERRNOS = (_errno.ECONNREFUSED, _errno.ECONNRESET,
                       _errno.ECONNABORTED, _errno.EPIPE,
                       _errno.ETIMEDOUT, _errno.EAGAIN,
                       _errno.EHOSTUNREACH)


class TrainingError(RuntimeError):
    """Base of the failure taxonomy.  Carries structured context -- which
    train step / raw batch / layer the failure belongs to -- so recovery
    can rewind to exactly the right point."""

    def __init__(self, message: str, *, step: Optional[int] = None,
                 batch_index: Optional[int] = None,
                 phase: Optional[str] = None):
        super().__init__(message)
        self.step = step
        self.batch_index = batch_index
        self.phase = phase

    def __str__(self):
        base = super().__str__()
        ctx = []
        if self.step is not None:
            ctx.append(f"step={self.step}")
        if self.batch_index is not None:
            ctx.append(f"batch={self.batch_index}")
        if self.phase:
            ctx.append(f"phase={self.phase}")
        return f"{base} [{', '.join(ctx)}]" if ctx else base


class DataError(TrainingError):
    """The input pipeline failed to produce a batch (parse error, corrupt
    record, a feed that fails FeedSpec, an injected bad batch).  Dropping
    the batch is sound; the resilient loop does so within
    `RetryPolicy.max_bad_batches`."""


class NumericError(TrainingError):
    """NaN/Inf reached a fetched value (the FLAGS_check_nan_inf guard).
    The step that produced it already wrote its (poisoned) update into the
    scope, so recovery needs a state restore, not just a retry."""


class TransientDeviceError(TrainingError):
    """A device or runtime failure a later attempt may not reproduce.  On
    the card: the caching allocator out of memory.  `resource_exhausted`
    marks the out-of-memory kind, so a loop can also shed in-flight depth."""

    def __init__(self, message: str, *, code: Optional[str] = None,
                 resource_exhausted: bool = False, **kw):
        super().__init__(message, **kw)
        self.code = code
        self.resource_exhausted = bool(resource_exhausted or code == "RESOURCE_EXHAUSTED")


class PreemptionError(TrainingError):
    """The process received its preemption notice (SIGTERM).  Not an error
    to retry: flush a checkpoint, report where to resume."""


class FatalError(TrainingError):
    """Anything `classify` cannot place in a recoverable class: program
    bugs, user-code exceptions.  Never retried."""


class LockTimeoutError(FatalError):
    """A named lock's acquisition did not complete within its deadline: a
    deadlock or a lock held across blocking work, both program bugs.  The
    named locks raise it under FLAGS_lock_timeout_s (core/locks.py).  `wanted` / `wanted_rank` name the
    lock that timed out, `held` the [(name, rank), ...] the thread holds."""

    def __init__(self, message: str, *, wanted: Optional[str] = None,
                 wanted_rank: Optional[int] = None, held=None,
                 timeout_s: Optional[float] = None, **kw):
        kw.setdefault("phase", "locking")
        super().__init__(message, **kw)
        self.wanted = wanted
        self.wanted_rank = wanted_rank
        self.held = list(held or [])
        self.timeout_s = timeout_s


class ResourceError(FatalError):
    """The program cannot run within the device's memory as configured
    (phase="build"): shrink the batch, turn on remat
    (`BuildStrategy.memory_optimize`), or shard."""

    def __init__(self, message: str, *, needed_bytes: Optional[int] = None,
                 limit_bytes: Optional[int] = None, watermark_ops=None, **kw):
        kw.setdefault("phase", "build")
        super().__init__(message, **kw)
        self.needed_bytes = needed_bytes
        self.limit_bytes = limit_bytes
        self.watermark_ops = list(watermark_ops or [])


class CheckpointError(TrainingError):
    """A checkpoint cannot be loaded as asked: the saved world size differs
    from the restoring one, or a var holds state this package cannot
    continue (a JAX PRNG key where the port keeps a torch generator's
    state).  Never retried.  `saved_world` / `current_world` carry the two
    sizes when a world-size mismatch is the cause."""

    def __init__(self, message: str, *, saved_world: Optional[int] = None,
                 current_world: Optional[int] = None, **kw):
        kw.setdefault("phase", "checkpoint")
        super().__init__(message, **kw)
        self.saved_world = saved_world
        self.current_world = current_world


class StorageError(TrainingError):
    """The storage layer failed an I/O operation (phase="storage": every
    checkpoint, manifest and sidecar byte crosses the io.py choke point).
    `transient` (ENOSPC, EIO, EAGAIN, ETIMEDOUT) is retried with seeded
    backoff and, for checkpoints, degrades to lag-bounded unprotected
    training; terminal (EROFS, EACCES) skips the retries.  `op` is
    "read"/"write", `path` the failing file, `errno` the OS code."""

    def __init__(self, message: str, *, op: Optional[str] = None,
                 path: Optional[str] = None, errno: Optional[int] = None,
                 transient: Optional[bool] = None, **kw):
        kw.setdefault("phase", "storage")
        super().__init__(message, **kw)
        self.op = op
        self.path = path
        self.errno = errno
        if transient is None:
            transient = errno in TRANSIENT_STORAGE_ERRNOS
        self.transient = bool(transient)

    def __str__(self):
        base = super().__str__()
        ctx = []
        if self.op:
            ctx.append(f"op={self.op}")
        if self.errno is not None:
            ctx.append(f"errno={_errno.errorcode.get(self.errno, self.errno)}")
        ctx.append("transient" if self.transient else "terminal")
        if self.path:
            ctx.append(f"path={self.path}")
        return f"{base} [{', '.join(ctx)}]"


class ParamServerError(TrainingError):
    """The host sparse-table tier (param_server.py) failed an RPC: the
    parameter-server mirror of `StorageError`, with the same
    transient/terminal split.  Transient (connection refused or reset,
    broken pipe, socket timeout, host unreachable): the pserver died or its
    supervisor is restarting it; `KVClient` retries with reconnect and
    seeded backoff (`FLAGS_ps_retries`), and a retried push applies exactly
    once (the server dedups its sequence number).  Terminal (bad magic, a
    frame past `FLAGS_ps_max_frame_mb`, degraded mode past
    `FLAGS_max_host_lag_steps`): retrying cannot help.  `op` is the
    protocol op ("pull", "push", "create", "fetch", ...), `endpoint` the
    pserver's address, `errno` the OS code when an OSError is behind it."""

    def __init__(self, message: str, *, op: Optional[str] = None,
                 endpoint: Optional[str] = None,
                 errno: Optional[int] = None,
                 transient: Optional[bool] = None, **kw):
        kw.setdefault("phase", "pserver")
        super().__init__(message, **kw)
        self.op = op
        self.endpoint = endpoint
        self.errno = errno
        if transient is None:
            transient = errno in TRANSIENT_PS_ERRNOS
        self.transient = bool(transient)

    def __str__(self):
        base = super().__str__()
        ctx = []
        if self.op:
            ctx.append(f"op={self.op}")
        if self.errno is not None:
            ctx.append(f"errno={_errno.errorcode.get(self.errno, self.errno)}")
        ctx.append("transient" if self.transient else "terminal")
        if self.endpoint:
            ctx.append(f"endpoint={self.endpoint}")
        return f"{base} [{', '.join(ctx)}]"


class IntegrityError(TrainingError):
    """Wrong but finite state made loud.  Raised at rest: a file named by a
    checkpoint or inference-model manifest is missing, or no longer hashes
    to its recorded sha256 and byte length (`file` / `expected` /
    `actual`).  The JAX package also raises it for a live digest divergence
    across data-parallel ranks (`corrupt_ranks`, `attributed`,
    `safe_step`); the port keeps those fields for the same signature.
    Never retried in place: the state itself is poison."""

    def __init__(self, message: str, *, corrupt_ranks=None,
                 attributed: bool = True, safe_step: Optional[int] = None,
                 file: Optional[str] = None, expected: Optional[str] = None,
                 actual: Optional[str] = None, **kw):
        kw.setdefault("phase", "integrity")
        super().__init__(message, **kw)
        self.corrupt_ranks = list(corrupt_ranks or [])
        self.attributed = bool(attributed)
        self.safe_step = safe_step
        self.file = file
        self.expected = expected
        self.actual = actual

    def __str__(self):
        base = super().__str__()
        ctx = []
        if self.corrupt_ranks:
            ctx.append(f"corrupt_ranks={self.corrupt_ranks}"
                       + ("" if self.attributed else " (unattributed)"))
        if self.safe_step is not None:
            ctx.append(f"safe_step={self.safe_step}")
        if self.file:
            ctx.append(f"file={self.file}")
        return f"{base} [{', '.join(ctx)}]" if ctx else base


# runtime status codes whose failures are worth retrying (the JAX package's
# XLA codes); INVALID_ARGUMENT / INTERNAL / UNIMPLEMENTED reproduce
_TRANSIENT_CODES = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "ABORTED",
                    "DEADLINE_EXCEEDED", "CANCELLED")


class ServingError(TrainingError):
    """The serving runtime (serving/) refused or failed a request or a
    control action by design:

        reason="overload"          admission control shed the request (the
                                   bounded queue was full)
        reason="timeout"           the request's deadline expired before a
                                   batch picked it up
        reason="oversize"          more rows than the largest bucket; split it
        reason="bad_request"       the request is malformed (empty, scalar,
                                   mismatched batch dims, feed names or shapes
                                   off the model's contract): refused at the
                                   door so it never poisons a batch
        reason="publish_rejected"  a staged snapshot failed verification and
                                   was quarantined; the old model serves on
        reason="publish_io"        store I/O failed the publish (retries
                                   exhausted, or terminal): not quarantined
        reason="hbm_budget"        the model does not fit the registry's
                                   budget even after eviction
        reason="model_missing"     no model under that name
        reason="shutdown"          the server is draining or stopped
        reason="replica_down"      fleet routing (serving/router.py): the
                                   replica carrying the request died, or no
                                   healthy replica is left for new traffic

    "overload" / "timeout" are backpressure the client routes on; the rest
    are operator-facing.  `model` names the model, `trace_id` the request
    trace (serving/tracing.py) when the monitor was on."""

    def __init__(self, message: str, *, reason: Optional[str] = None,
                 model: Optional[str] = None,
                 trace_id: Optional[str] = None, **kw):
        kw.setdefault("phase", "serving")
        super().__init__(message, **kw)
        self.reason = reason
        self.model = model
        self.trace_id = trace_id

    def __str__(self):
        base = super().__str__()
        ctx = []
        if self.reason:
            ctx.append(f"reason={self.reason}")
        if self.model:
            ctx.append(f"model={self.model}")
        if self.trace_id:
            ctx.append(f"trace={self.trace_id}")
        return f"{base} [{', '.join(ctx)}]" if ctx else base

def attach_context(exc: BaseException, *, step: Optional[int] = None,
                   batch_index: Optional[int] = None,
                   phase: Optional[str] = None) -> BaseException:
    """Leave step/batch/phase breadcrumbs on an exception without changing
    its type (a sticky error keeps raising as itself).  First writer wins
    per key, so the layer closest to the failure names it."""
    try:
        ctx = exc.__dict__.setdefault("_pt_ctx", {})
    except AttributeError:  # exceptions with __slots__ / C extensions
        return exc
    for k, v in (("step", step), ("batch_index", batch_index), ("phase", phase)):
        if v is not None and ctx.get(k) is None:
            ctx[k] = v
    if isinstance(exc, TrainingError):
        for k in ("step", "batch_index", "phase"):
            if getattr(exc, k, None) is None and ctx.get(k) is not None:
                setattr(exc, k, ctx[k])
    return exc


def get_context(exc: BaseException) -> dict:
    """The breadcrumbs `attach_context` left (empty dict if none)."""
    ctx = dict(getattr(exc, "_pt_ctx", None) or {})
    if isinstance(exc, TrainingError):
        for k in ("step", "batch_index", "phase"):
            if ctx.get(k) is None and getattr(exc, k, None) is not None:
                ctx[k] = getattr(exc, k)
    return ctx


def classify(exc: BaseException, wrap_unknown: bool = False) -> BaseException:
    """Map an exception onto the taxonomy, as the JAX package does.

    Returns the exception itself when it is already a `TrainingError` or
    when no class applies (with `wrap_unknown=True`, a `FatalError` around
    it instead).  In order: the card's out-of-memory error, and a message
    carrying a transient status code, become a `TransientDeviceError`
    (RESOURCE_EXHAUSTED for the former); an OSError or TimeoutError with
    the phase="pserver" breadcrumb (the KVClient seam) a `ParamServerError`;
    an OSError with a storage errno and the phase="storage" breadcrumb a
    `StorageError`; anything with the
    loader's or the feed boundary's breadcrumb (phase "loader" / "feed") a
    `DataError`; a bare OSError with a storage errno a `StorageError`; the
    NaN guard's message a `NumericError`.  A mapped exception carries the
    original as `__cause__` and its step/batch context."""
    if isinstance(exc, TrainingError):
        return exc
    ctx = get_context(exc)
    kw = {"step": ctx.get("step"), "batch_index": ctx.get("batch_index"),
          "phase": ctx.get("phase")}

    def _wrap(cls, **extra):
        e = cls(f"{type(exc).__name__}: {exc}", **kw, **extra)
        e.__cause__ = exc
        return e

    if not isinstance(exc, Exception):  # KeyboardInterrupt / SystemExit
        return exc
    msg = str(exc)
    # checked before the loader breadcrumb: running out of device memory
    # while the producer thread stages a batch is not skippable data
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        kw["phase"] = "device"
        return _wrap(TransientDeviceError, code="RESOURCE_EXHAUSTED")
    if isinstance(exc, (RuntimeError, OSError)):
        for code in _TRANSIENT_CODES:
            if code in msg:
                kw["phase"] = "device"
                return _wrap(TransientDeviceError, code=code)
    eno = getattr(exc, "errno", None) if isinstance(exc, OSError) else None
    # checked before storage: a socket's ETIMEDOUT shares an errno with the
    # transient storage set, but the verdict (retry the RPC, or enter the
    # degraded sparse mode) is the pserver tier's
    if ctx.get("phase") == "pserver" and isinstance(exc, (OSError, TimeoutError)):
        transient = (isinstance(exc, (TimeoutError, ConnectionError))
                     or eno in TRANSIENT_PS_ERRNOS)
        return _wrap(ParamServerError, errno=eno, transient=transient)
    storage_errno = eno in TRANSIENT_STORAGE_ERRNOS or eno in TERMINAL_STORAGE_ERRNOS
    if storage_errno and ctx.get("phase") == "storage":
        return _wrap(StorageError, errno=eno, path=getattr(exc, "filename", None))
    if ctx.get("phase") in ("loader", "feed"):
        return _wrap(DataError)
    if storage_errno and ctx.get("phase") is None:
        kw["phase"] = "storage"
        return _wrap(StorageError, errno=eno, path=getattr(exc, "filename", None))
    if isinstance(exc, (RuntimeError, FloatingPointError)) and "NaN/Inf" in msg:
        return _wrap(NumericError)
    if wrap_unknown:
        return _wrap(FatalError)
    return exc
