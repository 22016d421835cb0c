"""Failure taxonomy (a subset of paddle_tpu/errors.py, same names and bases).

    TrainingError         base: RuntimeError with step / batch / phase context
    NumericError          the FLAGS_check_nan_inf guard tripped (NaN/Inf in
                          a fetched value)
    TransientDeviceError  a failure the next attempt may not see; on the
                          card, the caching allocator running out of memory
                          (`torch.cuda.OutOfMemoryError`)
    FatalError            what `classify` cannot place in a recoverable class
    ResourceError         the program cannot fit in device memory (a
                          FatalError; the port has no static planner yet)
    IntegrityError        a file named by a manifest no longer hashes to
                          its recorded sha256 and byte length (io.load_vars)

The build-time analysis failures (StaticAnalysisError and its subclasses,
FatalErrors) live with the verifier in core/analysis.py, as in the JAX
package.

`attach_context` leaves step breadcrumbs on an exception without changing
its type; `get_context` reads them; `classify` maps an exception onto the
classes above.  `pipeline.train_loop` and the executor's deferred fetches
use them.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["TrainingError", "NumericError", "TransientDeviceError", "FatalError",
           "ResourceError", "IntegrityError", "attach_context", "get_context", "classify"]


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


class FatalError(TrainingError):
    """Anything `classify` cannot place in a recoverable class: program
    bugs, user-code exceptions.  Never retried."""


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
    """Map an exception onto the taxonomy.

    Returns the exception itself when it is already a `TrainingError` or
    when no class applies (with `wrap_unknown=True`, a `FatalError` around
    it instead).  The card's out-of-memory error becomes a
    `TransientDeviceError(code="RESOURCE_EXHAUSTED")`, where the JAX
    package maps XLA's RESOURCE_EXHAUSTED; the NaN guard's message becomes
    a `NumericError`.  A mapped exception carries the original as
    `__cause__` and its step/batch context."""
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
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        kw["phase"] = "device"
        return _wrap(TransientDeviceError, code="RESOURCE_EXHAUSTED")
    if isinstance(exc, (RuntimeError, FloatingPointError)) and "NaN/Inf" in str(exc):
        return _wrap(NumericError)
    if wrap_unknown:
        return _wrap(FatalError)
    return exc
