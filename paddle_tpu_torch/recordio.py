"""RecordIO: chunked, CRC-checked record files (counterpart of
paddle_tpu/recordio.py, over the same C library).

The on-disk work -- chunk framing, CRC validation, record splitting, the
native slot-batch queue -- runs in `native/recordio.cc`, which the port
compiles with g++ into `paddle_tpu_torch/_build/librecordio.so` at first
use (rebuilt when the source is newer) and loads through ctypes.  A build
that fails raises, naming the compiler's error: there is no Python
scanner to fall back to.  Python adds the ndarray serde on top
(`write_arrays` / `read_arrays`: dtype and shape headers per record), the
resumable readers (`Scanner.tell` / `seek` / `state_dict`,
`RecordIOReader`, `SlotBatchReader`) and the per-run corrupt-chunk budget
(FLAGS_data_corrupt_budget).  Files written by either package read in the
other.
"""
from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import tempfile
import weakref
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .core import locks
from .monitor import MONITOR as _MON

_LIB = None
_LIB_LOCK = locks.named_lock("data.recordio_lib", rank=50)

# --- per-run corrupt-chunk budget -------------------------------------------
# A CRC-failed or truncated chunk is dropped (not fatal) while the total
# stays within FLAGS_data_corrupt_budget; every NEW drop increments the
# `data.corrupt_chunks` counter, and the first drop past the budget raises
# a terminal DataError.  Budget 0 (the default) keeps the historical strict
# behavior: the scanner raises IOError on the first corrupt chunk.
#
# Accounting is a per-source HIGH-WATER MARK, not a cumulative sum of
# drops: a multi-epoch run (or a resume's replay fast-forward) re-scans
# the same corrupt chunk every pass, and re-spending it each time would
# let ONE bad chunk exhaust any budget and kill an otherwise-healthy run.
# A source whose drop count rises past its previous high water (the rot
# spread) spends the delta.

_CORRUPT_LOCK = locks.named_lock("data.corrupt_budget", rank=52)
_CORRUPT_HW: dict = {}  # source key -> max drops observed in one pass
# scanned-chunk accounting uses the SAME high-water scheme: the
# `--max-data-corrupt-frac` gate divides corrupt by scanned, and deduping
# only the numerator would dilute the fraction by epoch count (20 epochs
# over a 30%-rotten file must still read as 0.30, not 0.015)
_SCANNED_HW: dict = {}


def corrupt_budget() -> int:
    from .flags import flag

    return int(flag("FLAGS_data_corrupt_budget"))


def corrupt_spent() -> int:
    """Distinct corrupt chunks charged so far in this run (high-water sum
    across sources — re-reads of the same chunk don't double-count)."""
    with _CORRUPT_LOCK:
        return sum(_CORRUPT_HW.values())


def reset_corrupt_spent():
    """Start a fresh budget window (a new training run).  The resilient
    loop calls this on entry; standalone consumers may too."""
    with _CORRUPT_LOCK:
        _CORRUPT_HW.clear()
        _SCANNED_HW.clear()


def _account_scanned(total_for_source: int, where: str):
    """High-water accounting of `data.chunks_scanned`, mirroring the
    corrupt counter so the corrupt/scanned fraction stays per-distinct-
    chunk regardless of how many epochs re-read the source."""
    if total_for_source <= 0:
        return
    with _CORRUPT_LOCK:
        prev = _SCANNED_HW.get(where, 0)
        if total_for_source <= prev:
            return
        delta = total_for_source - prev
        _SCANNED_HW[where] = total_for_source
    _MON.counter("data.chunks_scanned").inc(delta)


def _spend_corrupt(total_for_source: int, where: str):
    """Report one source's cumulative drop count for its current pass;
    charges only the amount above the source's high water against the
    per-run budget.  Raises a terminal DataError (`.budget_exhausted`)
    once the budget is blown — skipping unbounded amounts of data
    silently is worse than dying."""
    if total_for_source <= 0:
        return
    with _CORRUPT_LOCK:
        prev = _CORRUPT_HW.get(where, 0)
        if total_for_source <= prev:
            return  # same chunks re-dropped on a re-read: already charged
        delta = total_for_source - prev
        _CORRUPT_HW[where] = total_for_source
        spent = sum(_CORRUPT_HW.values())
    _MON.counter("data.corrupt_chunks").inc(delta)
    budget = corrupt_budget()
    if spent > budget:
        from .errors import DataError

        e = DataError(
            f"recordio: corrupt-chunk budget exceeded: {spent} corrupt/"
            f"truncated chunk(s) dropped this run, budget is "
            f"FLAGS_data_corrupt_budget={budget} (last file: {where})",
            phase="loader")
        e.budget_exhausted = True  # the resilient loop must not skip this
        raise e


_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "recordio.cc")
_SO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build", "librecordio.so")


def _compile():
    """g++ the C library into _build/ (a temporary name, then renamed, so
    concurrent processes never load a half-written file)."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        try:
            out = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
                                 capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"recordio: cannot run g++ to build {_SRC}: {e}") from e
        if out.returncode != 0:
            raise RuntimeError(f"recordio: g++ failed to build {_SRC} "
                               f"(exit {out.returncode}):\n{out.stderr.strip()}")
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _lib():
    """Compile on first use (cached under _build/), then load."""
    global _LIB
    with _LIB_LOCK:  # one build: every caller needs the library before it can go on
        if _LIB is not None:
            return _LIB
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            _compile()
        so = _SO
        lib = ctypes.CDLL(so)
        lib.rio_error.restype = ctypes.c_char_p
        lib.rio_writer_open.restype = ctypes.c_void_p
        lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.rio_write.restype = ctypes.c_int
        lib.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.rio_writer_close.restype = ctypes.c_int
        lib.rio_writer_close.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_open.restype = ctypes.c_void_p
        lib.rio_scanner_open.argtypes = [ctypes.c_char_p]
        lib.rio_next.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rio_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)]
        lib.rio_scanner_close.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_set_tolerant.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rio_scanner_corrupt_chunks.restype = ctypes.c_longlong
        lib.rio_scanner_corrupt_chunks.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_chunks_seen.restype = ctypes.c_longlong
        lib.rio_scanner_chunks_seen.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_tell.restype = ctypes.c_int
        lib.rio_scanner_tell.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_longlong),
                                         ctypes.POINTER(ctypes.c_longlong)]
        lib.rio_scanner_seek.restype = ctypes.c_int
        lib.rio_scanner_seek.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_longlong]
        lib.slotq_open.restype = ctypes.c_void_p
        lib.slotq_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.slotq_corrupt_chunks.restype = ctypes.c_longlong
        lib.slotq_corrupt_chunks.argtypes = [ctypes.c_void_p]
        lib.slotq_chunks_seen.restype = ctypes.c_longlong
        lib.slotq_chunks_seen.argtypes = [ctypes.c_void_p]
        lib.slotq_nslots.restype = ctypes.c_int
        lib.slotq_nslots.argtypes = [ctypes.c_void_p]
        lib.slotq_slot_info.restype = ctypes.c_int
        lib.slotq_slot_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
        lib.slotq_next_batch.restype = ctypes.c_longlong
        lib.slotq_next_batch.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_void_p)]
        lib.slotq_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def _check(cond, lib):
    if not cond:
        raise IOError(lib.rio_error().decode() or "recordio: unknown error")


class Writer:
    def __init__(self, path: str, max_chunk_records: int = 1024):
        lib = _lib()
        self._lib = lib
        self._h = lib.rio_writer_open(path.encode(), max_chunk_records)
        _check(self._h, lib)

    def write(self, data: bytes):
        rc = self._lib.rio_write(self._h, data, len(data))
        _check(rc == 0, self._lib)

    def close(self):
        if self._h:
            rc = self._lib.rio_writer_close(self._h)
            self._h = None
            _check(rc == 0, self._lib)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class Scanner:
    """Sequential record scanner with corruption tolerance + O(1) seek.

    `tolerant=None` (default) derives tolerance from
    `FLAGS_data_corrupt_budget > 0`: tolerant scanners DROP a CRC-failed
    chunk (and a truncated/frame-broken tail) instead of raising, spending
    the per-run budget (`data.corrupt_chunks` counter; a drop past the
    budget raises a terminal DataError).  Strict scanners keep the
    historical contract: IOError on the first corrupt chunk.

    `tell()`/`seek()` expose the native (chunk ordinal, record index)
    cursor — `state_dict()`/`load_state_dict()` ride them, making a scan
    resumable at the cost of one chunk load, not a dataset re-read.

    The native handle is released by whichever comes first: context-manager
    exit, iterator exhaustion/error, explicit `close()`, or GC (a
    `weakref.finalize`; plain iteration without the context manager used
    to leak the handle)."""

    def __init__(self, path: str, tolerant: Optional[bool] = None):
        lib = _lib()
        self._lib = lib
        self._path = path
        h = lib.rio_scanner_open(path.encode())
        _check(h, lib)
        self._h = h
        self._finalizer = weakref.finalize(self, lib.rio_scanner_close, h)
        self.tolerant = corrupt_budget() > 0 if tolerant is None else bool(tolerant)
        if self.tolerant:
            lib.rio_scanner_set_tolerant(self._h, 1)
        self._corrupt_reported = 0

    @property
    def corrupt_chunks(self) -> int:
        """Chunks this scanner dropped so far (tolerant mode)."""
        if self._h:
            return int(self._lib.rio_scanner_corrupt_chunks(self._h))
        return self._corrupt_reported

    def _settle_corrupt(self):
        """Charge newly dropped chunks against the per-run budget (may
        raise the terminal DataError).  Reports this pass's cumulative
        count; the budget's per-source high water dedupes re-reads.  The
        global lock is only touched when the local count ADVANCED."""
        n = int(self._lib.rio_scanner_corrupt_chunks(self._h))
        if n > self._corrupt_reported:
            self._corrupt_reported = n
            _spend_corrupt(n, self._path)

    def _require_open(self, op: str):
        if self._h is None:
            raise ValueError(
                f"recordio.Scanner.{op}: scanner over {self._path!r} is "
                f"closed (iteration exhaustion/error closes it; open a "
                f"fresh Scanner to rescan)")

    def tell(self):
        """(chunk ordinal, record index) of the next record."""
        self._require_open("tell")
        c, r = ctypes.c_longlong(), ctypes.c_longlong()
        self._lib.rio_scanner_tell(self._h, ctypes.byref(c), ctypes.byref(r))
        return int(c.value), int(r.value)

    def seek(self, chunk: int, record: int = 0):
        """Position so the next record is (chunk, record).  Chunk payloads
        before the target are fseek'd over (header reads only)."""
        self._require_open("seek")
        rc = self._lib.rio_scanner_seek(self._h, chunk, record)
        _check(rc == 0, self._lib)

    def state_dict(self) -> dict:
        c, r = self.tell()
        return {"chunk": c, "record": r}

    def load_state_dict(self, state: dict):
        self.seek(int(state["chunk"]), int(state.get("record", 0)))

    # drop counts only change at chunk boundaries, so the tolerant-mode
    # budget settle runs every SETTLE_EVERY records instead of every one —
    # enforcement lags by at most one stride, the per-record hot path pays
    # no extra FFI call.  EOF/error/close always settle exactly.
    SETTLE_EVERY = 64

    def __iter__(self) -> Iterator[bytes]:
        if self._h is None:
            return  # already closed (a prior pass exhausted it): clean EOF
        ln = ctypes.c_uint32()
        tick = 0
        try:
            while self._h is not None:
                ptr = self._lib.rio_next(self._h, ctypes.byref(ln))
                if not ptr:
                    err = self._lib.rio_error()
                    self._settle_corrupt()
                    if err:
                        raise IOError(err.decode())
                    return
                if self.tolerant:
                    # strict scanners can never advance the counter (a
                    # corrupt chunk raises instead): skip settling entirely
                    tick += 1
                    if tick >= self.SETTLE_EVERY:
                        tick = 0
                        self._settle_corrupt()
                yield ctypes.string_at(ptr, ln.value)
        finally:
            # exhaustion, error, or the consumer walking away (generator
            # GC -> GeneratorExit) all release the native handle
            self.close()

    def close(self):
        if self._h is None:
            return
        h, self._h = self._h, None
        # the finalizer is the single owner of the native close (it fires
        # at most once, whether called here or by GC/interpreter exit —
        # two paths fclosing one handle aborts glibc)
        if self._finalizer.alive:
            self._corrupt_reported = int(
                self._lib.rio_scanner_corrupt_chunks(h))
            _account_scanned(int(self._lib.rio_scanner_chunks_seen(h)),
                             self._path)
            self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# --- ndarray serde on top ---------------------------------------------------

def _pack_arrays(arrays: Sequence[np.ndarray]) -> bytes:
    """One record = one sample = a tuple of ndarrays (slots)."""
    parts = [struct.pack("<I", len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(a)
        dt = a.dtype.str.encode()
        parts.append(struct.pack("<I", len(dt)))
        parts.append(dt)
        parts.append(struct.pack("<I", a.ndim))
        parts.append(struct.pack(f"<{a.ndim}q", *a.shape))
        raw = a.tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _unpack_arrays(data: bytes) -> List[np.ndarray]:
    off = 0
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    out = []
    for _ in range(n):
        (dl,) = struct.unpack_from("<I", data, off)
        off += 4
        dt = np.dtype(data[off:off + dl].decode())
        off += dl
        (nd,) = struct.unpack_from("<I", data, off)
        off += 4
        shape = struct.unpack_from(f"<{nd}q", data, off)
        off += 8 * nd
        (raw_len,) = struct.unpack_from("<Q", data, off)
        off += 8
        out.append(np.frombuffer(data, dt, count=int(np.prod(shape)) if nd else 1,
                                 offset=off).reshape(shape))
        off += raw_len
    return out


def write_arrays(path: str, samples, max_chunk_records: int = 1024):
    """samples: iterable of tuples/lists of ndarrays."""
    n = 0
    with Writer(path, max_chunk_records) as w:
        for sample in samples:
            if isinstance(sample, np.ndarray):
                sample = (sample,)
            w.write(_pack_arrays(sample))
            n += 1
    return n


def read_arrays(path: str, tolerant: Optional[bool] = None) -> Iterator[List[np.ndarray]]:
    with Scanner(path, tolerant=tolerant) as s:
        for rec in s:
            yield _unpack_arrays(rec)


class RecordIOReader:
    """Decorator-style reader over one RecordIO file that speaks the
    stream-state protocol: `state_dict()` called mid-iteration returns the
    (chunk, record) position of the NEXT sample, and `load_state_dict()`
    makes the next `__call__` resume exactly there — one chunk load, not a
    replay of the file.  One live iterator per instance at a time."""

    def __init__(self, path: str, tolerant: Optional[bool] = None):
        self.path = path
        self.tolerant = tolerant
        self._resume: Optional[dict] = None
        self._live: Optional[dict] = None

    def checkpointable(self) -> bool:
        return True

    def state_dict(self) -> dict:
        if self._live is not None:
            return dict(self._live)
        if self._resume is not None:
            return dict(self._resume)
        return {"chunk": 0, "record": 0}

    def load_state_dict(self, state: dict):
        self._resume = {"chunk": int(state["chunk"]),
                        "record": int(state.get("record", 0))}
        self._live = None

    def __call__(self):
        resume, self._resume = self._resume, None
        s = Scanner(self.path, tolerant=self.tolerant)
        try:
            if resume is not None:
                s.load_state_dict(resume)
                self._live = dict(resume)
            it = iter(s)
            while True:
                try:
                    rec = next(it)
                except StopIteration:
                    return
                c, r = s.tell()  # the record AFTER the one just pulled
                self._live = {"chunk": c, "record": r}
                yield _unpack_arrays(rec)
        finally:
            s.close()


def reader_creator(path: str, tolerant: Optional[bool] = None):
    """Decorator-style reader (reference recordio_writer.py contract).
    The returned object is callable like the historical closure AND
    checkpointable (see RecordIOReader)."""
    return RecordIOReader(path, tolerant=tolerant)


class SlotBatchReader:
    """Native multithreaded batch reader (reference data_feed.cc
    MultiSlotInMemoryDataFeed role): C++ worker threads scan + parse the
    recordio slot files and slotq_next_batch memcpy-assembles dense batches
    straight into numpy buffers — the GIL is released for the entire call,
    so parsing overlaps device dispatch.  Requires every sample to repeat
    the first record's per-slot dtype/shape (dense slots); ragged data
    raises and callers fall back to the Python path."""

    def __init__(self, files, batch_size, n_threads=4, drop_last=True,
                 tolerant: Optional[bool] = None):
        lib = _lib()
        self._lib = lib
        self.files = list(files)
        self.n_threads = n_threads
        self.drop_last = drop_last
        self.tolerant = corrupt_budget() > 0 if tolerant is None else bool(tolerant)
        arr = (ctypes.c_char_p * len(files))(*[f.encode() for f in files])
        h = lib.slotq_open(arr, len(files), batch_size, n_threads,
                           1 if drop_last else 0, 1 if self.tolerant else 0)
        if not h:
            raise RuntimeError(lib.rio_error().decode())
        self._h = h
        self._finalizer = weakref.finalize(self, lib.slotq_close, h)
        self.batch_size = batch_size
        self._corrupt_reported = 0
        self._yielded = 0           # batches handed to the consumer
        self._resume_batches = 0    # batches to fast-forward on next __iter__
        self.slots = []
        n = lib.slotq_nslots(self._h)
        for s in range(n):
            buf = ctypes.create_string_buffer(32)
            shape = (ctypes.c_longlong * 8)()
            nd = ctypes.c_int()
            if lib.slotq_slot_info(self._h, s, buf, 32, shape, ctypes.byref(nd)):
                raise RuntimeError("slotq_slot_info failed")
            dt = np.dtype(buf.value.decode())
            self.slots.append((dt, tuple(int(shape[i]) for i in range(nd.value))))

    # -- stream-state protocol ----------------------------------------------
    def checkpointable(self) -> bool:
        # order is only deterministic when ONE worker drains files FIFO;
        # a multi-threaded queue interleaves files run-to-run
        return self.n_threads == 1

    def state_dict(self) -> dict:
        return {"files": list(self.files), "batches_yielded": self._yielded}

    def load_state_dict(self, state: dict):
        if list(state.get("files", self.files)) != self.files:
            raise ValueError(
                f"SlotBatchReader.load_state_dict: file list changed "
                f"(saved {state.get('files')}, this reader {self.files})")
        self._resume_batches = int(state.get("batches_yielded", 0))

    @property
    def corrupt_chunks(self) -> int:
        if self._h:
            return int(self._lib.slotq_corrupt_chunks(self._h))
        return self._corrupt_reported

    def _settle_corrupt(self):
        n = int(self._lib.slotq_corrupt_chunks(self._h))
        if n > self._corrupt_reported:
            self._corrupt_reported = n
            _spend_corrupt(n, "|".join(self.files))

    def _next_batch(self):
        bufs = [np.empty((self.batch_size,) + shp, dt)
                for dt, shp in self.slots]
        ptrs = (ctypes.c_void_p * len(bufs))(
            *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs])
        rows = self._lib.slotq_next_batch(self._h, ptrs)
        self._settle_corrupt()
        if rows < 0:
            raise RuntimeError(self._lib.rio_error().decode())
        return None if rows == 0 else [b[:rows] for b in bufs]

    def __iter__(self):
        skip, self._resume_batches = self._resume_batches, 0
        for _ in range(skip):
            # native fast-forward: batches are assembled and discarded
            # without per-sample Python work (the workers already parsed
            # them); O(batches) IO, zero Python-loop cost
            if self._next_batch() is None:
                raise RuntimeError(
                    f"SlotBatchReader: stream exhausted after "
                    f"{self._yielded} batches while fast-forwarding "
                    f"{skip} — the files must replay the same stream")
            self._yielded += 1
        while True:
            out = self._next_batch()
            if out is None:
                return
            self._yielded += 1
            yield out

    def close(self):
        if self._h is None:
            return
        h, self._h = self._h, None
        if self._finalizer.alive:  # single-owner close, same as Scanner
            self._corrupt_reported = int(self._lib.slotq_corrupt_chunks(h))
            _account_scanned(int(self._lib.slotq_chunks_seen(h)),
                             "|".join(self.files))
            self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
