"""Data feeding: reader decorators, the feed-boundary contract and the
prefetching DataLoader (counterpart of paddle_tpu/reader.py).

Stream-state protocol: every decorator here returns a callable object
that -- when its source supports it -- also implements

    state_dict()       position of the NEXT item the live iterator will
                       yield (call it between pulls)
    load_state_dict()  make the next __call__ resume exactly there

so a training run can checkpoint its data stream and resume in O(1)
instead of replaying the dataset.  `is_checkpointable` probes support;
readers whose order is irreproducible (unordered xmap, multi-threaded
native queues) answer False and callers fall back to replay.  The states
are the JAX package's, key for key, so a pickled state of one package
loads in the other.  The feed boundary is guarded by `FeedSpec`: a
dtype- or shape-mismatched (or, under FLAGS_feed_validation=full,
non-finite) feed raises a DataError naming the slot before lowering.

`DataLoader` is the one part rewritten for the card: its producer thread
validates and casts each batch on the host (declared dtype, then the x32
rule), copies it into pinned host memory and uploads it with
`non_blocking=True` on a side stream, recording an event per batch; the
consumer makes its current stream wait on that event and calls
`record_stream` on each tensor before it yields the batch.  A pinned
buffer is reused only once its event has completed.  Pinning that fails
raises: nothing stages through pageable memory quietly.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .core.dtypes import to_tensor
from .monitor import MONITOR as _MON


def _np_dtype(dtype):
    """The numpy dtype of an IR dtype name (ml_dtypes' bfloat16 for bf16)."""
    from .core.dtypes import _numpy_bfloat16, canonical_dtype

    name = canonical_dtype(dtype)
    return np.dtype(_numpy_bfloat16()) if name == "bfloat16" else np.dtype(name)


# --- stream-state protocol ---------------------------------------------------

def is_checkpointable(reader) -> bool:
    """True when `reader` speaks the stream-state protocol: state_dict /
    load_state_dict, and — if it defines a `checkpointable()` probe — that
    probe answers True (decorators over non-resumable sources keep the
    methods but answer False through the probe)."""
    probe = getattr(reader, "checkpointable", None)
    if callable(probe):
        try:
            if not probe():
                return False
        except Exception:
            return False
    return (callable(getattr(reader, "state_dict", None))
            and callable(getattr(reader, "load_state_dict", None)))


class _StatefulDecorator:
    """Base for the decorator classes below: callable exactly like the
    historical closures, plus the stream-state protocol delegated to the
    wrapped source reader(s).  One live iterator per instance at a time —
    the instance tracks that iterator's position."""

    _sources: tuple = ()

    def checkpointable(self) -> bool:
        return all(is_checkpointable(s) for s in self._sources)

    def _require_stateful(self, op: str):
        if not self.checkpointable():
            raise TypeError(
                f"{type(self).__name__}.{op}: the wrapped source reader is "
                f"not checkpointable (no state_dict/load_state_dict, or an "
                f"irreproducible order) — resume falls back to replay")


# --- reader decorators (reference: python/paddle/reader/decorator.py) ------

class _ShuffleReader(_StatefulDecorator):
    """Buffered shuffle with per-epoch reshuffling.

    The per-epoch RNG derives from `(seed, epoch)` so every epoch permutes
    differently while the whole schedule stays deterministic.  `seed=None` falls back to the program-level
    `random_seed` at iteration time, then to an unseeded RNG.  A private
    `random.Random` either way, so shuffling never perturbs the global
    `random` module's stream.

    Stream state: (epoch, source state at buffer start, RNG state at
    buffer start, offset into the current shuffled buffer).  Resume costs
    one buffer refill (`buf_size` source pulls), never a dataset replay.
    """

    def __init__(self, reader, buf_size: int, seed=None):
        self.reader = reader
        self.buf_size = buf_size
        self.seed = seed
        self._sources = (reader,)
        self._epoch = 0
        self._resume: Optional[dict] = None
        self._live: Optional[dict] = None

    def _resolve_seed(self):
        s = self.seed
        if s is None:
            try:
                from .core.program import default_main_program

                s = default_main_program().random_seed
            except Exception:
                s = None
        return s

    def state_dict(self) -> dict:
        self._require_stateful("state_dict")
        if self._live is not None:
            return dict(self._live)
        if self._resume is not None:
            return dict(self._resume)
        return {"epoch": self._epoch, "src": None, "rng": None, "offset": 0}

    def load_state_dict(self, state: dict):
        self._require_stateful("load_state_dict")
        self._resume = dict(state)
        self._live = None

    def __call__(self):
        import random

        resume, self._resume = self._resume, None
        epoch = int(resume["epoch"]) if resume is not None else self._epoch
        self._epoch = epoch + 1
        s = self._resolve_seed()
        rng = random.Random(s * 1_000_003 + epoch) if s is not None \
            else random.Random()
        src = self.reader
        stateful = is_checkpointable(src)
        skip = 0
        if resume is not None:
            if resume.get("src") is not None:
                src.load_state_dict(resume["src"])
            if resume.get("rng") is not None:
                rng.setstate(resume["rng"])
            skip = int(resume.get("offset", 0))
        it = src()
        while True:
            buf_state = {"epoch": epoch,
                         "src": src.state_dict() if stateful else None,
                         "rng": rng.getstate(), "offset": 0}
            buf = list(itertools.islice(it, self.buf_size))
            if not buf:
                if skip:
                    raise RuntimeError(
                        f"shuffle resume: source ended before the saved "
                        f"buffer position (offset {skip}) — the source must "
                        f"replay the same stream")
                self._live = buf_state  # end-of-epoch position
                return
            rng.shuffle(buf)
            if skip > len(buf):
                raise RuntimeError(
                    f"shuffle resume: saved offset {skip} exceeds the "
                    f"reconstructed buffer ({len(buf)} items) — the source "
                    f"stream changed since the state was saved")
            start, skip = skip, 0
            for i in range(start, len(buf)):
                buf_state["offset"] = i + 1
                self._live = buf_state
                yield buf[i]


def shuffle(reader: Callable, buf_size: int, seed: Optional[int] = None):
    """Buffered shuffle; see _ShuffleReader (per-epoch reshuffle, stream
    state when the source is checkpointable)."""
    return _ShuffleReader(reader, buf_size, seed)


class _BatchReader(_StatefulDecorator):
    """Stream state delegates live to the source: between batch yields the
    source sits exactly at the next batch's first sample."""

    def __init__(self, reader, batch_size: int, drop_last: bool):
        self.reader = reader
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._sources = (reader,)

    def state_dict(self) -> dict:
        self._require_stateful("state_dict")
        return {"src": self.reader.state_dict()}

    def load_state_dict(self, state: dict):
        self._require_stateful("load_state_dict")
        self.reader.load_state_dict(state["src"])

    def __call__(self):
        b = []
        for item in self.reader():
            b.append(item)
            if len(b) == self.batch_size:
                yield b
                b = []
        if b and not self.drop_last:
            yield b


def batch(reader: Callable, batch_size: int, drop_last: bool = False):
    return _BatchReader(reader, batch_size, drop_last)


class _ChainReader(_StatefulDecorator):
    """Stream state = (active reader index, its state); readers before the
    active one are skipped outright on resume."""

    def __init__(self, *readers):
        self.readers = readers
        self._sources = readers
        self._resume: Optional[dict] = None
        self._live: Optional[dict] = None

    def state_dict(self) -> dict:
        self._require_stateful("state_dict")
        if self._live is not None:
            return dict(self._live)
        if self._resume is not None:
            return dict(self._resume)
        return {"index": 0, "src": None}

    def load_state_dict(self, state: dict):
        self._require_stateful("load_state_dict")
        self._resume = dict(state)
        self._live = None

    def __call__(self):
        resume, self._resume = self._resume, None
        start = 0
        if resume is not None:
            start = int(resume["index"])
            if start < len(self.readers) and resume.get("src") is not None:
                self.readers[start].load_state_dict(resume["src"])
        for i in range(start, len(self.readers)):
            r = self.readers[i]
            stateful = is_checkpointable(r)
            it = r()
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    break
                self._live = {"index": i,
                              "src": r.state_dict() if stateful else None}
                yield item
        self._live = {"index": len(self.readers), "src": None}


def chain(*readers):
    return _ChainReader(*readers)


class _MapReader(_StatefulDecorator):
    """Stream state delegates live to the zipped sources (each advanced in
    lockstep between yields)."""

    def __init__(self, func, *readers):
        self.func = func
        self.readers = readers
        self._sources = readers

    def state_dict(self) -> dict:
        self._require_stateful("state_dict")
        return {"srcs": [r.state_dict() for r in self.readers]}

    def load_state_dict(self, state: dict):
        self._require_stateful("load_state_dict")
        for r, st in zip(self.readers, state["srcs"]):
            r.load_state_dict(st)

    def __call__(self):
        for items in zip(*[r() for r in self.readers]):
            yield self.func(*items)


def map_readers(func, *readers):
    return _MapReader(func, *readers)


class _XmapReader(_StatefulDecorator):
    """Parallel map over a reader via worker threads (decorator.py xmap).

    A mapper (or source-reader) exception must not strand the consumer: a
    worker that died without posting its END sentinel used to leave the
    consumer blocked on `out_q.get()` forever.  Workers post the exception
    itself (tagged with the sample index and a loader-phase breadcrumb for
    errors.classify), and the consumer re-raises it.

    Stream state: supported only with `order=True` over a checkpointable
    source (unordered output is irreproducible).  The feed thread snapshots
    the source state after each pull and threads it through the queues, so
    the state attached to the sample just yielded is exactly "the next
    source pull is sample i+1"; in-flight samples are re-pulled and
    re-mapped on resume."""

    def __init__(self, mapper, reader, process_num, buffer_size, order=False):
        self.mapper = mapper
        self.reader = reader
        self.process_num = process_num
        self.buffer_size = buffer_size
        self.order = order
        self._sources = (reader,)
        self._live: Optional[dict] = None

    def checkpointable(self) -> bool:
        return self.order and is_checkpointable(self.reader)

    def state_dict(self) -> dict:
        self._require_stateful("state_dict")
        if self._live is not None:
            return dict(self._live)
        return {"src": self.reader.state_dict()}

    def load_state_dict(self, state: dict):
        self._require_stateful("load_state_dict")
        self.reader.load_state_dict(state["src"])
        self._live = None

    def __call__(self):
        in_q: "queue.Queue" = queue.Queue(self.buffer_size)
        out_q: "queue.Queue" = queue.Queue(self.buffer_size)
        END = object()
        ERR = object()
        reader, mapper, process_num = self.reader, self.mapper, self.process_num
        stateful = self.checkpointable()

        def feed():
            try:
                it = reader()
                i = 0
                while True:
                    try:
                        sample = next(it)
                    except StopIteration:
                        break
                    st = reader.state_dict() if stateful else None
                    in_q.put((i, sample, st))
                    i += 1
            except BaseException as e:
                from .errors import attach_context

                out_q.put((ERR, attach_context(e, phase="loader")))
            finally:
                for _ in range(process_num):
                    in_q.put(END)

        def work():
            while True:
                s = in_q.get()
                if s is END:
                    out_q.put(END)
                    return
                i, sample, st = s
                try:
                    out_q.put((i, mapper(sample), st))
                except BaseException as e:
                    from .errors import attach_context

                    out_q.put((ERR, attach_context(e, batch_index=i,
                                                   phase="loader")))
                    out_q.put(END)  # this worker is done; keep END count right
                    return

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(self.process_num)]
        for w in workers:
            w.start()
        done = 0
        if not self.order:
            while done < self.process_num:
                item = out_q.get()
                if item is END:
                    done += 1
                    continue
                if item[0] is ERR:
                    raise item[1]
                yield item[1]
            return
        pending = {}
        next_idx = 0

        def _emit(mapped, st):
            if st is not None:
                self._live = {"src": st}
            return mapped

        while done < self.process_num:
            item = out_q.get()
            if item is END:
                done += 1
                continue
            if item[0] is ERR:
                raise item[1]
            pending[item[0]] = (item[1], item[2])
            while next_idx in pending:
                mapped, st = pending.pop(next_idx)
                yield _emit(mapped, st)
                next_idx += 1
        while next_idx in pending:
            mapped, st = pending.pop(next_idx)
            yield _emit(mapped, st)
            next_idx += 1


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    return _XmapReader(mapper, reader, process_num, buffer_size, order)


class _CacheReader(_StatefulDecorator):
    """Materializes the full reader exactly once, up front, so a partially
    consumed first epoch can't truncate later epochs.  Once materialized
    the stream state is just an index — O(1) resume regardless of the
    source (a resume in a fresh process re-materializes first, so the
    source must still replay the same stream)."""

    def __init__(self, reader):
        self.reader = reader
        self._sources = ()
        self._data: Optional[list] = None
        self._resume_index = 0
        self._live: Optional[int] = None

    def checkpointable(self) -> bool:
        return True

    def state_dict(self) -> dict:
        if self._live is not None:
            return {"index": self._live}
        return {"index": self._resume_index}

    def load_state_dict(self, state: dict):
        self._resume_index = int(state.get("index", 0))
        self._live = None

    def __call__(self):
        if self._data is None:
            self._data = list(self.reader())
        start, self._resume_index = self._resume_index, 0
        for i in range(start, len(self._data)):
            self._live = i + 1
            yield self._data[i]


def cache(reader):
    return _CacheReader(reader)


class _FirstN(_StatefulDecorator):
    def __init__(self, reader, n: int):
        self.reader = reader
        self.n = n
        self._sources = (reader,)
        self._resume: Optional[dict] = None
        self._count = 0

    def state_dict(self) -> dict:
        self._require_stateful("state_dict")
        if self._resume is not None:
            # loaded but not yet iterating: report the loaded state, not
            # the stale live count (a checkpoint taken here must not lose
            # the yielded count and over-yield past n on resume)
            return dict(self._resume)
        return {"src": self.reader.state_dict(), "yielded": self._count}

    def load_state_dict(self, state: dict):
        self._require_stateful("load_state_dict")
        self.reader.load_state_dict(state["src"])
        self._resume = dict(state)

    def __call__(self):
        resume, self._resume = self._resume, None
        self._count = int(resume.get("yielded", 0)) if resume else 0
        it = self.reader()
        while self._count < self.n:
            try:
                item = next(it)
            except StopIteration:
                return
            self._count += 1
            yield item


def firstn(reader, n):
    return _FirstN(reader, n)


# --- elastic sample sharding ------------------------------------------------

class _ShardReader(_StatefulDecorator):
    """Strided sample shard of a global stream: rank `r` of `world` yields
    exactly the samples whose GLOBAL index i satisfies i % world == r.
    Every rank iterates the same base stream and keeps its 1/world — the
    classic dp sharding that needs no index, and the ONE sharded layout
    whose cursors are exactly re-splittable when the world size changes.

    Stream state: `{"kind": "shard", rank, world, pos, base}` where `pos`
    is the next GLOBAL index this rank will examine (last yielded id + 1
    once iterating) and `base` is the wrapped reader's state at that
    position (None for a non-checkpointable base: resume then replays
    `pos` base items — loud, O(pos) — instead of seeking).

    Elastic N->M: `repartition_shard_states` merges all N ranks' cursors
    into the global consumed-prefix watermark G and deals M fresh cursors
    positioned at G — no sample dropped, none double-trained — reusing
    the highest rank's base state, which sits exactly at G.  See the
    docstring there for why that works."""

    def __init__(self, reader, rank: int, world: int):
        if not (0 <= int(rank) < int(world)):
            raise ValueError(f"shard: rank {rank} outside world {world}")
        self.reader = reader
        self.rank = int(rank)
        self.world = int(world)
        self._sources = (reader,)
        self._resume: Optional[dict] = None
        self._live: Optional[dict] = None

    def checkpointable(self) -> bool:
        # position is exact even over a stateless (but deterministic)
        # base — resume degrades to a loud replay fast-forward of `pos`
        # base items rather than an O(1) seek
        return True

    def _state(self, pos: int) -> dict:
        base = self.reader.state_dict() if is_checkpointable(self.reader) \
            else None
        return {"kind": "shard", "rank": self.rank, "world": self.world,
                "pos": int(pos), "base": base}

    def state_dict(self) -> dict:
        if self._live is not None:
            return dict(self._live)
        if self._resume is not None:
            return dict(self._resume)
        return self._state(0)

    def load_state_dict(self, state: dict):
        if state.get("kind") != "shard":
            raise ValueError(f"shard.load_state_dict: not a shard cursor "
                             f"({sorted(state)})")
        if (int(state["world"]) != self.world
                or int(state["rank"]) != self.rank):
            raise ValueError(
                f"shard.load_state_dict: cursor is for rank "
                f"{state['rank']}/{state['world']} but this reader is rank "
                f"{self.rank}/{self.world} — repartition the cursors "
                f"(reader.repartition_stream_states) instead of loading a "
                f"foreign rank's position")
        self._resume = dict(state)
        self._live = None

    def __call__(self):
        import logging

        resume, self._resume = self._resume, None
        pos = 0
        src = self.reader
        stateful = is_checkpointable(src)
        if resume is not None:
            pos = int(resume["pos"])
            if resume.get("base") is not None and stateful:
                src.load_state_dict(resume["base"])
                it = iter(src() if callable(src) else src)
            else:
                # loud replay fast-forward: the base is deterministic but
                # not seekable, so position by discarding `pos` items
                it = iter(src() if callable(src) else src)
                if pos:
                    _MON.counter("data.shard_replay").inc(pos)
                    logging.getLogger("paddle_tpu_torch.reader").warning(
                        "shard resume: base reader is not checkpointable — "
                        "replaying %d item(s) to reach global position %d "
                        "(give the shard a stateful base for an O(1) seek)",
                        pos, pos)
                    for _ in range(pos):
                        try:
                            next(it)
                        except StopIteration:
                            raise RuntimeError(
                                f"shard resume: base stream ended at item "
                                f"< {pos} while fast-forwarding — the base "
                                f"must replay the same deterministic stream")
        else:
            it = iter(src() if callable(src) else src)
        self._live = {"kind": "shard", "rank": self.rank,
                      "world": self.world, "pos": pos,
                      "base": (resume or {}).get("base")
                      if resume is not None
                      else (src.state_dict() if stateful else None)}
        while True:
            try:
                item = next(it)
            except StopIteration:
                return
            i = pos
            pos += 1
            if i % self.world == self.rank:
                self._live = self._state(pos)
                yield item


def shard(reader, rank: int, world: int):
    """Strided 1/world sample shard for `rank`; see _ShardReader (exact
    elastic cursor repartitioning when the world size changes)."""
    return _ShardReader(reader, rank, world)


def repartition_shard_states(states: Sequence[dict], new_world: int
                             ) -> List[dict]:
    """Exactly re-split N shard cursors for M ranks.

    Why this is exact: in lock-step training every rank has yielded the
    same count j of samples, so the union of everything yielded is the
    contiguous global prefix [0, G) with G = max(pos_r), and the N
    cursor positions are exactly the multiset {G, G-1, ..., G-N+1} —
    one per residue class, since rank r's last yield was ≡ r (mod N).
    (Which RANK holds the maximum depends on where the stream last
    started: a previous repartition at a watermark not divisible by N
    rotates the assignment, so the check validates the multiset plus
    each rank's residue, never a fixed rank order.)  The M new strided
    shards all start examining at G: rank r' keeps the ids >= G with
    id % M == r', which partitions [G, ...) with nothing dropped and
    nothing repeated.  The old rank whose cursor sits at G saw its last
    yield at id G-1, so its base state is exactly at G and every new
    cursor can reuse it for an O(1) seek.

    Raises ValueError when the cursors do NOT describe such a prefix
    (mixed worlds, missing ranks, unequal yield counts) — the caller
    falls back to a loud replay fast-forward or refuses, never to a
    silent approximate split."""
    import copy

    if not states:
        raise ValueError("repartition_shard_states: no cursors")
    new_world = int(new_world)
    if new_world < 1:
        raise ValueError(f"repartition_shard_states: new_world={new_world}")
    by_rank: Dict[int, dict] = {}
    world = None
    for st in states:
        if not (isinstance(st, dict) and st.get("kind") == "shard"):
            raise ValueError(
                "repartition_shard_states: cursor is not a shard state")
        w, r = int(st["world"]), int(st["rank"])
        if world is None:
            world = w
        elif w != world:
            raise ValueError(
                f"repartition_shard_states: mixed worlds {world} vs {w}")
        if r in by_rank:
            raise ValueError(f"repartition_shard_states: duplicate rank {r}")
        by_rank[r] = st
    if sorted(by_rank) != list(range(world)):
        raise ValueError(
            f"repartition_shard_states: incomplete rank set "
            f"{sorted(by_rank)} for world {world}")
    G = max(int(st["pos"]) for st in by_rank.values())
    boundary = all(int(st["pos"]) == G for st in by_rank.values())
    if not boundary:
        got = sorted(int(st["pos"]) for st in by_rank.values())
        want = list(range(G - world + 1, G + 1))
        if got != want:
            raise ValueError(
                f"repartition_shard_states: rank cursors are not a "
                f"consistent prefix (positions {got}, expected the "
                f"multiset {want} for watermark {G}) — an exact N->M "
                f"split is impossible")
        for r, st in by_rank.items():
            p = int(st["pos"])
            if (p - 1) % world != r:
                raise ValueError(
                    f"repartition_shard_states: rank {r}'s cursor at pos "
                    f"{p} is not on its own residue class (last yield "
                    f"must be ≡ {r} mod {world}) — the cursors belong to "
                    f"a different shard layout")
    donor = next(st for st in by_rank.values() if int(st["pos"]) == G)
    return [{"kind": "shard", "rank": r, "world": new_world, "pos": G,
             "base": copy.deepcopy(donor.get("base"))}
            for r in range(new_world)]


def repartition_stream_states(states: Sequence[dict], new_world: int
                              ) -> List[dict]:
    """Re-split whole-pipeline cursors N->M by descending through
    single-source decorator states (`{"src": ...}` — batch readers and
    friends) to the shard layer.  Decorators whose state is rank-local
    (shuffle buffers, chain positions) cannot sit ABOVE the shard layer
    and repartition exactly; anything below it rides along via the donor
    base state."""
    if all(isinstance(s, dict) and s.get("kind") == "shard" for s in states):
        return repartition_shard_states(states, new_world)
    if all(isinstance(s, dict) and set(s) == {"src"} for s in states):
        inner = repartition_stream_states([s["src"] for s in states],
                                          new_world)
        return [{"src": st} for st in inner]
    if all(isinstance(s, dict) and set(s) == {"srcs"}
           and len(s["srcs"]) == 1 for s in states):
        # a single-source map_readers wrapper
        inner = repartition_stream_states([s["srcs"][0] for s in states],
                                          new_world)
        return [{"srcs": [st]} for st in inner]
    raise ValueError(
        "repartition_stream_states: no shard layer found in the cursors — "
        "only pipelines of single-source decorators over reader.shard() "
        "repartition exactly")


# --- FeedSpec: the feed-boundary contract -----------------------------------

def _kind_castable(src: np.dtype, dst: np.dtype) -> bool:
    """Whether feeding `src`-typed data into a `dst`-typed slot is a
    deliberate-looking conversion (the loader has always silently cast
    int64->int32 etc.) rather than a data bug: bool/int may widen into
    int/float, float stays float — but float into an int slot, or
    object/string data anywhere, is a mistake worth dying loudly on."""
    s, d = src.kind, dst.kind
    if s == d:
        return True
    if s == "b":
        return d in "iuf"
    if s in "iu":
        return d in "iuf"
    return False


class FeedSpec:
    """Schema of the feed boundary, built from the feed variables.

    `validate(name, arr)` raises a `DataError` carrying the slot name and
    a `phase="feed"` breadcrumb BEFORE the array reaches lowering — a
    mismatched feed otherwise surfaces steps later as an opaque backend shape/
    dtype error with no pointer back to the offending slot.  Checks are
    governed by FLAGS_feed_validation: "off" (trust the caller), "shape"
    (default: dtype-kind + shape, wildcarding None/-1 spec dims), "full"
    (additionally scan floating feeds for NaN/Inf).  Names absent from the
    spec (LoD companions, extra side-channel arrays) pass through."""

    def __init__(self, feed_vars: Sequence):
        self.spec = {}
        for v in feed_vars:
            try:
                dt = _np_dtype(v.dtype)
            except Exception:
                dt = None
            shape = getattr(v, "shape", None)
            self.spec[v.name] = (dt, tuple(shape) if shape is not None else None)

    @staticmethod
    def mode() -> str:
        from .flags import flag

        return flag("FLAGS_feed_validation")

    def _fail(self, name: str, why: str):
        from .errors import DataError

        raise DataError(f"feed validation: slot {name!r} {why} "
                        f"(caught at the feed boundary, before lowering)",
                        phase="feed")

    def validate(self, name: str, arr, mode: Optional[str] = None):
        mode = self.mode() if mode is None else mode
        if mode == "off" or name not in self.spec:
            return
        want_dt, want_shape = self.spec[name]
        a = np.asarray(arr)
        if want_dt is not None and a.dtype != want_dt \
                and not _kind_castable(a.dtype, want_dt):
            self._fail(name, f"has dtype {a.dtype} which cannot feed a "
                             f"{want_dt} slot")
        if want_shape is not None:
            ok = len(a.shape) == len(want_shape) and all(
                sd is None or sd < 0 or sd == ad
                for ad, sd in zip(a.shape, want_shape))
            if not ok:
                self._fail(name, f"has shape {tuple(a.shape)}, slot expects "
                                 f"{tuple(want_shape)} (None/-1 dims are "
                                 f"wildcards)")
        if mode == "full" and a.dtype.kind == "f" and a.size \
                and not np.isfinite(a).all():
            bad = int(a.size - np.isfinite(a).sum())
            self._fail(name, f"contains {bad} non-finite value(s) "
                             f"(NaN/Inf) under FLAGS_feed_validation=full")

    def validate_feed(self, feed: Dict, mode: Optional[str] = None):
        mode = self.mode() if mode is None else mode
        if mode == "off":
            return
        for name, arr in feed.items():
            self.validate(name, arr, mode)


# --- DataFeeder (reference: data_feeder.py) --------------------------------

class DataFeeder:
    """Converts a list of per-sample tuples into a feed dict of batched
    numpy arrays keyed by the given feed variables.  Every produced batch
    passes FeedSpec validation (dtype-kind/shape, optionally finiteness)."""

    def __init__(self, feed_list: Sequence, place=None, program=None):
        self.feed_vars = list(feed_list)
        self.feed_spec = FeedSpec(self.feed_vars)

    def decorate_reader(self, reader, multi_devices=False, num_places=None,
                        drop_last=True):
        """reference DataFeeder.decorate_reader: wrap a sample-batch reader
        into a feed-dict reader (checkpointable when `reader` is)."""
        return _MapReader(self.feed, reader)

    def feed_parallel(self, iterable, num_places=None):
        """reference DataFeeder.feed_parallel: one global feed dict serves
        the one device, so this is feed()."""
        for item in iterable:
            yield self.feed(item)

    def feed(self, samples: Iterable) -> Dict[str, np.ndarray]:
        mode = FeedSpec.mode()
        cols = None
        for sample in samples:
            if cols is None:
                cols = [[] for _ in sample]
            for i, v in enumerate(sample):
                cols[i].append(np.asarray(v))
        out = {}
        for var, col in zip(self.feed_vars, cols):
            arr = np.stack(col)
            want = _np_dtype(var.dtype)
            if arr.dtype != want:
                if not _kind_castable(arr.dtype, np.dtype(want)) \
                        and mode != "off":
                    self.feed_spec._fail(
                        var.name, f"has dtype {arr.dtype} which cannot feed "
                                  f"a {np.dtype(want)} slot")
                arr = arr.astype(want)
            shape = var.shape
            if shape is not None and len(shape) == arr.ndim + 1 and shape[-1] == 1:
                arr = arr[..., None]  # fluid's trailing label dim
            self.feed_spec.validate(var.name, arr, mode)
            out[var.name] = arr
        return out


# --- prefetching loader (PyReader / buffered_reader equivalent) ------------

class _PinnedPool:
    """Pinned host buffers by (feed name, shape, dtype), each with the event
    of the upload that last read it: a buffer is handed out again only once
    that event has completed, so the producer never overwrites bytes a copy
    still has to read.  Keyed by feed: two feeds of one batch with the same
    shape and dtype (BERT's token, position and label ids) never share a
    buffer while the batch's event is not yet recorded."""

    def __init__(self, per_key: int):
        self.per_key = per_key
        # key -> [[tensor, event of its last upload, upload ordinal], ...]
        self.bufs: Dict[tuple, List[list]] = {}

    def take(self, name: str, shape, dtype) -> list:
        slots = self.bufs.setdefault((name, tuple(shape), dtype), [])
        for slot in slots:
            if slot[1] is None or slot[1].query():
                return slot
        if len(slots) < self.per_key:
            try:
                t = torch.empty(shape, dtype=dtype, pin_memory=True)
            except RuntimeError as e:
                raise RuntimeError(
                    f"DataLoader: cannot pin {int(np.prod(shape)) * dtype.itemsize} bytes of "
                    f"host memory for a {tuple(shape)} {dtype} feed ({e}); the loader "
                    f"does not stage through pageable memory") from e
            slots.append([t, None, 0])
            return slots[-1]
        slot = min(slots, key=lambda s: s[2])  # the oldest upload finishes first
        slot[1].synchronize()
        return slot


class DataLoader:
    """Background-thread device prefetcher.

    `from_generator` mirrors fluid.io.DataLoader / PyReader: wrap a batch
    generator (yielding feed dicts or tuples), get an iterator of feed
    dicts of tensors on `device`, `capacity` batches deep.  `device` is a
    Place (or a torch.device); None means `CUDAPlace(0)`, which raises on
    a machine without a card, as `Executor()` does.

    On the card every batch is staged through pinned host memory and
    uploaded on the loader's own stream (see the module docstring); on the
    CPU the batch is a private host copy.  Checkpointable when the
    generator is: the producer thread snapshots the generator's stream
    state after each pull and threads it through the prefetch queue with
    its batch, so `state_dict()` on the consumer side reflects exactly the
    batches the consumer has seen.  Every staged feed passes FeedSpec
    validation before it is placed.  `sharding` (a data-parallel layout)
    comes with ROADMAP A10 and raises."""

    def __init__(self, feed_list: Sequence, capacity: int = 2, device=None, sharding=None):
        if sharding is not None:
            raise NotImplementedError(
                "DataLoader(sharding=...): sharded feeds come with data parallelism "
                "(ROADMAP A10); the port runs one device")
        if device is None:
            from .core.executor import CUDAPlace

            device = CUDAPlace(0)
        self.device = device.device if hasattr(device, "device") else torch.device(device)
        self.feed_vars = list(feed_list)
        self.feed_spec = FeedSpec(self.feed_vars)
        self.capacity = capacity
        self._gen: Optional[Callable] = None
        self._resume_state = None
        self._consumed_state = None
        self._uploads = 0
        on_card = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if on_card else None
        # a buffer a batch in the queue, one the consumer holds, one being filled
        self._pool = _PinnedPool(capacity + 2) if on_card else None

    @staticmethod
    def from_generator(feed_list: Sequence, capacity: int = 2, device=None, sharding=None,
                       iterable: bool = True):
        return DataLoader(feed_list, capacity, device, sharding)

    def set_batch_generator(self, gen: Callable):
        self._gen = gen
        return self

    def set_sample_list_generator(self, gen: Callable):
        feeder = DataFeeder(self.feed_vars)
        # a _MapReader keeps the stream-state protocol flowing through the
        # sample-list -> feed-dict conversion
        self._gen = _MapReader(feeder.feed, gen)
        return self

    # -- stream-state protocol ----------------------------------------------
    def checkpointable(self) -> bool:
        return self._gen is not None and is_checkpointable(self._gen)

    def state_dict(self) -> dict:
        if not self.checkpointable():
            raise TypeError("DataLoader.state_dict: the batch generator is "
                            "not checkpointable")
        if self._consumed_state is not None:
            return self._consumed_state
        return self._gen.state_dict()

    def load_state_dict(self, state: dict):
        if not self.checkpointable():
            raise TypeError("DataLoader.load_state_dict: the batch generator "
                            "is not checkpointable")
        self._resume_state = state
        self._consumed_state = state

    def _stage(self, arrays: Dict[str, np.ndarray]):
        """Place one batch: (tensors, event).  On the card each array goes
        into a pinned buffer free of earlier uploads, then to the device on
        the loader's stream; the event marks the end of the batch's copies.
        On the CPU each tensor is a private copy."""
        if self._stream is None:
            return {n: to_tensor(np.array(a)) for n, a in arrays.items()}, None
        placed, used = {}, []
        with torch.cuda.device(self.device):
            for n, a in arrays.items():
                src = to_tensor(a)  # a host view of the array (bf16 by its bits)
                slot = self._pool.take(n, src.shape, src.dtype)
                slot[0].copy_(src)
                used.append(slot)
                with torch.cuda.stream(self._stream):
                    placed[n] = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                    placed[n].copy_(slot[0], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._uploads += 1
        for slot in used:
            slot[1], slot[2] = event, self._uploads
        return placed, event

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        if self._gen is None:
            raise RuntimeError("DataLoader: call set_batch_generator first")
        q: "queue.Queue" = queue.Queue(self.capacity)
        END = object()
        name_dtypes = {v.name: _np_dtype(v.dtype) for v in self.feed_vars}
        self._uploads = 0

        stateful = self.checkpointable()
        if self._resume_state is not None:
            self._gen.load_state_dict(self._resume_state)
            self._resume_state = None

        stop = threading.Event()

        def _put(item) -> bool:
            """put that gives up when the consumer abandoned the iterator,
            so the producer can't block forever holding device buffers."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            produced = 0
            try:
                src = iter(self._gen())
                vmode = FeedSpec.mode()
                while True:
                    try:
                        item = next(src)
                    except StopIteration:
                        break
                    if stop.is_set():
                        return
                    # state AFTER this pull == "the next batch is item+1";
                    # it travels with the batch, so the consumer-side state
                    # advances only when the consumer receives it
                    st = self._gen.state_dict() if stateful else None
                    if not isinstance(item, dict):
                        item = {v.name: a for v, a in zip(self.feed_vars, item)}
                    arrays = {}
                    nbytes = 0
                    for n, a in item.items():
                        a = np.asarray(a)
                        # FeedSpec guard: a mismatched feed dies here, named
                        self.feed_spec.validate(n, a, vmode)
                        want = name_dtypes.get(n)
                        if want is not None and a.dtype != want:
                            a = a.astype(want)
                        if a.dtype == np.int64:  # the x32 rule
                            a = a.astype(np.int32)
                        elif a.dtype == np.float64:
                            a = a.astype(np.float32)
                        nbytes += a.nbytes
                        arrays[n] = a
                    placed = self._stage(arrays)
                    _MON.counter("reader.bytes_staged").inc(nbytes)
                    if not _put((placed, st)):
                        return
                    produced += 1
            except BaseException as e:  # propagate to the consumer thread
                # raised as itself in the consumer; the breadcrumb routes it
                # through errors.classify as a DataError
                from .errors import attach_context

                _put(("__error__", attach_context(e, batch_index=produced,
                                                  phase="loader")))
            finally:
                _put(END)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                # checked per batch: enabling the monitor mid-run starts
                # producing wait spans from the live iterator
                if _MON.enabled:
                    # consumer-side starvation: time blocked on the queue
                    _MON.gauge("reader.queue_depth").set(q.qsize())
                    t0 = time.perf_counter()
                    item = q.get()
                    _MON.observe("reader.wait", time.perf_counter() - t0)
                else:
                    item = q.get()
                if item is END:
                    return
                if isinstance(item, tuple) and len(item) == 2 and isinstance(item[0], str) \
                        and item[0] == "__error__":
                    # the producer's exception as itself: its traceback still
                    # points at the generator frame
                    raise item[1]
                (placed, event), st = item
                if event is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(event)
                    for tensor in placed.values():
                        tensor.record_stream(cur)
                if st is not None:
                    # set before the yield: once the consumer holds the
                    # batch, "next batch" is the attached state
                    self._consumed_state = st
                _MON.counter("reader.batches").inc()
                yield placed
        finally:
            # consumer exited (break/exception/GC): release the producer
            stop.set()


# PyReader is the reference's older name for the same machinery.
PyReader = DataLoader
