"""File-driven datasets + train_from_dataset (counterpart of
paddle_tpu/dataset.py; the reference's data_feed.h / data_set.h, python
dataset.py InMemoryDataset / QueueDataset and Executor::RunFromDataset).

Files are native RecordIO (native/recordio.cc, through recordio.py);
`QueueDataset` parses them in the library's C++ worker threads and
assembles dense batches by memcpy (`recordio.SlotBatchReader`), falling
back to a Python thread pool for files the native queue refuses, as the
JAX package does; batches are dense feed dicts that drive the normal
executor, one `Executor.run` a batch.  Every dataset speaks the
stream-state protocol (reader.py): `state_dict()` between batches is the
count of samples consumed, and a loaded state resumes the next
`batches()` there.
"""
from __future__ import annotations

import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import recordio


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._filelist: List[str] = []
        self._use_vars: List[str] = []
        self._thread_num = 1
        self._drop_last = True
        # stream-state protocol (reader.py): samples already consumed by
        # the live batches() iterator — between batch yields this sits on
        # a batch boundary, so it is exactly the resume cursor
        self._consumed_samples = 0
        self._resume_samples = 0

    # -- reference dataset.py config surface --
    def set_batch_size(self, batch_size: int):
        self._batch_size = batch_size

    def set_thread(self, thread_num: int):
        self._thread_num = max(1, thread_num)

    def set_filelist(self, filelist: Sequence[str]):
        self._filelist = list(filelist)

    def set_use_var(self, var_list):
        self._use_vars = [v if isinstance(v, str) else v.name for v in var_list]

    @property
    def use_var_names(self):
        return list(self._use_vars)

    def _iter_samples(self, start: int = 0) -> Iterator[List[np.ndarray]]:
        raise NotImplementedError

    # -- stream-state protocol (reader.is_checkpointable) --------------------
    def checkpointable(self) -> bool:
        return True

    def state_dict(self) -> Dict[str, int]:
        return {"samples_consumed": self._consumed_samples
                or self._resume_samples}

    def load_state_dict(self, state: Dict[str, int]):
        self._resume_samples = int(state.get("samples_consumed", 0))
        self._consumed_samples = 0

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Assemble sample tuples into stacked dense feed dicts.  Resumes
        at a loaded stream state (InMemoryDataset seeks its sample list in
        O(1); generic sources skip forward)."""
        if not self._use_vars:
            raise ValueError("dataset: call set_use_var first")
        start, self._resume_samples = self._resume_samples, 0
        self._consumed_samples = start
        pulled = start
        buf: List[List[np.ndarray]] = []
        for sample in self._iter_samples(start):
            if len(sample) != len(self._use_vars):
                raise ValueError(
                    f"dataset: record has {len(sample)} slots, expected "
                    f"{len(self._use_vars)} ({self._use_vars})")
            buf.append(sample)
            pulled += 1
            if len(buf) == self._batch_size:
                self._consumed_samples = pulled
                yield {n: np.stack([s[i] for s in buf])
                       for i, n in enumerate(self._use_vars)}
                buf = []
        if buf and not self._drop_last:
            self._consumed_samples = pulled
            yield {n: np.stack([s[i] for s in buf])
                   for i, n in enumerate(self._use_vars)}


class QueueDataset(DatasetBase):
    """Streaming mode (reference MultiSlotDataFeed): files are parsed by
    native C++ worker threads (native/recordio.cc slotq_*, the reference's
    data_feed.cc MultiSlotInMemoryDataFeed role) and batches assemble by
    memcpy with the GIL released.  Dense fixed-shape slots only: ragged
    rows raise mid-stream with guidance (use use_native(False) or
    InMemoryDataset for per-sample Python parsing).  Checkpointable at
    one thread, whose queue drains the files in order."""

    _native = True

    def use_native(self, on: bool = True):
        self._native = bool(on)

    def checkpointable(self) -> bool:
        # multi-threaded parsing interleaves files irreproducibly; the
        # native queue preserves file order only at one worker thread
        return self._thread_num == 1

    def batches(self):
        if not self._use_vars:
            raise ValueError("dataset: call set_use_var first")
        if not self._native:
            yield from super().batches()
            return
        try:
            reader = recordio.SlotBatchReader(
                self._filelist, self._batch_size,
                n_threads=self._thread_num, drop_last=self._drop_last)
        except RuntimeError:
            yield from super().batches()  # unreadable-by-native/legacy files
            return
        with reader:
            if len(reader.slots) != len(self._use_vars):
                raise ValueError(
                    f"dataset: records have {len(reader.slots)} slots, "
                    f"expected {len(self._use_vars)} ({self._use_vars})")
            # the native reader fast-forwards batches itself; translate the
            # sample cursor into its batch cursor
            start, self._resume_samples = self._resume_samples, 0
            if start:
                # ceil, not floor: every batch except the trailing partial
                # one is full, so a cursor that is not a multiple of
                # batch_size can only mean that partial batch was already
                # yielded — floor would re-yield it (duplicate training data)
                reader.load_state_dict({"files": self._filelist,
                                        "batches_yielded":
                                            -(-start // self._batch_size)})
            consumed = start
            for arrays in reader:
                consumed += int(arrays[0].shape[0]) if arrays else 0
                self._consumed_samples = consumed
                yield dict(zip(self._use_vars, arrays))

    def _iter_samples(self, start: int = 0):
        import queue

        q: "queue.Queue" = queue.Queue(maxsize=4096)
        DONE = object()
        failure: list = []
        stop = threading.Event()  # set when the consumer abandons the iterator

        def parse(path):
            for sample in recordio.read_arrays(path):
                while not stop.is_set():
                    try:
                        q.put(sample, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return

        def producer():
            try:
                with ThreadPoolExecutor(self._thread_num) as pool:
                    list(pool.map(parse, self._filelist))
            except BaseException as e:  # surface parse errors to the consumer
                failure.append(e)
            finally:
                # deliver DONE unless the consumer already walked away
                while not stop.is_set():
                    try:
                        q.put(DONE, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            skipped = 0
            while True:
                item = q.get()
                if item is DONE:
                    if failure:
                        raise failure[0]
                    return
                if skipped < start:
                    skipped += 1  # streaming source: resume is a skip-forward
                    continue
                yield item
        finally:
            stop.set()  # early exit from batches(): release producer threads


class InMemoryDataset(DatasetBase):
    """reference InMemoryDataset: load all files (thread pool), optional
    local_shuffle, then iterate repeatedly."""

    def __init__(self):
        super().__init__()
        self._samples: Optional[List[List[np.ndarray]]] = None

    def load_into_memory(self):
        with ThreadPoolExecutor(self._thread_num) as pool:
            per_file = list(pool.map(lambda p: list(recordio.read_arrays(p)),
                                     self._filelist))
        self._samples = [s for rows in per_file for s in rows]

    def local_shuffle(self, seed: Optional[int] = None):
        if self._samples is None:
            raise RuntimeError("load_into_memory() first")
        random.Random(seed).shuffle(self._samples)

    def global_shuffle(self, fleet=None, seed: Optional[int] = None):
        # single-trainer fallback: same as local (the reference shuffles
        # across trainers through fleet; multi-process hook point)
        self.local_shuffle(seed)

    def _iter_samples(self, start: int = 0):
        if self._samples is None:
            raise RuntimeError("load_into_memory() first")
        yield from self._samples[start:]  # O(1) seek: it is a list


def train_from_dataset(executor, program, dataset, scope=None, fetch_list=None,
                       fetch_info=None, print_period=100):
    """Executor::RunFromDataset equivalent: drive the program from a
    Dataset's batches; returns the list of fetched values per print period.
    (Bound onto Executor as a method in core/executor.py.)"""
    fetch_list = fetch_list or []
    logs = []
    for i, feed in enumerate(dataset.batches()):
        out = executor.run(program, feed=feed, fetch_list=fetch_list, scope=scope)
        if fetch_list and (i % print_period) == 0:
            names = fetch_info or [getattr(f, "name", str(f)) for f in fetch_list]
            logs.append((i, dict(zip(names, [np.asarray(o).reshape(-1)[:4] for o in out]))))
    return logs
