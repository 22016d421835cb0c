"""Executor: cached plans of whole programs, replayed as CUDA graphs on the
card (counterpart of paddle_tpu/core/executor.py).

`run()` casts each feed to its var's dtype and through the x32 rule, as
the JAX package does, and keys a `_Plan` on what the JAX package keys its
compiled step on (program uuid and version, the sorted (feed, shape, dtype)
triples, the fetch names, the scope's uuid, `steps`, remat and the lowering
flags).  It keeps the plans in an LRU cache of
FLAGS_executor_cache_capacity entries, counting `executor.cache_hit` /
`executor.cache_miss` in the monitor; a miss first runs the program
verifier under FLAGS_verify_program (core/analysis.py `check_program`, in
an `analysis.verify` span).  A
plan holds the pruned ops (those that feed a fetch or write a persistable,
the sub-block of a `while`, `conditional_block` or `dynamic_rnn` op
counted as its own reads and writes), the names
they read, and the persistables they write back.

A plan runs its ops' torch lowerings in order (core/lowering.py); a
program with `backward` ops runs its regions through
`torch.autograd.grad`.  Nothing runs under `torch.inference_mode()`: the
Scope keeps its tensors across runs, trainable.  The generator in the
Scope advances across runs.  A fetched SelectedRows gradient comes back
as its dense view, or as the SelectedRows itself with return_numpy=False.
A ragged feed (a `LoDTensor`) becomes its padded carrier and lengths
(paddle_tpu_torch/lod.py), so its bucket is part of the key.

On the card, the counterpart of the JAX package's one dispatch a step is a
CUDA graph.  The first run of a plan runs eagerly on a side stream (the
warm-up); the second captures one step with `torch.cuda.graph` and every
run from then on copies its feeds into the plan's static buffers and
replays it.  The scope's generator, and the rerun generators the lowering
draws repeated forwards from, are registered with the graph, so each
replay draws new dropout masks.  A persistable whose update is a new
tensor (Momentum, SGD, the beta pows, batch norm's running statistics) is
copied back into the tensor the scope holds inside the graph: after a
replay the scope holds the same tensor objects as before.  When some
`set_var` happened since a plan's last run (`scope.writes()`), the plan
copies a replaced state tensor into the one it captured, or captures anew
if its shape or dtype changed.  Whether a plan can be captured is decided
from its ops before capture (`_graph_refusal`): a `while` op, whose
condition the host reads every iteration, a `conditional_block` (its
predicate), the tensor-array reads and writes (their index), and
SelectedRows gradients, whose merge waits for the card, run eagerly, with
the reason in `plan.graph_refusal` and the counter
`executor.graph_refused`.  A capture
or replay that fails raises.

`warm(...)` is `run` repeated until the step's plan holds its graph (the
serving registry warms its buckets with it); `release_scope(scope)` drops
every plan of a scope, its graph and its graph's memory pool with it (the
serving registry calls it when it lets a model version go).

`steps=K` runs K steps from feeds stacked on a leading [K] axis, uploaded
once, and returns fetches stacked the same way; `run_async` returns
`FetchHandle`s as soon as the step is enqueued, and the host copy, through
pinned memory, and the FLAGS_check_nan_inf guard happen at resolution.
"""
from __future__ import annotations

import gc
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import flags
from ..errors import NumericError, classify
from ..lod import LoDTensor, LoDTensorArray, lod_var_name
from ..monitor import MONITOR as _MON
from ..ops import cuda_kernels
from ..ops.common import canon_dtype
from . import scope as scope_mod
from .dtypes import host_copies, to_tensor
from .lowering import LoweringContext, rerun_generators_needed, run_block_with_backward
from .program import Program, Variable, default_main_program
from .scope import RNG_STATE_VAR, Scope, global_scope
from .selected_rows import SelectedRows


class Place:
    device: torch.device


class CUDAPlace(Place):
    """A CUDA device, `torch.device(f"cuda:{device_id}")`.  Raises when the
    machine has no such card: nothing falls back to the CPU quietly."""

    def __init__(self, device_id: int = 0):
        if not torch.cuda.is_available():
            raise RuntimeError(f"CUDAPlace({device_id}): no CUDA device is available; "
                               "pass CPUPlace() to run on the CPU")
        if not 0 <= device_id < torch.cuda.device_count():
            raise RuntimeError(f"CUDAPlace({device_id}): only {torch.cuda.device_count()} "
                               "CUDA device(s)")
        self.device_id = device_id
        self.device = torch.device(f"cuda:{device_id}")

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


# scripts written for the JAX package name TPUPlace; here it is the card
TPUPlace = CUDAPlace


class CPUPlace(Place):
    def __init__(self):
        self.device_id = 0
        self.device = torch.device("cpu")

    def __repr__(self):
        return "CPUPlace()"


class CUDAPinnedPlace(Place):
    """Host memory for staging uploads to the card: a program run there runs
    on the CPU (the loaders pin their own staging buffers)."""

    def __init__(self):
        self.device_id = 0
        self.device = torch.device("cpu")

    def __repr__(self):
        return "CUDAPinnedPlace()"


def cpu_places(device_count=None):
    """`device_count` CPU places (default: $CPU_NUM, else 1)."""
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """A CUDAPlace for each of `device_ids` (default: every card there is;
    none on a machine without one)."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


def cuda_pinned_places(device_count=None):
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CUDAPinnedPlace() for _ in range(n)]


def _runnable_ops(block):
    return [op for op in block.ops if op.type not in ("feed", "fetch")]


_SUB_BLOCK_OPS = ("while", "conditional_block", "dynamic_rnn")


def _effective_io(op):
    """(reads, writes) of `op`, the sub-block of a `while`,
    `conditional_block` or `dynamic_rnn` op included: a parameter that only
    such a body reads is kept, and its slot read."""
    reads = list(op.input_arg_names)
    writes = list(op.output_arg_names)
    if op.type in _SUB_BLOCK_OPS:
        for sop in op.block.program.blocks[op.attr("sub_block")].ops:
            r, w = _effective_io(sop)
            reads.extend(r)
            writes.extend(w)
    return reads, writes


def _prune(ops, fetch_names, persistable):
    """Fetch-driven dead-op elimination: keep an op if it (transitively)
    feeds a fetch or writes a persistable var, counting the sub-blocks of
    control-flow ops.  A kept `backward` op needs its loss and its parameters."""
    needed = set(fetch_names)
    kept = []
    for op in reversed(ops):
        reads, outs = _effective_io(op)
        if any(o in persistable or o in needed for o in outs):
            kept.append(op)
            needed.update(reads)
            if op.type == "backward":
                needed.add(op.attrs["loss_name"])
                needed.update(op.attrs.get("param_names", []))
    kept.reverse()
    return kept


def _read_names(ops):
    """Every name the ops read, the sub-blocks of control-flow ops and a
    `backward` op's parameters included."""
    names = set()
    for op in ops:
        names.update(_effective_io(op)[0])
        if op.type == "backward":
            names.update(op.attrs.get("param_names", []))
    return names


def _with_sub_blocks(ops):
    """`ops` and, recursively, the ops of their sub-blocks."""
    for op in ops:
        yield op
        if op.type in _SUB_BLOCK_OPS:
            yield from _with_sub_blocks(op.block.program.blocks[op.attr("sub_block")].ops)


_HOST_READ = {
    "while": "a while op: its condition is read on the host every iteration "
             "(core/lowering.py run_while)",
    "conditional_block": "a conditional_block op: its predicate is read on the host to pick "
                         "the branch (core/lowering.py run_conditional_block)",
    "array_write": "a tensor-array op: array_write reads its index on the host "
                   "(ops/control_flow_ops.py)",
    "array_read": "a tensor-array op: array_read reads its index on the host "
                  "(ops/control_flow_ops.py)",
    "print": "a print op: it copies its input to the host to print it at execution "
             "(ops/nn_ops.py)",
    "py_func": "a py_func op: its Python callable runs on host copies of its inputs "
               "(ops/control_flow_ops.py)",
    "detection_map": "a detection_map op: the mAP is computed on the host from host copies "
                     "of the detections and labels (ops/detection_ops.py)",
    "generate_mask_labels": "a generate_mask_labels op: its polygons are rasterized on the "
                            "host from host copies (ops/detection_ops.py)",
    "chunk_eval": "a chunk_eval op: its chunks are counted on the host from host copies of "
                  "the tags (ops/misc_ops.py)",
    "merge_selected_rows": "a merge_selected_rows op: merging SelectedRows rows calls "
                           "torch.unique_consecutive, which waits for the card "
                           "(core/selected_rows.py)",
}


def _graph_refusal(ops) -> Optional[str]:
    """Why a plan's step cannot be captured as a CUDA graph, read off its
    ops (and their sub-blocks') before any capture; None when it can."""
    for op in _with_sub_blocks(ops):
        if op.type in _HOST_READ:
            return _HOST_READ[op.type]
    for op in ops:
        if op.type == "backward" and set(op.attrs.get("sparse_param_names", [])) & set(
                op.attrs.get("param_names", [])):
            return ("SelectedRows gradients: merging their rows calls torch.unique_consecutive, "
                    "which waits for the card (core/selected_rows.py)")
    return None


def _lowering_flags():
    """Process-wide switches that change the kernels a step runs; part of
    the plan key, since a captured graph keeps the kernels it was captured
    with."""
    return ("tf32", torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            "cudnn", torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)


def _expand_ragged_feeds(block, feed, steps=1):
    """A `LoDTensor`, or a list of per-sequence arrays fed to a var declared
    with lod_level >= 1, becomes the padded carrier (time axis bucketed,
    lod.bucket_length) and the int32 lengths `<name>@LOD`."""
    out = {}
    for name, value in feed.items():
        declared_ragged = block.has_var(name) and block.var(name).lod_level >= 1
        if isinstance(value, LoDTensor) or (
                declared_ragged and isinstance(value, (list, tuple)) and len(value) > 0
                and all(isinstance(s, np.ndarray) for s in value)):
            if steps > 1:
                raise ValueError(
                    f"steps>1 does not support ragged/LoDTensor feeds (got one for "
                    f"'{name}'): the padded expansion has no [steps] axis. Stack "
                    f"pre-padded dense arrays [steps, b, T, ...] plus the lengths "
                    f"companion instead, or run with steps=1.")
            lt = value if isinstance(value, LoDTensor) else LoDTensor(value)
            out[name], out[lod_var_name(name)] = lt.padded(bucket=True)
        else:
            out[name] = value
    return out


def _array_host_copy(arr):
    """A fetched tensor array as numpy arrays; an index never written stays None."""
    copies = iter(host_copies([t for t in arr if t is not None]))
    return LoDTensorArray(None if t is None else next(copies) for t in arr)


def _dense(t):
    return t.to_dense() if isinstance(t, SelectedRows) else t


class _Plan:
    """One cached step: the pruned ops of (program version, feeds, fetches,
    scope, steps, remat), run eagerly or, on the card, replayed from a
    CUDA graph captured at its second run."""

    def __init__(self, program: Program, fetch_names: Sequence[str], device: torch.device,
                 steps: int, remat: bool, graphs: bool):
        block = program.global_block()
        self.persistable = frozenset(v.name for v in program.list_vars() if v.persistable)
        self.ops = _prune(_runnable_ops(block), fetch_names, self.persistable)
        self.read_names = frozenset(_read_names(self.ops))
        self.fetch_names = list(fetch_names)
        self.state_names = sorted((self.read_names | set(fetch_names)) & self.persistable)
        self.written = list(dict.fromkeys(
            n for op in self.ops for n in _effective_io(op)[1] if n in self.persistable))
        if steps > 1:
            missing = [n for n in self.written if n not in self.read_names]
            if missing:
                raise ValueError(f"steps>1 needs write-back state to be read by the program "
                                 f"too; write-only persistables: {missing}")
        self.device = device
        self.remat = remat
        self.program_u8 = program._uuid[:8]
        self.constants: dict = {}
        self.rerun = [torch.Generator(device=device)
                      for _ in range(rerun_generators_needed(self.ops, remat))]
        on_card = graphs and device.type == "cuda"
        self.graph_refusal = _graph_refusal(self.ops) if on_card else None
        self.graphable = on_card and self.graph_refusal is None
        if self.graph_refusal is not None:
            _MON.counter("executor.graph_refused").inc()
        self.runs = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captured_launches: Optional[Dict[str, int]] = None
        self._lock = threading.Lock()  # one replay at a time: the buffers are shared
        self._static_feeds: Dict[str, torch.Tensor] = {}
        self._static_outs: List[torch.Tensor] = []
        self._state: Dict[str, torch.Tensor] = {}  # what the graph reads and writes
        self._gen: Optional[torch.Generator] = None
        self._seen_writes = -1

    @property
    def graphed(self) -> bool:
        return self.graph is not None

    def _context(self, gen: torch.Generator) -> LoweringContext:
        return LoweringContext(gen, self.device, fetch_names=self.fetch_names,
                               read_names=self.read_names, rerun_generators=self.rerun,
                               persistable=self.persistable, constants=self.constants,
                               remat=self.remat)

    def _state_env(self, scope: Scope) -> Dict[str, torch.Tensor]:
        env = {}
        for name in self.state_names:
            v = scope.find_var(name)
            if v is None:
                continue  # written by this run (startup) or reported missing by the op
            if not isinstance(v, torch.Tensor) or v.device != self.device:
                v = to_tensor(v, None, self.device)  # host arrays, other devices
                scope.set_var(name, v)
            env[name] = v
        return env

    def _outputs(self, env) -> List[object]:
        missing = [n for n in self.fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not produced by the program")
        # a fetched persistable is copied: a later step may update it in place
        return [env[n] if isinstance(env[n], SelectedRows)
                else LoDTensorArray(t if t is None else t.detach() for t in env[n])
                if isinstance(env[n], list)
                else env[n].detach().clone() if n in self.persistable else env[n].detach()
                for n in self.fetch_names]

    def run(self, scope: Scope, gen: torch.Generator, feeds: Dict[str, torch.Tensor],
            side_stream) -> List[object]:
        """One step from `feeds` (tensors on the plan's device); returns the
        fetches, tensors the caller may keep."""
        for r in self.rerun:  # every repeated forward starts where this step does
            r.set_state(gen.get_state())
        if not self.graphable:
            return self._eager(scope, gen, feeds)
        with self._lock:
            if self.graph is not None and not self._state_current(scope, gen):
                self._drop_graph()
            if self.runs == 0:
                outs = self._warm_up(scope, gen, feeds, side_stream)
            else:
                if self.graph is None:
                    self._capture(scope, gen, feeds)
                outs = self._replay(feeds)
            self._seen_writes = scope_mod.writes()
            return outs

    def _eager(self, scope, gen, feeds):
        env = self._state_env(scope)
        env.update(feeds)
        env = run_block_with_backward(self._context(gen), self.ops, env)
        for n in self.written:
            if n in env:
                scope.set_var(n, env[n])
        self.runs += 1
        return self._outputs(env)

    def _warm_up(self, scope, gen, feeds, side_stream):
        """The first run: eager, on a side stream, as torch.cuda.graph asks
        (lazy initialisations happen outside the capture)."""
        cur = torch.cuda.current_stream(self.device)
        side_stream.wait_stream(cur)
        with torch.cuda.stream(side_stream):
            outs = self._eager(scope, gen, feeds)
        cur.wait_stream(side_stream)
        return outs

    def _capture(self, scope, gen, feeds):
        state = self._state_env(scope)
        # two names holding one storage would stay coupled in the graph
        seen = {}
        for n, t in state.items():
            if t.data_ptr() in seen:
                t = t.clone()
                scope.set_var(n, t)
                state[n] = t
            seen[t.data_ptr()] = n
        targets = {n: scope.find_var(n) for n in self.written}
        targets = {n: t for n, t in targets.items() if isinstance(t, torch.Tensor)}
        self._static_feeds = {n: v.clone() for n, v in feeds.items()}
        graph = torch.cuda.CUDAGraph()
        for g in [gen] + self.rerun:
            graph.register_generator_state(g)
        before = dict(cuda_kernels.LAUNCHES)
        # thread_local: a DataLoader's producer thread may allocate, pin
        # and upload the next batches on its own stream while this thread
        # captures; only this thread's calls are checked against the capture.
        # No garbage collection inside it: a collection that frees another
        # plan's graph would reset that graph mid-capture, which CUDA does
        # not permit (the capture then fails); torch.cuda.graph collects
        # before it begins
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                env = dict(state)
                env.update(self._static_feeds)
                env = run_block_with_backward(self._context(gen), self.ops, env)
                outs = self._outputs(env)
                # an output that is another target's tensor is read before the copies
                srcs = {n: env[n] for n in targets if n in env}
                ids = {id(t) for t in targets.values()}
                for n, v in srcs.items():
                    if v is not targets[n] and id(v) in ids:
                        srcs[n] = v.clone()
                for n, v in srcs.items():
                    if v is not targets[n]:
                        targets[n].copy_(v)
        finally:
            if collecting:
                gc.enable()
        self.captured_launches = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
        self._static_outs = outs
        self._state = {**state, **targets}
        self._gen = gen
        self.graph = graph
        _MON.counter("executor.graph_capture").inc()

    def _replay(self, feeds):
        for n, v in feeds.items():
            self._static_feeds[n].copy_(v, non_blocking=True)
        self.graph.replay()
        self.runs += 1
        _MON.counter("executor.graph_replay").inc()
        # the static outputs are overwritten by the next replay
        return [t.clone() for t in self._static_outs]

    def _state_current(self, scope, gen) -> bool:
        """Is the captured state still the scope's?  Checked only when some
        set_var happened since this plan's last run.  A replaced tensor of
        the same shape and dtype is copied into the captured one, which the
        scope then holds again; anything else needs a new capture."""
        if gen is not self._gen:
            return False
        if scope_mod.writes() == self._seen_writes:
            return True
        for n, t in self._state.items():
            v = scope.find_var(n)
            if v is t:
                continue
            if not (isinstance(v, torch.Tensor) and v.shape == t.shape and v.dtype == t.dtype):
                return False
            t.copy_(v)
            scope.set_var(n, t)
        return True

    def _drop_graph(self):
        self.graph = None
        self._static_feeds, self._static_outs, self._state = {}, [], {}
        self.runs = 0  # the next run warms up and the one after captures


class _PendingFetches:
    """Shared state behind the FetchHandles of one `run_async` dispatch:
    the in-flight fetch tensors and a CUDA event recorded after them.
    Resolution happens at most once; an error raised during it is sticky,
    so every handle of the dispatch reports the same failure."""

    __slots__ = ("fetch_names", "fetches", "event", "program_u8", "_np", "_exc", "_done")

    def __init__(self, fetch_names, fetches, event, program_u8):
        self.fetch_names = list(fetch_names)
        self.fetches = list(fetches)
        self.event = event
        self.program_u8 = program_u8
        self._np = None
        self._exc = None
        self._done = False

    @property
    def want_names(self):
        return self.fetch_names

    def wait(self):
        """Block until the dispatched step has run on the card: no host copy."""
        if self.event is not None:
            self.event.synchronize()

    def ready(self) -> bool:
        """Non-blocking readiness probe."""
        return self.event is None or self.event.query()

    def resolve(self):
        """The fetches as numpy (first call only), through pinned host
        memory, then the NaN/Inf guard.  An in-flight error raises here,
        not at dispatch; the scope already holds the step's state."""
        if self._done:
            if self._exc is not None:
                raise self._exc
            return self._np
        t0 = time.perf_counter()
        try:
            vals = host_copies([_dense(t) for t in self.fetches])
            Executor._check_nan_inf(self.fetch_names, vals)
            self._np = vals
        except BaseException as e:
            ce = classify(e)
            self._exc = ce
            if ce is e:
                raise
            raise ce from e
        finally:
            # one-shot: drop the device buffers so a kept handle pins nothing
            self._done = True
            self.fetches = []
            self.event = None
        _MON.observe("executor.fetch", time.perf_counter() - t0, program=self.program_u8)
        return self._np


class FetchHandle:
    """Lazy fetch result from `Executor.run_async`: one output of a dispatch
    still in flight on the card.  The host copy (and the NaN/Inf guard)
    happens on first access: `numpy()`, `np.asarray(handle)`, `float(handle)`."""

    __slots__ = ("_pending", "_idx", "name")

    def __init__(self, pending: _PendingFetches, idx: int, name: str):
        self._pending = pending
        self._idx = idx
        self.name = name

    def numpy(self) -> np.ndarray:
        return self._pending.resolve()[self._idx]

    def wait(self):
        """Block until the step has run on the card, WITHOUT a host copy."""
        self._pending.wait()
        return self

    def block_until_ready(self):
        return self.wait()

    def is_ready(self) -> bool:
        return self._pending._done or self._pending.ready()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __float__(self):
        return float(np.asarray(self.numpy()).reshape(-1)[0])

    def __repr__(self):
        state = "resolved" if self._pending._done else "in-flight"
        return f"FetchHandle({self.name!r}, {state})"


class Executor:
    """`Executor(place).run(program, feed, fetch_list, scope, return_numpy, steps)`.

    `_graphs=False` keeps every plan eager on the card: the eager-versus-
    graphed comparisons of the tests and chip_smoke.py use it."""

    def __init__(self, place: Optional[Place] = None, _graphs: bool = True):
        self.place = place if place is not None else CUDAPlace(0)
        self._graphs = _graphs
        self._cache: "OrderedDict[tuple, _Plan]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self._side_stream = None
        self.last_plan: Optional[_Plan] = None  # the plan of the latest run

    def close(self):
        self._cache.clear()

    def release_scope(self, scope: Scope) -> int:
        """Drop every cached plan of `scope`, its CUDA graph, graph memory
        pool and static buffers with it, so that the scope's tensors are
        freed once nothing else holds them; returns how many were dropped.
        A run already holding one of the plans finishes on it.  The serving
        registry calls this when it lets a model version go."""
        with self._cache_lock:
            keys = [k for k in self._cache if k[4] == scope._uuid]
            plans = [self._cache.pop(k) for k in keys]
            if self.last_plan is not None and self.last_plan in plans:
                self.last_plan = None
        for plan in plans:
            with plan._lock:
                plan._drop_graph()
        _MON.counter("executor.plans_released").inc(len(plans))
        return len(plans)

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, object]] = None,
        fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,  # parity arg; the cache is always on
        steps: int = 1,
    ) -> List[object]:
        """steps > 1 runs K steps: every feed must carry a leading [steps]
        axis and fetches come back stacked [steps, ...]."""
        return self._run_impl(program, feed, fetch_list, scope, return_numpy, steps, False)

    def warm(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, object]] = None,
        fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
        scope: Optional[Scope] = None,
    ) -> List[object]:
        """`run`, repeated on the card until the step's plan holds its CUDA
        graph (a plan's first run is eager, its second captures), so that
        the next run of these shapes replays.  A plan that cannot be
        captured, and every plan on the CPU, runs once.  Returns the last
        run's fetches."""
        return self._run_impl(program, feed, fetch_list, scope, True, 1, False, warm=True)

    def run_async(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, object]] = None,
        fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
        scope: Optional[Scope] = None,
        use_program_cache: bool = True,
        steps: int = 1,
    ) -> List[FetchHandle]:
        """`run` minus the blocking tail: one `FetchHandle` per fetch as soon
        as the step is enqueued on the card.  The scope already holds the
        step's state and generator, so the next run chains correctly; the
        host copy and the FLAGS_check_nan_inf guard run at resolution, where
        an in-flight error surfaces.  See pipeline.train_loop."""
        return self._run_impl(program, feed, fetch_list, scope, True, steps, True)

    def _feeds(self, block, feed, steps) -> Dict[str, torch.Tensor]:
        """Each feed cast to its var's declared dtype, then through the x32
        rule (ops/common.py canon_dtype: int64 -> int32, uint64 -> uint32,
        float64 -> float32), as the JAX package does at its feed boundary;
        ragged feeds and their `@LOD` lengths included."""
        out = {}
        for name, value in _expand_ragged_feeds(block, feed, steps).items():
            if block.has_var(name):
                dtype = block.var(name).dtype
            else:
                dtype = value.dtype if isinstance(value, torch.Tensor) else np.asarray(value).dtype
            out[name] = to_tensor(value, canon_dtype(dtype), self.place.device)
        if steps > 1:
            for name, t in out.items():
                shape = tuple(t.shape)
                if len(shape) == 0 or shape[0] != steps:
                    raise ValueError(
                        f"steps={steps} requires every feed to carry a leading "
                        f"[steps] axis; feed '{name}' has shape {shape}. Stack K "
                        f"batches along axis 0 (fetches come back stacked the "
                        f"same way).")
        return out

    @staticmethod
    def _key(program, feeds, fetch_names, scope, steps, remat):
        return (program._uuid, program.version,
                tuple(sorted((n, tuple(t.shape), str(t.dtype)) for n, t in feeds.items())),
                tuple(fetch_names), scope._uuid, steps, remat, _lowering_flags())

    def _plan(self, key, program, feeds, fetch_names, steps, remat):
        with self._cache_lock:
            plan = self._cache.pop(key, None)
            if plan is not None:
                self._cache[key] = plan  # re-insert: LRU order
                _MON.counter("executor.cache_hit").inc()
                return plan, True
        # the static analysis, once per plan-cache miss (FLAGS_verify_program):
        # a malformed program raises ProgramVerificationError naming the op,
        # var and block before any of it runs; a plan's later runs pay nothing
        level = flags.flag("FLAGS_verify_program")
        if level not in ("", "off"):
            from .analysis import check_program

            with _MON.span("analysis.verify", program=program._uuid[:8]):
                check_program(program, level=level, feed_names=list(feeds),
                              fetch_names=fetch_names)
        # the static out-of-memory pre-check (FLAGS_resource_precheck), once
        # per miss: the liveness plan of this (program, feed shapes) pair
        # raises ResourceError naming the watermark ops when it cannot fit
        # the card, before the plan is built or the step allocates anything
        from .resource_plan import precheck_program

        with _MON.span("analysis.plan", program=program._uuid[:8]):
            precheck_program(program, {n: tuple(t.shape) for n, t in feeds.items()},
                             fetch_names, steps=steps, device=self.place.device)
        with _MON.span("executor.build", program=program._uuid[:8]):
            plan = _Plan(program, fetch_names, self.place.device, steps, remat, self._graphs)
        with self._cache_lock:
            existing = self._cache.get(key)
            if existing is not None:  # a racing thread built it: keep one plan
                _MON.counter("executor.cache_hit").inc()
                return existing, True
            _MON.counter("executor.cache_miss").inc()
            self._cache[key] = plan
            while len(self._cache) > flags.flag("FLAGS_executor_cache_capacity"):
                self._cache.popitem(last=False)  # drops the plan's graph and buffers
        return plan, False

    def _generator(self, scope, program) -> torch.Generator:
        device = self.place.device
        gen = scope.find_var(RNG_STATE_VAR)
        if gen is None or gen.device != device:
            gen = torch.Generator(device=device)
            gen.manual_seed(program.random_seed if program.random_seed is not None else 0)
            scope.set_var(RNG_STATE_VAR, gen)
        return gen

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy, steps, async_mode,
                  warm=False):
        program, remat = _unwrap(program if program is not None else default_main_program())
        scope = scope if scope is not None else global_scope()
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        fetch_names = _fetch_names(fetch_list)
        t0 = time.perf_counter()
        feeds = self._feeds(program.global_block(), feed or {}, steps)
        key = self._key(program, feeds, fetch_names, scope, steps, remat)
        plan, hit = self._plan(key, program, feeds, fetch_names, steps, remat)
        self.last_plan = plan
        gen = self._generator(scope, program)
        if self.place.device.type == "cuda" and self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.place.device)
        if steps == 1:
            fetches = plan.run(scope, gen, feeds, self._side_stream)
            if warm and plan.graphable and not plan.graphed:
                fetches = plan.run(scope, gen, feeds, self._side_stream)  # captures
        else:
            per_step = [plan.run(scope, gen, {n: t[k] for n, t in feeds.items()},
                                 self._side_stream) for k in range(steps)]
            fetches = [torch.stack([_dense(outs[i]) for outs in per_step])
                       for i in range(len(fetch_names))]
        t_dispatch = time.perf_counter() - t0
        _MON.observe("executor.dispatch", t_dispatch, program=plan.program_u8)
        record = {"program": plan.program_u8, "steps": steps, "async": async_mode,
                  "cache_hit": hit, "graphed": plan.graphed, "t_dispatch_s": t_dispatch}
        if async_mode:
            event = None
            if self.place.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.place.device))
            _MON.record_step(record)
            pending = _PendingFetches(fetch_names, fetches, event, plan.program_u8)
            return [FetchHandle(pending, i, n) for i, n in enumerate(fetch_names)]
        t1 = time.perf_counter()
        if return_numpy:
            out = [t.numpy() if isinstance(t, SelectedRows)
                   else _array_host_copy(t) if isinstance(t, LoDTensorArray) else None
                   for t in fetches]
            copies = iter(host_copies([t for t in fetches
                                       if not isinstance(t, (SelectedRows, LoDTensorArray))]))
            out = [v if v is not None else next(copies) for v in out]
        else:
            out = fetches
        self._check_nan_inf(fetch_names, out)
        record["t_fetch_s"] = time.perf_counter() - t1
        _MON.observe("executor.fetch", record["t_fetch_s"], program=plan.program_u8)
        _MON.record_step(record)
        return out

    def train_from_dataset(self, program=None, dataset=None, scope=None, thread=0,
                           debug=False, fetch_list=None, fetch_info=None, print_period=100):
        """Drive `program` from a Dataset's batches (dataset.py), one run a
        batch; returns [(batch index, {fetch: first values})] every
        `print_period` batches, as the JAX package does."""
        from ..dataset import train_from_dataset as _tfd

        return _tfd(self, program if program is not None else default_main_program(),
                    dataset, scope=scope, fetch_list=fetch_list, fetch_info=fetch_info,
                    print_period=print_period)

    def infer_from_dataset(self, program=None, dataset=None, scope=None, **kw):
        return self.train_from_dataset(program, dataset, scope, **kw)

    @staticmethod
    def _check_nan_inf(fetch_names, values):
        if not flags.flag("FLAGS_check_nan_inf"):
            return
        for name, val in zip(fetch_names, values):
            if isinstance(val, SelectedRows):
                val = val.values
            if isinstance(val, list):  # a tensor array: each entry
                entries = [v for v in val if v is not None]
                Executor._check_nan_inf([name] * len(entries), entries)
                continue
            if isinstance(val, torch.Tensor):
                bad = val.is_floating_point() and not bool(torch.isfinite(val).all())
            else:
                arr = np.asarray(val)
                bad = np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all()
            if bad:
                # NumericError subclasses RuntimeError, as in the JAX package
                raise NumericError(f"FLAGS_check_nan_inf: fetch {name!r} contains "
                                   f"NaN/Inf (reference CheckTensorNANOrInf)")


def _fetch_names(fetch_list) -> List[str]:
    return [f.name if isinstance(f, Variable) else str(f) for f in (fetch_list or [])]


def _unwrap(program):
    """(Program, remat) of a Program or a CompiledProgram: a BuildStrategy
    with memory_optimize runs the backward regions rematerialized."""
    if hasattr(program, "program") and hasattr(program, "build_strategy"):
        return program.program, bool(getattr(program.build_strategy, "memory_optimize", False))
    return program, False
