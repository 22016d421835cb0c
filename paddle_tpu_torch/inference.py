"""Inference predictor (counterpart of paddle_tpu/inference.py).

`create_predictor(AnalysisConfig(model_dir))` loads a saved inference model
(`io.save_inference_model` of either package) onto the config's place --
the card, `CUDAPlace(0)`, unless the caller passes another -- and serves
`run` calls through its `Executor`: one cached plan for each batch shape,
replayed as a CUDA graph on the card from its second request (the first
runs eagerly).  `run` copies the outputs to the host through pinned
memory; `run_zero_copy` leaves them on the device until `copy_to_cpu`,
which takes the same pinned path.  `clone()` shares the program, the
weights and the executor's plans; `Predictor(config, executor=exe)` serves
through a shared Executor (the serving registry passes one for every
model, version and clone, so each bucket of a program has one plan).
`run` / `run_zero_copy` hold the per-predictor re-entrant lock
`inference.predictor` (rank 20), and a zero-copy transaction spanning
several calls holds `lock()`.  Clones serving one bucket from several
threads share its plan: the plan's own lock serialises its replays, and
each replay returns clones of the graph's static outputs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import io as _io
from .core import locks
from .core.dtypes import to_numpy
from .core.executor import CPUPlace, CUDAPlace, Executor, Place, TPUPlace  # noqa: F401
from .core.program import Program  # noqa: F401
from .core.scope import Scope


class AnalysisConfig:
    """Where and how a Predictor serves a saved model.  The place and the
    CUDA-graph switch act; the other knobs are recorded and shown by
    `summary`, as in the JAX package, and each says what it does here."""

    def __init__(self, model_dir: str, place: Optional[Place] = None):
        self.model_dir = model_dir
        self.place = place if place is not None else CUDAPlace(0)
        self._graphs = True  # False: an eager Executor (the graphed-vs-eager A/B)
        self._ir_optim = True
        self._memory_optim = True
        self._int8 = True
        self._threads = 1

    def enable_tpu(self, device_id: int = 0):
        """Serve on card `device_id` (the JAX package's TPU chip)."""
        self.place = CUDAPlace(device_id)
        return self

    def disable_tpu(self):
        """Serve on the CPU, through the kernels' plain versions."""
        self.place = CPUPlace()
        return self

    def switch_ir_optim(self, on: bool = True):
        """Recorded only: the predictor runs the program as it was saved (the
        passes run when a program is built or saved), on or off."""
        self._ir_optim = bool(on)
        return self

    def enable_memory_optim(self, on: bool = True):
        """Recorded only: on the card a plan's CUDA graph reuses its own
        memory pool from the second request on, on or off."""
        self._memory_optim = bool(on)
        return self

    def set_cpu_math_library_num_threads(self, n: int):
        """Recorded only: nothing on the card reads it, and torch's CPU
        threads are the process's (torch.set_num_threads)."""
        self._threads = int(n)
        return self

    def enable_quantize(self, on: bool = True):
        """Recorded only: an int8 model is detected from its
        `__quant__.json` and dequantized at load whatever this says; the
        flag records intent for `summary()`."""
        self._int8 = bool(on)
        return self

    def summary(self) -> dict:
        return {"model_dir": self.model_dir, "place": type(self.place).__name__,
                "ir_optim": self._ir_optim, "memory_optim": self._memory_optim,
                "int8": self._int8, "threads": self._threads}


PredictConfig = AnalysisConfig


class PredictorTensor:
    """A named input/output buffer handle (the reference's ZeroCopyTensor)."""

    def __init__(self, name: str):
        self.name = name
        self._value = None

    def copy_from_cpu(self, arr):
        self._value = np.ascontiguousarray(np.array(arr, copy=True))
        return self

    def share_external_data(self, tensor):
        """Adopt a tensor (on the predictor's device, say) without copying."""
        self._value = tensor
        return self

    def copy_to_cpu(self) -> np.ndarray:
        if self._value is None:
            raise ValueError(f"output {self.name!r} not produced yet; "
                             "call Predictor.run_zero_copy() first")
        return to_numpy(self._value)

    def value(self):
        """The raw (possibly device-resident) tensor, no host copy."""
        return self._value


class Predictor:
    def __init__(self, config: AnalysisConfig, _shared=None,
                 executor: Optional[Executor] = None):
        """`_shared` = (program, feed_names, fetch_names, scope) serves
        already-loaded weights (clone, the serving publisher's staged
        snapshot); `executor` shares its plans (default: a new one)."""
        self.config = config
        self.exe = (executor if executor is not None
                    else Executor(config.place, _graphs=config._graphs))
        if _shared is not None:
            self.program, self.feed_names, self.fetch_names, self.scope = _shared
        else:
            self.scope = Scope()
            self.program, self.feed_names, self.fetch_names = _io.load_inference_model(
                config.model_dir, self.exe, scope=self.scope)
        self._lock = locks.named_rlock("inference.predictor", rank=20)
        self._inputs = {n: PredictorTensor(n) for n in self.feed_names}
        self._outputs = {n: PredictorTensor(n) for n in self.fetch_names}

    def lock(self) -> locks.NamedLock:
        """The per-predictor re-entrant lock; hold it across copy_from_cpu ->
        run_zero_copy -> copy_to_cpu when threads share one predictor (or
        clone() per thread)."""
        return self._lock

    def run(self, feeds: Dict[str, np.ndarray], fetch_names: Optional[Sequence[str]] = None,
            return_numpy: bool = True) -> List[object]:
        missing = set(self.feed_names) - set(feeds)
        if missing:
            raise KeyError(f"Predictor.run: missing feeds {sorted(missing)}")
        with self._lock:
            return self.exe.run(self.program, feed=dict(feeds),
                                fetch_list=list(fetch_names or self.fetch_names),
                                scope=self.scope, return_numpy=return_numpy)

    def warm(self, feeds: Dict[str, np.ndarray]) -> List[object]:
        """`run`, repeated until these shapes' plan replays a CUDA graph
        (Executor.warm)."""
        missing = set(self.feed_names) - set(feeds)
        if missing:
            raise KeyError(f"Predictor.warm: missing feeds {sorted(missing)}")
        with self._lock:
            return self.exe.warm(self.program, feed=dict(feeds),
                                 fetch_list=list(self.fetch_names), scope=self.scope)

    def get_input_names(self) -> List[str]:
        return list(self.feed_names)

    def get_output_names(self) -> List[str]:
        return list(self.fetch_names)

    def get_input_handle(self, name: str) -> PredictorTensor:
        return self._inputs[name]

    def get_output_handle(self, name: str) -> PredictorTensor:
        return self._outputs[name]

    def run_zero_copy(self):
        """Run from the staged input handles into the output handles; the
        outputs stay on the device until copy_to_cpu."""
        with self._lock:
            feeds = {}
            for n, h in self._inputs.items():
                if h._value is None:
                    raise KeyError(f"input handle {n!r} has no data; call "
                                   "copy_from_cpu/share_external_data first")
                feeds[n] = h._value
            outs = self.exe.run(self.program, feed=feeds, fetch_list=list(self.fetch_names),
                                scope=self.scope, return_numpy=False)
            for n, v in zip(self.fetch_names, outs):
                self._outputs[n]._value = v
            return True

    def clone(self) -> "Predictor":
        """Another predictor over the same program and weights, with its own
        handles and lock."""
        return Predictor(self.config, _shared=(
            self.program, self.feed_names, self.fetch_names, self.scope), executor=self.exe)


def create_predictor(config: AnalysisConfig) -> Predictor:
    return Predictor(config)
