"""DistributeTranspiler source-compatibility layer (counterpart of
paddle_tpu/transpiler.py).

Reference: transpiler/distribute_transpiler.py (DistributeTranspiler:183,
transpile:377) with three modes — pserver (default), nccl2:261,
collective:313 — rewriting programs into send/recv or c_allreduce graphs.

As in the JAX package:
  * collective / nccl2 modes need no program rewrite: `transpile()`
    brings the gang up from its `trainers` endpoints
    (parallel.init_distributed) and remembers the program, and
    `get_trainer_program()` hands it back compiled for the gang's mesh, so
    every trainer runs the data-parallel step (core/executor.py's gang
    path);
  * pserver mode for dense parameters is refused with the JAX package's
    rationale (synchronous allreduce wins); sparse tables live in
    SelectedRows and the host parameter-server tier (param_server.py).
"""
from __future__ import annotations

from typing import Optional

class DistributeTranspilerConfig:
    """reference transpiler config: carriers kept for source compat."""

    def __init__(self):
        self.slice_var_up = True
        self.min_block_size = 8192
        self.mode = "collective"  # "nccl2" and "collective" behave the same
        self.sync_mode = True
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False


class DistributeTranspiler:
    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._program = None

    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=True, startup_program=None, current_endpoint=""):
        """collective/nccl2 semantics: bootstrap the process group and
        remember the program; no graph rewrite."""
        from .core.program import default_main_program

        # a non-empty `pservers` list IS the legacy pserver-mode request,
        # whatever the config says — fail with the rationale instead of
        # silently training unsynchronized replicas
        if pservers or self.config.mode == "pserver":
            raise NotImplementedError(
                "DistributeTranspiler: dense parameter-server mode is "
                "deliberately unimplemented — synchronous allreduce "
                "strictly dominates (SURVEY §2c); use the default "
                "collective mode. Sparse/giant tables: use is_sparse "
                "embeddings (SelectedRows) or the host parameter-server "
                "tier (param_server.py) instead.")
        self._program = program if program is not None else default_main_program()
        if isinstance(trainers, str) and trainers:
            endpoints = trainers.split(",")
        else:
            endpoints = None
        if endpoints and len(endpoints) > 1:
            from .parallel import distributed as dist

            dist.init_distributed(trainer_id=trainer_id,
                                  trainer_endpoints=endpoints,
                                  current_endpoint=current_endpoint or None)
        return self

    def get_trainer_program(self, wait_port=True):
        from .parallel.compiled_program import CompiledProgram
        from .parallel.distributed import global_mesh

        if self._program is None:
            raise RuntimeError("call transpile() first")
        return CompiledProgram(self._program).with_mesh(global_mesh())

    def get_pserver_programs(self, endpoint):
        """reference DistributeTranspiler.get_pserver_programs: the
        (pserver_program, startup) pair."""
        main = self.get_pserver_program(endpoint)
        return main, getattr(self, "_startup", None)

    def get_pserver_program(self, endpoint):
        raise NotImplementedError(
            "get_pserver_program: no pserver role exists — every process is a "
            "trainer of one program (see transpile())")

    def get_startup_program(self, endpoint=None, pserver_program=None,
                            startup_program=None):
        from .core.program import default_startup_program

        return startup_program if startup_program is not None else default_startup_program()


class PSDispatcher:
    """reference transpiler/ps_dispatcher.py: assign parameter slices to
    pserver endpoints."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError


class RoundRobin(PSDispatcher):
    """reference ps_dispatcher.RoundRobin: cycle endpoints in order."""

    def dispatch(self, varlist):
        out = []
        for _ in varlist:
            out.append(self._eps[self._step])
            self._step = (self._step + 1) % len(self._eps)
        return out


class HashName(PSDispatcher):
    """reference ps_dispatcher.HashName: endpoint by name-hash bucket."""

    @staticmethod
    def _hash_block(block_str, total):
        import zlib

        return zlib.crc32(block_str.encode()) % total

    def dispatch(self, varlist):
        return [self._eps[self._hash_block(v.name if hasattr(v, "name") else str(v),
                                           len(self._eps))]
                for v in varlist]


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    """reference transpiler.memory_optimize (var reuse pass): accepted
    no-op — the caching allocator and the executor's in-place updates own
    memory reuse; BuildStrategy.memory_optimize drives rematerialization
    instead."""
    return None


def release_memory(input_program, skip_opt_set=None):
    """reference transpiler.release_memory: accepted no-op (a lowering's
    temporaries are freed when nothing holds them)."""
    return None
