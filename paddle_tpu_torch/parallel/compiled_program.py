"""CompiledProgram: the data-parallel facade (counterpart of
paddle_tpu/parallel/compiled_program.py).

Reference: python/paddle/fluid/compiler.py (CompiledProgram:48,
with_data_parallel:116) -- there it builds the per-device SSA graph with
NCCL allreduce nodes; here it records a mesh of the gang's ranks
(parallel/mesh.py) and the executor runs each rank's step on its own shard
of the batch (core/executor.py's gang path).  At world size 1 the program
runs the plain one-card step, graphed as any other.

`Executor.run(CompiledProgram(program, build_strategy))` runs `program`;
`BuildStrategy.memory_optimize=True` runs its backward regions
rematerialized (core/lowering.py, `torch.utils.checkpoint` where the JAX
package has `jax.checkpoint`).  `with_mesh` takes a mesh whose only axis
larger than 1 is the batch axis, and `with_local_sgd` checks its argument
and raises: sharding hints and LocalSGD come with the model-parallel
paths (ROADMAP A10.3).
"""
from __future__ import annotations

from typing import Optional

from .mesh import data_axis_size, make_mesh


class ExecutionStrategy:
    """reference: framework/details/execution_strategy.h"""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


class BuildStrategy:
    """reference: framework/details/build_strategy.h:36.  `memory_optimize`
    trades a second forward for activation memory (remat); the other knobs
    are kept for source compatibility (the gradient all-reduce is bucketed
    by `CompiledProgram.with_grad_overlap` and FLAGS_dp_bucket_mb)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.fuse_all_reduce_ops = False
        self.memory_optimize = False
        self.enable_inplace = False


class CompiledProgram:
    def __init__(self, program, build_strategy: Optional[BuildStrategy] = None):
        self.program = program
        self.build_strategy = build_strategy or BuildStrategy()
        self.mesh = None
        self.loss_name = None
        self.batch_axis = "dp"
        self.local_sgd_every = 0
        self.grad_overlap_mode = None  # None | "bucketed" | "serial"
        self.grad_overlap_bucket_mb = 0.0

    def with_data_parallel(
        self,
        loss_name: Optional[str] = None,
        build_strategy: Optional[BuildStrategy] = None,
        exec_strategy: Optional[ExecutionStrategy] = None,
        share_vars_from=None,
        places=None,
    ) -> "CompiledProgram":
        """Mark for data-parallel execution over every rank of the gang (or
        the first len(`places`)).  Each rank feeds its own shard of the
        batch; the step computes what the JAX package's global-batch
        program computes: the mean of equal shards' losses and gradients,
        batch norm's statistics over the global batch, per-sample fetches
        gathered in rank order."""
        if build_strategy is not None:
            self.build_strategy = build_strategy
        self.loss_name = loss_name
        n = len(places) if places is not None else None
        from . import distributed

        ranks = list(range(distributed.num_trainers()))
        if n is not None:
            ranks = ranks[:n]
        self.mesh = make_mesh((len(ranks),), ("dp",), ranks)
        return self

    def with_mesh(self, mesh, batch_axis: str = "dp") -> "CompiledProgram":
        """Explicit-mesh variant.  Only the batch axis may be larger than 1:
        parameter placement by sharding hints comes with the model-parallel
        paths (ROADMAP A10.3)."""
        data_axis_size(mesh, batch_axis)
        self.mesh = mesh
        self.batch_axis = batch_axis
        return self

    def with_grad_overlap(self, bucket_mb: Optional[float] = None,
                          mode: str = "bucketed") -> "CompiledProgram":
        """Backward-overlapped data-parallel gradient all-reduce (the
        PyTorch-DDP bucketing strategy): each rank runs the step on its own
        shard as a manual per-shard region, and gradients are
        mean-all-reduced in size-capped buckets, launched in
        reverse-topological order as backward produces them.

        mode="serial" keeps ONE flat all-reduce after the whole backward;
        both modes are element-wise identical (bucketing never changes what
        each grad element is summed with).

        DDP semantics ride along: dropout masks and BN batch stats are
        per-shard (the BN running statistics are rank-meaned after the
        step), scalar fetches are rank-meaned and a per-sample fetch
        raises.  bucket_mb defaults to FLAGS_dp_bucket_mb.  Requires
        with_data_parallel/with_mesh first; composes with steps>1, not with
        with_local_sgd."""
        if mode not in ("bucketed", "serial"):
            raise ValueError(f"with_grad_overlap: unknown mode {mode!r}")
        if self.local_sgd_every:
            raise ValueError(
                "with_grad_overlap does not compose with with_local_sgd: "
                "LocalSGD rounds deliberately run collective-free steps")
        if bucket_mb is None:
            from ..flags import flag

            bucket_mb = float(flag("FLAGS_dp_bucket_mb"))
        if bucket_mb <= 0:
            raise ValueError(f"with_grad_overlap: bucket_mb must be > 0, "
                             f"got {bucket_mb}")
        self.grad_overlap_mode = mode
        self.grad_overlap_bucket_mb = float(bucket_mb)
        return self

    def with_local_sgd(self, sync_every: int = 4) -> "CompiledProgram":
        """LocalSGD mode (reference transpiler/collective.py:249): the JAX
        package's argument checks, then NotImplementedError -- LocalSGD
        comes with the model-parallel paths (ROADMAP A10.3)."""
        if sync_every < 1:
            raise ValueError(f"with_local_sgd: sync_every must be >= 1, got {sync_every}")
        if self.grad_overlap_mode:
            raise ValueError(
                "with_local_sgd does not compose with with_grad_overlap: "
                "LocalSGD rounds deliberately run collective-free steps")
        raise NotImplementedError(
            "CompiledProgram.with_local_sgd: LocalSGD rounds come with the "
            "model-parallel paths (ROADMAP A10.3)")


class ParallelExecutor:
    """reference parallel_executor.py ParallelExecutor: compat shim over
    CompiledProgram.with_data_parallel + Executor, on this rank's card
    (`parallel.distributed.card()`) or the CPU."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None, build_strategy=None,
                 num_trainers=1, trainer_id=0, scope=None):
        from ..core.executor import CPUPlace, CUDAPlace, Executor
        from ..core.program import default_main_program
        from ..core.scope import global_scope
        from . import distributed

        self._program = main_program or default_main_program()
        self._compiled = CompiledProgram(
            self._program, build_strategy=build_strategy
        ).with_data_parallel(loss_name=loss_name)
        self._exe = Executor(CUDAPlace(distributed.card() or 0) if use_cuda else CPUPlace())
        self._scope = scope or global_scope()

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        return self._exe.run(self._compiled, feed=feed or feed_dict,
                             fetch_list=fetch_list, scope=self._scope,
                             return_numpy=return_numpy)

    def drop_local_exe_scopes(self):
        """reference: drop per-device scopes; no residue (one scope a rank)."""
        return None
