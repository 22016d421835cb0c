"""Parallel execution (counterpart of paddle_tpu/parallel): data
parallelism over a gang of processes, one device a rank.

`CompiledProgram(...).with_data_parallel(...)` runs each rank's step on its
own shard of the batch and mean-reduces the gradients over the gang
(`distributed.make_grad_sync`, bucketed by `with_grad_overlap`);
`init_distributed` brings the gang's process group up from the
PADDLE_TRAINER_* contract, and `launch.run_gang` spawns and supervises
one.  `TieredEmbedding` is a table's host tier over the parameter server.
Sharding hints (`shard_parameters`), LocalSGD, pipelines and ring attention
come with the model-parallel paths (ROADMAP A10.3).
"""
from .compiled_program import BuildStrategy, CompiledProgram, ExecutionStrategy, ParallelExecutor  # noqa: F401
from .mesh import make_mesh  # noqa: F401
from . import distributed  # noqa: F401
from .distributed import init_distributed  # noqa: F401
from .embedding import TieredEmbedding  # noqa: F401
