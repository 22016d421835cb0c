"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

The same Fluid surface as the JAX package, so a script ports by changing
the import:

    import paddle_tpu_torch as fluid
    exe = fluid.Executor(fluid.CUDAPlace(0))

Programs, saved models and parameters are interchangeable with paddle_tpu.
The port imports torch and numpy, never jax or paddle_tpu.  It covers the
serving and the static training paths of BERT-base, ResNet-50, DeepFM and
Transformer NMT (and the MNIST CNN) so far: their ops, passes, layers, io,
Predictor, `append_backward` with SelectedRows gradients for `is_sparse`
tables, ragged `LoDTensor` feeds, `While` and the in-program beam search,
`noam_decay`, and `optimizer.SGD`, `Momentum`, `Adam` and `Adagrad` with
the regularizers (`L2Decay`, `L1Decay`) and gradient clips (`clip.py`),
checkpoints (`io.save_persistables` / `load_persistables`), build-time
shape inference and the program verifier (`analysis`), with
hand-written Hopper kernels (csrc/) for LayerNorm+residual, bias+GELU and
the batch-norm epilogue (forward and backward), attention (forward),
softmax cross-entropy (forward and backward) and the Adam update.  The
Executor caches a plan per (program, feeds, fetches) and replays it as a
CUDA graph on the card; `steps > 1`, `run_async` / `FetchHandle`,
`pipeline.train_loop` and remat (`BuildStrategy.memory_optimize`) follow
the JAX package.  The data pipeline reads RecordIO files (`recordio`,
`recordio_writer`) through the reader decorators and `DataLoader`, which
stages batches in pinned memory and uploads them on a side stream, or
through `QueueDataset` / `Executor.train_from_dataset` (`dataset`,
`datasets`); `CheckpointManager`, `resilient_train_loop`, `FaultInjector`
and `integrity` make a single-device run survive bad batches, NaNs,
device errors, storage faults and preemption, resuming bit for bit.
`serving` is the serving runtime: a bounded queue batched into buckets
replayed as CUDA graphs, deadlines, several models under a memory budget
(priced by `core.resource_plan`), verified hot reload and rollback, and
request traces in one process, and `serving.ServingFleet`: replica
processes behind a router, health read off heartbeat files
(`dist_resilience`), restarts and a rolling publish, which `launch --serve`
runs from the command line.  Every
op of the JAX package but `pipeline` and `ring_attention` has a lowering;
`metrics`, `evaluator` and `debugger` are numpy-only copies.
`contrib.mixed_precision.decorate` trains in float16 with dynamic loss
scaling, the kernels taking float16 as they take bfloat16.
`contrib.slim` quantizes (QAT, post-training, the freeze), prunes and
distils; `io.save_quantized_inference_model` stores int8 weights, which a
load dequantizes into their serve dtype (no int8 product runs, as in the
JAX package).  `dygraph` runs eagerly: `VarBase`s on a guard's device,
the tape's backward through `torch.autograd`, `Layer` and its layers, the
eager optimizer updates, the LR schedules, `dygraph_grad_clip` and
`contrib.rnn_impl`'s cells.  `param_server` is the host sparse-table tier
(a supervised pserver child process, journaled and recovered bit for bit,
whose wire the JAX package's clients and servers speak) under
`parallel.TieredEmbedding`; `chaos` draws seeded multi-fault schedules,
runs them and shrinks a failing one.
"""
import numpy as np

from . import ops  # registers the op lowerings  # noqa: F401
from . import contrib  # mixed_precision, rnn_impl, slim  # noqa: F401
from . import dygraph, dygraph_grad_clip  # noqa: F401
from . import (backward, clip, errors, flags, inference, io, layers, lod,  # noqa: F401
               models, monitor, nets, optimizer, pipeline, profiler)
from . import (dataset, datasets, faults, integrity, reader, recordio,  # noqa: F401
               recordio_writer, resilience)
from . import serving  # noqa: F401
from . import dist_resilience, launch  # noqa: F401
from .checkpoint_manager import CheckpointManager  # noqa: F401
from .dataset import InMemoryDataset, QueueDataset  # noqa: F401
from .faults import FaultInjector  # noqa: F401
from .reader import DataFeeder, DataLoader, PyReader  # noqa: F401
from .resilience import ResilienceStats, RetryPolicy, resilient_train_loop  # noqa: F401
from .core import analysis, initializer, passes, regularizer, unique_name  # noqa: F401
from .core import resource_plan  # noqa: F401
from .core.autodiff import append_backward, calc_gradient  # noqa: F401
from .backward import gradients  # noqa: F401
from .core.executor import (  # noqa: F401
    CPUPlace,
    CUDAPinnedPlace,
    CUDAPlace,
    Executor,
    FetchHandle,
    TPUPlace,
    cpu_places,
    cuda_pinned_places,
    cuda_places,
)
from .core.param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from .core.program import (  # noqa: F401
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
)
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .lod import LoDTensor, LoDTensorArray, create_lod_tensor  # noqa: F401
from . import parallel  # noqa: F401
from . import param_server  # noqa: F401  (the host sparse-table tier)
from . import parallel as compiler  # fluid.compiler.CompiledProgram  # noqa: F401
from .parallel import BuildStrategy, CompiledProgram, ExecutionStrategy, ParallelExecutor  # noqa: F401
from .pipeline import PipelineStats, train_loop  # noqa: F401
from . import debugger, evaluator, metrics  # noqa: F401,E402
from . import chaos  # noqa: F401,E402  (seeded multi-fault campaign engine)
from . import install_check, transpiler  # noqa: F401,E402
from .transpiler import (DistributeTranspiler, DistributeTranspilerConfig,  # noqa: F401,E402
                         memory_optimize, release_memory)


def in_dygraph_mode():
    """True inside a `dygraph.guard()`, as in the JAX package."""
    return dygraph.base.enabled()


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low, high):
    """A LoDTensor of int64 sequences of the given lengths, each step of
    `base_shape`, drawn uniformly from [low, high] with numpy's global
    generator."""
    seqs = [np.random.randint(low, high + 1, (ln,) + tuple(base_shape)).astype("int64")
            for ln in recursive_seq_lens[0]]
    return LoDTensor(seqs)
