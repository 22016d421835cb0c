"""Dygraph data parallelism (counterpart of paddle_tpu/dygraph/parallel.py;
reference dygraph/parallel.py:84 DataParallel, scale_loss:150 and
apply_collective_grads:171).

Over a gang (parallel/distributed.py), each rank runs the model on its own
shard of the batch; `apply_collective_grads` mean-reduces every
parameter's gradient over the gang in one flat float32 all-reduce (the 1/n
scale before the cast back), which is what GSPMD does inside the JAX
package's backward over the global batch, so each rank's update is the
global batch's.  `scale_loss` stays the identity, as in the JAX package
(each rank's loss is its shard's mean).  The `collective.apply_grads` span
and the `collective.grad_bytes` counter (the parameters' bytes) are kept
at any world size.  A mesh with an axis besides the batch axis comes with
the model-parallel paths (ROADMAP A10.3).
"""
from __future__ import annotations

import contextlib
import os

import torch

from ..monitor import MONITOR as _MON
from ..parallel import distributed as _dist
from .layers import Layer


class ParallelEnv:
    """reference: dygraph/parallel.py Env — trainer id and count: the gang's
    when one is initialized, else from the environment."""

    def __init__(self):
        if _dist.is_initialized():
            self.nranks = _dist.num_trainers()
            self.local_rank = _dist.trainer_id()
        else:
            self.nranks = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
            self.local_rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.dev_id = self.local_rank


def prepare_context():
    """Bring the gang up (parallel.init_distributed, from the
    PADDLE_TRAINER_* environment) when more than one trainer is asked for;
    returns the ParallelEnv."""
    env = ParallelEnv()
    if env.nranks > 1 and not _dist.is_initialized():
        _dist.init_distributed()
        env = ParallelEnv()
    # per-device trace lane: merged Chrome traces get one row per rank
    _MON.set_lane(env.local_rank, f"trainer{env.local_rank}")
    _MON.gauge("parallel.nranks").set(env.nranks)
    return env


class DataParallel(Layer):
    def __init__(self, layers: Layer, strategy=None, mesh=None):
        super().__init__("data_parallel")
        if mesh is not None:
            from ..parallel.mesh import data_axis_size

            data_axis_size(mesh)
        nranks = ParallelEnv().nranks
        if nranks > 1 and _dist.num_trainers() != nranks:
            raise RuntimeError(
                f"DataParallel: {nranks} trainers are asked for but no gang of "
                f"{nranks} is initialized; call dygraph.parallel.prepare_context() "
                f"(or parallel.init_distributed()) first")
        self._layers = layers
        self._mesh = mesh

    def forward(self, *args, **kw):
        return self._layers(*args, **kw)

    def scale_loss(self, loss):
        """Identity: each rank's loss is its shard's mean, and the gradients'
        mean over the gang (apply_collective_grads) is the global batch's."""
        return loss

    def apply_collective_grads(self):
        """Mean-reduce every parameter's gradient over the gang (a
        parameter without one contributes zeros), in one flat float32
        all-reduce; nothing to reduce with one process.  The monitor
        accounts the parameters' bytes either way."""
        with _MON.span("collective.apply_grads") if _MON.enabled else contextlib.nullcontext():
            params = self._layers.parameters()
            if _MON.enabled:
                _MON.counter("collective.grad_bytes").inc(
                    sum(p.value.numel() * p.value.element_size() for p in params))
            if _dist.num_trainers() == 1:
                return
            grads = [p.grad if p.grad is not None else torch.zeros_like(p.value) for p in params]
            for p, g in zip(params, _dist.all_reduce_mean(grads)):
                p.grad = g

    def parameters(self, include_sublayers: bool = True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_dict(self, *a, **k):
        return self._layers.set_dict(*a, **k)

    load_dict = set_dict
