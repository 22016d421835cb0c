"""Dygraph data parallelism (counterpart of paddle_tpu/dygraph/parallel.py;
reference dygraph/parallel.py:84 DataParallel, scale_loss:150 and
apply_collective_grads:171).

One process only: `scale_loss` is the identity and
`apply_collective_grads` reduces nothing, but opens the
`collective.apply_grads` span and counts the gradient bytes a reduction
would move (`collective.grad_bytes`), as the JAX package does.  More than
one trainer (`PADDLE_TRAINERS_NUM` > 1) or a device mesh comes with data
parallelism (ROADMAP A10) and raises.
"""
from __future__ import annotations

import os

from ..monitor import MONITOR as _MON
from .layers import Layer


def refuse_gang(what: str, nranks: int, mesh=None):
    """Raise for what needs more than one process or a mesh."""
    if mesh is not None:
        raise NotImplementedError(f"{what}: a device mesh comes with data parallelism "
                                  "(ROADMAP A10)")
    if nranks > 1:
        raise NotImplementedError(f"{what}: PADDLE_TRAINERS_NUM={nranks}; more than one "
                                  "trainer comes with data parallelism (ROADMAP A10)")


class ParallelEnv:
    """reference: dygraph/parallel.py Env — trainer id and count from the
    environment."""

    def __init__(self):
        self.nranks = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.local_rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.dev_id = self.local_rank


def prepare_context():
    env = ParallelEnv()
    refuse_gang("prepare_context", env.nranks)
    # per-device trace lane: merged Chrome traces get one row per rank
    _MON.set_lane(env.local_rank, f"trainer{env.local_rank}")
    _MON.gauge("parallel.nranks").set(env.nranks)
    return env


class DataParallel(Layer):
    def __init__(self, layers: Layer, strategy=None, mesh=None):
        super().__init__("data_parallel")
        refuse_gang("DataParallel", ParallelEnv().nranks, mesh)
        self._layers = layers
        self._mesh = mesh

    def forward(self, *args, **kw):
        return self._layers(*args, **kw)

    def scale_loss(self, loss):
        """Identity: one process holds the whole batch's loss."""
        return loss

    def apply_collective_grads(self):
        """No reduction with one process; the monitor still accounts the
        gradient bytes a step's reduction would move (the parameters'
        bytes)."""
        if _MON.enabled:
            with _MON.span("collective.apply_grads"):
                nbytes = sum(p.value.numel() * p.value.element_size()
                             for p in self._layers.parameters())
                _MON.counter("collective.grad_bytes").inc(nbytes)

    def parameters(self, include_sublayers: bool = True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_dict(self, *a, **k):
        return self._layers.set_dict(*a, **k)

    load_dict = set_dict
