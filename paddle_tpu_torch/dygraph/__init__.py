"""Dygraph (imperative) mode (counterpart of paddle_tpu/dygraph; reference
python/paddle/fluid/dygraph/ and paddle/fluid/imperative/).

`guard(place)` runs the eager ops on `place`'s device, CUDAPlace(0) when
no place is given; the tests pass CPUPlace()."""
from .base import VarBase, Tape, enabled, guard, to_variable  # noqa: F401
from .checkpoint import load_persistables, save_persistables  # noqa: F401
from .layers import Layer  # noqa: F401
from .nn import (  # noqa: F401
    FC,
    NCE,
    BatchNorm,
    BilinearTensorProduct,
    Conv2D,
    Conv2DTranspose,
    Conv3D,
    Conv3DTranspose,
    Dropout,
    Embedding,
    GroupNorm,
    GRUUnit,
    LayerNorm,
    Linear,
    Pool2D,
    PRelu,
    SpectralNorm,
    TreeConv,
)
from .learning_rate_scheduler import (  # noqa: F401
    CosineDecay,
    ExponentialDecay,
    InverseTimeDecay,
    LearningRateDecay,
    NaturalExpDecay,
    NoamDecay,
    PiecewiseDecay,
    PolynomialDecay,
)
from . import parallel as _parallel
from .parallel import DataParallel  # noqa: F401


def prepare_context(strategy=None):
    """reference dygraph.parallel.prepare_context: bootstrap cross-process
    dygraph data parallelism.  One process has nothing to bootstrap, and
    the strategy comes back as given; more than one trainer is ROADMAP
    A10's."""
    _parallel.refuse_gang("prepare_context", _parallel.ParallelEnv().nranks)
    return strategy
