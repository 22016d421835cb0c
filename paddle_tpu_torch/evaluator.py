"""fluid.evaluator (counterpart of paddle_tpu/evaluator.py): the
pre-metrics API, each class its `metrics` replacement."""
from .metrics import (  # noqa: F401
    Accuracy,
    Auc,
    CompositeMetric,
    EditDistance,
    Precision,
    Recall,
)


class ChunkEvaluator:
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "ChunkEvaluator: chunk-eval (NER span F1) is not implemented; "
            "compute spans host-side from fetched predictions")
