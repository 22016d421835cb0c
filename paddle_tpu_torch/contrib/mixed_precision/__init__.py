from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
