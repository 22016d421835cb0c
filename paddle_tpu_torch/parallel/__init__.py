"""Parallel execution (counterpart of paddle_tpu/parallel): for now the
single-device `CompiledProgram` and its `BuildStrategy`; data parallelism
and the mesh paths come with ROADMAP A10."""
from .compiled_program import BuildStrategy, CompiledProgram  # noqa: F401
