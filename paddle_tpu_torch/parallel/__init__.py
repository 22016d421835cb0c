"""Parallel execution (counterpart of paddle_tpu/parallel): for now the
single-device `CompiledProgram` and its `BuildStrategy`, and
`TieredEmbedding`, a table's host tier over the parameter server; data
parallelism and the mesh paths come with ROADMAP A10."""
from .compiled_program import BuildStrategy, CompiledProgram  # noqa: F401
from .embedding import TieredEmbedding  # noqa: F401
