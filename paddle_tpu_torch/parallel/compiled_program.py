"""CompiledProgram and BuildStrategy on one device (counterpart of
paddle_tpu/parallel/compiled_program.py).

`Executor.run(CompiledProgram(program, build_strategy))` runs `program`;
`BuildStrategy.memory_optimize=True` runs its backward regions
rematerialized (core/lowering.py, `torch.utils.checkpoint` where the JAX
package has `jax.checkpoint`).  `with_data_parallel` and the other mesh
paths raise: they come with the data-parallel slice (ROADMAP A10).
"""
from __future__ import annotations

from typing import Optional

_MESH_PATHS = ("data parallelism and the mesh paths of CompiledProgram "
               "(with_data_parallel, with_mesh, with_grad_overlap, with_local_sgd) are "
               "not ported yet: ROADMAP A10")


class BuildStrategy:
    """reference: framework/details/build_strategy.h:36.  `memory_optimize`
    trades a second forward for activation memory (remat); the knobs of
    the mesh paths come with them (ROADMAP A10)."""

    def __init__(self):
        self.memory_optimize = False


class CompiledProgram:
    def __init__(self, program, build_strategy: Optional[BuildStrategy] = None):
        self.program = program
        self.build_strategy = build_strategy or BuildStrategy()

    def with_data_parallel(self, *args, **kwargs) -> "CompiledProgram":
        raise NotImplementedError(_MESH_PATHS)

    def with_mesh(self, *args, **kwargs) -> "CompiledProgram":
        raise NotImplementedError(_MESH_PATHS)

    def with_grad_overlap(self, *args, **kwargs) -> "CompiledProgram":
        raise NotImplementedError(_MESH_PATHS)

    def with_local_sgd(self, *args, **kwargs) -> "CompiledProgram":
        raise NotImplementedError(_MESH_PATHS)
