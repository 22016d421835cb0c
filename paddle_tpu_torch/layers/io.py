"""Data-entry layers (counterpart of paddle_tpu/layers/io.py)."""
from __future__ import annotations

from ..core.program import default_main_program
from ..lod import lod_var_name


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True, stop_gradient=True):
    """Declare an input variable; append_batch_size=True prefixes -1 (the
    batch size binds at feed time).

    lod_level >= 1 declares a ragged input: the padded carrier gets shape
    [-1 (batch), -1 (time), *shape] and an int32 lengths companion
    `<name>@LOD` (paddle_tpu_torch/lod.py); feeding a `LoDTensor` (or a list
    of per-sequence arrays) fills both."""
    shape = list(shape)
    if lod_level >= 1:
        if append_batch_size:
            shape = [-1, -1] + shape  # batch, bucketed time, *feature
    elif append_batch_size:
        shape = [-1] + shape
    block = default_main_program().current_block()
    var = block.create_var(name, shape=shape, dtype=dtype, lod_level=lod_level, is_data=True,
                           stop_gradient=stop_gradient)
    if lod_level >= 1:
        var._lod_ref = block.create_var(lod_var_name(name), shape=[-1], dtype="int32",
                                        is_data=True, stop_gradient=True)
    return var
