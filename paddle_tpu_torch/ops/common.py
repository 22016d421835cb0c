"""Shared helpers for op lowerings (counterpart of paddle_tpu/ops/common.py)."""
from __future__ import annotations

import torch

from ..core.dtypes import as_torch_dtype


def first(ins, slot):
    """The first value of an input slot, or None when the slot is absent."""
    vals = ins.get(slot)
    return vals[0] if vals else None


def bcast_y_to_x(x, y, axis: int):
    """Fluid elementwise broadcasting: Y's dims align to X starting at `axis`
    (axis=-1: align trailing dims, plain numpy broadcasting)."""
    if axis == -1 or x.dim() == y.dim():
        return y
    pad_right = x.dim() - axis - y.dim()
    if pad_right < 0:
        return y
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * pad_right)


def canon_dtype(dtype) -> torch.dtype:
    """The x32 rule of the JAX package (which runs with jax_enable_x64 off):
    int64 / uint64 / float64 compute as int32 / uint32 / float32, in
    in-program casts and at the feed boundary (core/executor.py)."""
    d = as_torch_dtype(dtype)
    return {torch.int64: torch.int32, torch.uint64: torch.uint32,
            torch.float64: torch.float32}.get(d, d)


def match_dtype(x, y):
    """Mixed precision: when x and y are floats of different width, y
    follows x (float32 master weights meet bf16 activations in bf16)."""
    if x.dtype != y.dtype and x.is_floating_point() and y.is_floating_point():
        return y.to(x.dtype)
    return y


def flatten_lookup_ids(ids):
    """lookup_table ids carry a trailing dim of 1; strip it when present."""
    return ids.reshape(ids.shape[:-1]) if ids.dim() and ids.shape[-1] == 1 else ids
