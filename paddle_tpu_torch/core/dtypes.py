"""Dtype vocabulary for the program IR (counterpart of paddle_tpu/core/dtypes.py).

The IR names dtypes by string, exactly as the JAX package does, so programs
serialize identically in both.  bfloat16 comes from torch; numpy has no
bfloat16, so host copies of bf16 tensors travel as uint16 bit patterns
(see `to_tensor` / `to_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}

_ALIASES = {
    "fp16": "float16",
    "bf16": "bfloat16",
    "fp32": "float32",
    "fp64": "float64",
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
}

_FROM_TORCH = {v: k for k, v in _TORCH.items()}


def canonical_dtype(dtype) -> str:
    """Normalise any dtype spec (str, numpy dtype, torch dtype) to a canonical name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        if dtype not in _FROM_TORCH:
            raise ValueError(f"unsupported dtype: {dtype!r}")
        return _FROM_TORCH[dtype]
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name in _TORCH:
            return name
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = str(dtype)
    if "bfloat16" in name:  # ml_dtypes' numpy bfloat16, as the JAX package hands out
        return "bfloat16"
    name = _ALIASES.get(name, name)
    if name not in _TORCH:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return name


def as_torch_dtype(dtype) -> torch.dtype:
    return _TORCH[canonical_dtype(dtype)]


def to_tensor(value, dtype=None, device="cpu") -> torch.Tensor:
    """numpy array / scalar / tensor -> tensor on `device`, cast to `dtype`
    when given.  A numpy bfloat16 array (ml_dtypes) keeps its exact bits."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if not arr.flags.writeable:  # torch.from_numpy shares memory; own a copy
            arr = arr.copy()
        if "bfloat16" in arr.dtype.name:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
    want = as_torch_dtype(dtype) if dtype is not None else t.dtype
    return t.to(device=device, dtype=want)


def host_copies(tensors) -> list:
    """Host copies of tensors, as numpy arrays.  A CUDA tensor goes into
    pinned host memory drawn from PyTorch's caching host allocator (after
    the first fetch of a size, no allocation), copied with non_blocking=True,
    all of them before one sync; numpy has no bfloat16, so only then is a
    bf16 copy widened to its exact float32 value, on the host (widening
    first would double the bytes the copy moves)."""
    staged, streams = [], set()
    for t in tensors:
        t = t.detach()
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            streams.add(torch.cuda.current_stream(t.device))
            t = h
        staged.append(t)
    for s in streams:
        s.synchronize()
    return [(t.float() if t.dtype == torch.bfloat16 else t).numpy() for t in staged]


def to_numpy(t) -> np.ndarray:
    """Host copy of one tensor (`host_copies`)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    return host_copies([t])[0]
