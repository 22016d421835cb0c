"""Dtype vocabulary for the program IR (counterpart of paddle_tpu/core/dtypes.py).

The IR names dtypes by string, exactly as the JAX package does, so programs
serialize identically in both.  numpy itself has no bfloat16; host copies of
bf16 tensors are `ml_dtypes.bfloat16` arrays, the numpy bfloat16 the JAX
package hands out, holding the tensor's exact 16-bit patterns (`to_numpy` /
`host_copies` view the bits, they do not widen).  `to_tensor` takes such an
array back bit for bit.
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
    "uint32": torch.uint32,
    "uint64": torch.uint64,
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
    when given.  A numpy array is cast on the host, as the JAX package casts
    its feeds, so the card receives the cast bytes in one copy.  A numpy
    bfloat16 array (ml_dtypes) keeps its exact bits."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if (dtype is not None and "bfloat16" not in arr.dtype.name
                and canonical_dtype(dtype) != "bfloat16"):
            arr = arr.astype(canonical_dtype(dtype), copy=False)
        if not arr.flags.writeable:  # torch.from_numpy shares memory; own a copy
            arr = arr.copy()
        if "bfloat16" in arr.dtype.name:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
    want = as_torch_dtype(dtype) if dtype is not None else t.dtype
    return t.to(device=device, dtype=want)


def _numpy_bfloat16():
    try:
        import ml_dtypes
    except ImportError as e:
        raise ImportError(
            "a numpy copy of a bfloat16 value needs the ml_dtypes package (numpy has no "
            "bfloat16 of its own); fetch it with return_numpy=False to keep the tensor") from e
    return ml_dtypes.bfloat16


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bfloat16 as an ml_dtypes array over the same bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_numpy_bfloat16())
    return t.numpy()


def host_copies(tensors) -> list:
    """Host copies of tensors, as numpy arrays.  A CUDA tensor goes into
    pinned host memory drawn from PyTorch's caching host allocator (after
    the first fetch of a size, no allocation), copied with non_blocking=True,
    all of them before one sync.  A bf16 copy is then viewed as an
    ml_dtypes bfloat16 array, its bits unchanged, as the JAX package's
    `np.asarray` of a bf16 array gives it."""
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
    return [_as_numpy(t) for t in staged]


def to_numpy(t) -> np.ndarray:
    """Host copy of one tensor (`host_copies`)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    return host_copies([t])[0]
