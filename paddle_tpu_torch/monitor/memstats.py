"""Memory gauges: what the card's caching allocator holds (counterpart of
paddle_tpu/monitor/memstats.py, which walks JAX's live arrays).

Every gauge is lazy (`Gauge.set_fn`): it queries the allocator only when it
is read, never on the training hot path.  NaN where there is no card.
"""
from __future__ import annotations

import torch


def _cuda(fn, device_index: int) -> float:
    if not torch.cuda.is_available():
        return float("nan")
    return float(fn(device_index))


def device_bytes_in_use(device_index: int = 0) -> float:
    """Bytes of live tensors on the card (`torch.cuda.memory_allocated`)."""
    return _cuda(torch.cuda.memory_allocated, device_index)


def device_bytes_reserved(device_index: int = 0) -> float:
    """Bytes the caching allocator has reserved on the card, CUDA-graph
    pools included (`torch.cuda.memory_reserved`)."""
    return _cuda(torch.cuda.memory_reserved, device_index)


def device_alloc_retries(device_index: int = 0) -> float:
    """Times the allocator freed its cache and retried (`num_alloc_retries`
    of `torch.cuda.memory_stats`): memory pressure."""
    return _cuda(lambda i: torch.cuda.memory_stats(i).get("num_alloc_retries", 0), device_index)


def register_memory_gauges(mon):
    """Install the lazy memory gauges on a Monitor (idempotent)."""
    mon.gauge("memory.device_bytes_in_use").set_fn(device_bytes_in_use)
    mon.gauge("memory.device_bytes_reserved").set_fn(device_bytes_reserved)
    mon.gauge("memory.device_alloc_retries").set_fn(device_alloc_retries)
    return mon
