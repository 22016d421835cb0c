"""Hand-written Hopper scaled-dot-product attention forward, with its plain
PyTorch version (counterpart of paddle_tpu/ops/pallas_attention.py).

Routing as in ops/cuda_kernels.py: CPU tensors take `sdpa_plain`, CUDA
tensors launch `csrc/sdpa.cu` and bump `LAUNCHES["sdpa_fwd"]`.  The backward
kernel is not ported: CUDA inputs that require grad raise (on the CPU,
autograd differentiates the plain version).

Contract (the JAX fused_sdpa's): q [B, H, Lq, dh], k and v [B, H, Lk, dh],
one dtype (float32 or bfloat16), max(Lq, Lk) <= 1024; optional additive
bias [B, 1|H, Lq, Lk], not differentiable; causal masking keeps key c for
query i when c <= i + (Lk - Lq).
"""
from __future__ import annotations

import torch

from .. import _build
from .cuda_kernels import LAUNCHES, _DTYPE_CODE, check_operand, on_card, stream_ptr

MAX_SEQ = 1024  # the whole-row kernel's limit, as the TPU kernel's (pallas_attention.py:185)
_HEAD_DIMS = (16, 32, 64, 128)


def sdpa_plain(q, k, v, bias, causal, scale):
    """The JAX composite attention (paddle_tpu/ops/nn_ops.py:672-689): float32
    scores and softmax, P rounded to q.dtype before the PV product, which
    accumulates in float32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril(lk - lq)
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def fused_sdpa(q, k, v, bias, causal, scale):
    """Fused attention over [B, H, L, dh]; bias is not differentiable."""
    B, H, Lq, dh = q.shape
    Lk = k.shape[2]
    if max(Lq, Lk) > MAX_SEQ:
        raise ValueError(f"fused_sdpa: sequence {max(Lq, Lk)} > {MAX_SEQ}; longer "
                         "attention is the streaming flash kernel's")
    if k.shape != (B, H, Lk, dh) or v.shape != k.shape:
        raise ValueError(f"fused_sdpa: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if bias is not None and (bias.dim() != 4 or bias.shape[0] != B
                             or bias.shape[1] not in (1, H) or bias.shape[2:] != (Lq, Lk)):
        raise ValueError(f"fused_sdpa: bias {tuple(bias.shape)} is not [{B}, 1|{H}, {Lq}, {Lk}]")
    if not on_card("fused_sdpa", q, k, v, bias):
        return sdpa_plain(q, k, v, bias, causal, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "fused_sdpa: inputs require grad, but only the forward kernel is ported; its "
            "backward (_fused_sdpa_bwd) comes with the attention-training slice, one "
            "FlashAttention-style forward and backward.  Train with "
            "use_fused_attention=False")
    for what, t in (("q", q), ("k", k), ("v", v)):
        check_operand("fused_sdpa", what, t, q.dtype)
        if t.data_ptr() % 16:
            raise ValueError(f"fused_sdpa: {what} must be 16-byte aligned")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"fused_sdpa: head dim {dh} not in {_HEAD_DIMS}")
    if bias is not None:
        bias = bias.float().contiguous()
    out = torch.empty_like(q)
    _build.call("ptt_sdpa_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr() if bias is not None else None, out.data_ptr(),
                B, H, Lq, Lk, dh, 0 if bias is None else bias.shape[1], float(scale),
                int(bool(causal)), _DTYPE_CODE[q.dtype], stream_ptr(q))
    LAUNCHES["sdpa_fwd"] += 1
    return out
