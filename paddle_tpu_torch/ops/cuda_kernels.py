"""Hand-written Hopper kernels for LayerNorm+residual, bias+activation, the
batch-norm epilogue, softmax cross-entropy and the Adam update, with their
plain PyTorch versions (counterpart of paddle_tpu/ops/pallas_kernels.py).

Each public function keeps the JAX package's name and contract.  The
tensor's device picks the route:

  * CPU tensors take the plain version (the CPU tests, the CPU Executor);
  * CUDA tensors launch the kernel from `csrc/` on the current stream, into
    outputs from `torch.empty`, and bump `LAUNCHES[<kernel>]`;
  * anything else raises.  A kernel that fails to build or launch raises:
    there is no fallback to the plain version on the card.

`fused_ln_residual`, `fused_bias_act`, `fused_scale_shift_relu` and
`fused_softmax_xent` are `torch.autograd.Function`s, as the JAX functions are custom VJPs: the
forward and the backward each take the kernel on the card, and on the CPU
the plain forward and an explicit plain backward (`*_bwd_plain`, the
backward's own arithmetic, not autograd of the plain forward).
`fused_adam` updates p, m and v in place on the card (the TPU kernel's
`input_output_aliases`); its plain version returns new tensors.  Given the
AMP decorator's overflow flag (`found_inf`, one bool on the device), the
kernel reads it on the device and writes nothing when it is set; on the CPU
the wrapper returns its inputs' values.

Every kernel takes float32, bfloat16 and float16 tensors, as the JAX
kernels do (each takes its output dtype from its input): it computes in
float32 and rounds once to the tensor's dtype, to nearest even, a float16
past 65504 to +-inf (never clamped: AMP's `isfinite` must see an
overflow), as the plain versions' `.to(dtype)` does.
"""
from __future__ import annotations

from typing import Dict, Optional

import math

import torch
import torch.nn.functional as F

from .. import _build

# launches per kernel, counted where each wrapper launches and nowhere else
LAUNCHES: Dict[str, int] = {
    "ln_residual_fwd": 0, "ln_residual_bwd": 0, "bias_act_fwd": 0, "bias_act_bwd": 0,
    "softmax_xent_fwd": 0, "softmax_xent_bwd": 0, "adam": 0, "attention_fwd": 0,
    "attention_bwd_dkv": 0, "attention_bwd_dq": 0, "bn_epilogue_fwd": 0, "bn_epilogue_bwd": 0,
    "attention_fwd_bf16_scores": 0, "attention_bwd_dq_bf16_scores": 0,
    "attention_bwd_dkv_bf16_scores": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# one rounding of a stored value: (unit roundoff, half the smallest subnormal
# step) of each dtype the kernels take; float16's subnormals start at 2^-14,
# bfloat16's where float32's do (below any value the kernels hold to a rule)
ROUNDING = {torch.float32: (2.0 ** -24, 0.0), torch.bfloat16: (2.0 ** -8, 0.0),
            torch.float16: (2.0 ** -11, 2.0 ** -25)}


def stored_step(dtype, x):
    """How far apart two roundings to `dtype` of float32 values that differ
    in their last bits may land, element by element: one step of the dtype,
    2 u |x| (u the unit roundoff), or, below float16's normal range, one
    subnormal step 2^-24."""
    u, sub = ROUNDING[dtype]
    return 2.0 * u * x.float().abs() + 2.0 * sub


_ACT_CODE = {"relu": 0, "gelu": 1}
LN_BWD_MAX_D = 1024  # the backward kernel holds a row in one warp's registers


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_card(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """True when `tensors` lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (plain version); raise on anything else."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def check_operand(name: str, what: str, t: torch.Tensor, dtype=None) -> None:
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: {what} is {t.dtype}, expected {dtype}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: {what} dtype {t.dtype} not supported "
                        "(float32, bfloat16, float16)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _row_blocks(rows: int, rows_per_block: int, cap: int) -> int:
    """Blocks of the backward kernels' first pass: about `rows_per_block`
    rows each, at most `cap`.  A function of the shape alone, so the
    column sums are added in the same order on every run."""
    return max(1, min(-(-rows // rows_per_block), cap))


# --------------------------------------------------------------------------
# LayerNorm + residual
# --------------------------------------------------------------------------


def ln_residual_plain(x, res, scale, bias, eps=1e-5):
    """paddle_tpu/ops/pallas_kernels.py _ln_reference: LN(x + res) over the
    last axis, the residual added and the statistics taken in float32, as
    the kernels do, output in x.dtype."""
    rf = x.float() if res is None else x.float() + res.float()
    mean = rf.mean(-1, keepdim=True)
    var = rf.var(-1, correction=0, keepdim=True)
    y = (rf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _ln_xhat(x, res, eps):
    """(rstd, xhat) of LN(x + res), statistics recomputed in float32."""
    r = x.float() if res is None else x.float() + res.float()
    c = r - r.mean(-1, keepdim=True)
    inv = torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    return inv, c * inv


def ln_residual_bwd_plain(x, res, scale, g, eps=1e-5):
    """The arithmetic of paddle_tpu/ops/pallas_kernels.py _ln_bwd_kernel:
    statistics recomputed in float32 from x (+ res), then
    dx = inv * (g*s - mean(g*s) - xhat * mean(g*s*xhat)).  Returns
    (dx in x.dtype, dscale, dbias), the last two float32 [D]."""
    inv, xhat = _ln_xhat(x, res, eps)
    gf = g.float()
    gs = gf * scale.float()
    m1 = gs.mean(-1, keepdim=True)
    m2 = (gs * xhat).mean(-1, keepdim=True)
    dx = inv * (gs - m1 - xhat * m2)
    d = x.shape[-1]
    return dx.to(x.dtype), (gf * xhat).reshape(-1, d).sum(0), gf.reshape(-1, d).sum(0)


FWD_ROUNDING_RULE = ("one rounding of the output's dtype of |plain| (stored_step) + 2^-20 * the "
                     "magnitudes of the output's float32 terms")


def fwd_allowed(dtype, want, terms):
    """What a forward's output of `dtype` may differ from the plain one
    (`want`) by, element by element (FWD_ROUNDING_RULE): both compute in
    float32 from the same inputs, in other orders or with other libm
    routines (erf, rsqrt), so a few float32 roundings of the terms that make
    each element (under 2^-20 of their magnitudes, `terms`; gelu's 1 + erf
    cancels for z below -3, where that noise is the element's whole
    magnitude), then round once: at most one step of the dtype apart."""
    return stored_step(dtype, want) + 2.0 ** -20 * terms + 1e-30


def ln_residual_fwd_allowed(x, res, scale, bias, want, eps=1e-5):
    """fwd_allowed of the LayerNorm forward: the terms are (|r| + |mean|)
    * rstd * |scale| and |bias|, r = x + res: r - mean carries the float32
    noise of r and of the mean, not of the difference (where r is near its
    row's mean, the output is bias plus noise times scale)."""
    r = x.float() if res is None else x.float() + res.float()
    mean = r.mean(-1, keepdim=True)
    inv = torch.rsqrt((r - mean).square().mean(-1, keepdim=True) + eps)
    terms = (r.abs() + mean.abs()) * inv * scale.float().abs() + bias.float().abs()
    return fwd_allowed(x.dtype, want, terms)


LN_BWD_RULE = "1e-5 * sum|g * xhat| (dscale), 1e-5 * sum|g| (dbias) of the column"


def ln_residual_bwd_allowed(x, res, g, eps=1e-5):
    """What a backward's (dscale, dbias) may differ from the plain versions'
    by, column by column (LN_BWD_RULE): both are float32 sums of the rows'
    terms g * xhat and g, taken in another order and from xhat whose last
    bits differ, so 1e-5 of the sum of the magnitudes of their terms.  A
    kernel that loses a block of 16 rows moves a column by about 4 terms,
    orders of magnitude past it."""
    _, xhat = _ln_xhat(x, res, eps)
    d = x.shape[-1]
    gf = g.float().reshape(-1, d)
    return (1e-5 * (gf * xhat.reshape(-1, d)).abs().sum(0) + 1e-30,
            1e-5 * gf.abs().sum(0) + 1e-30)


def _ln_fwd(x, res, scale, bias, eps):
    if not on_card("fused_ln_residual", x, res, scale, bias):
        return ln_residual_plain(x, res, scale, bias, eps)
    check_operand("fused_ln_residual", "x", x)
    if res is not None:
        check_operand("fused_ln_residual", "res", res, x.dtype)
        if res.shape != x.shape:
            raise ValueError(f"fused_ln_residual: res {tuple(res.shape)} != x {tuple(x.shape)}")
    d = x.shape[-1]
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"fused_ln_residual: scale/bias must be [{d}]")
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    _build.call("ptt_ln_residual_fwd", x.data_ptr(), _ptr(res), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), x.numel() // max(d, 1), d, float(eps),
                _DTYPE_CODE[x.dtype], stream_ptr(x))
    LAUNCHES["ln_residual_fwd"] += 1
    return out


def ln_residual_bwd(x, res, scale, g, eps):
    """(dx, dscale, dbias) of fused_ln_residual: the kernel on the card, the
    plain backward on the CPU."""
    if not on_card("fused_ln_residual backward", x, res, scale, g):
        return ln_residual_bwd_plain(x, res, scale, g, eps)
    name = "fused_ln_residual backward"
    check_operand(name, "x", x)
    check_operand(name, "g", g, x.dtype)
    if res is not None:
        check_operand(name, "res", res, x.dtype)
    d = x.shape[-1]
    if g.shape != x.shape or (res is not None and res.shape != x.shape):
        raise ValueError(f"{name}: x, res and g must share a shape")
    if d > LN_BWD_MAX_D:
        raise ValueError(f"{name}: rows of {d} > {LN_BWD_MAX_D} are not supported by the kernel")
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if not rows:
        dsdb = torch.zeros(2, d, dtype=torch.float32, device=x.device)
    else:
        # the column pass writes every element; one wave of the H100's 132
        # SMs at 3 blocks each
        dsdb = torch.empty(2, d, dtype=torch.float32, device=x.device)
        n_blocks = _row_blocks(rows, 8, 3 * 132)
        part = torch.empty(2, n_blocks, d, dtype=torch.float32, device=x.device)
        scale = scale.float().contiguous()
        _build.call("ptt_ln_residual_bwd", x.data_ptr(), _ptr(res), scale.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), part.data_ptr(), dsdb.data_ptr(), rows, d,
                    float(eps), n_blocks, _DTYPE_CODE[x.dtype], stream_ptr(x))
        LAUNCHES["ln_residual_bwd"] += 1
    return dx, dsdb[0], dsdb[1]


class _LNResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, scale, bias, eps):
        ctx.save_for_backward(x, res, scale)
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        return _ln_fwd(x, res, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, res, scale = ctx.saved_tensors
        dx, ds, db = ln_residual_bwd(x, res, scale, g.contiguous(), ctx.eps)
        dres = None if res is None or not ctx.needs_input_grad[1] else dx.to(res.dtype)
        return dx, dres, ds.to(scale.dtype), db.to(ctx.bias_dtype), None


def fused_ln_residual(x, res, scale, bias, eps):
    """y = LayerNorm(x + res) * scale + bias over the LAST axis.

    res may be None.  scale/bias are [D] (computed in float32); the
    statistics are float32; y has x's dtype and shape.  The backward
    recomputes the statistics (only x, res and scale are saved) and gives
    dres = dx."""
    return _LNResidual.apply(x, res, scale, bias, eps)


# --------------------------------------------------------------------------
# bias + activation
# --------------------------------------------------------------------------


def bias_act_plain(x, b, act="gelu"):
    """paddle_tpu/ops/pallas_kernels.py _bias_act_reference: act(x + b) in
    float32 (exact erf gelu), output in x.dtype."""
    z = x.float() + b.float()
    y = torch.relu(z) if act == "relu" else F.gelu(z)
    return y.to(x.dtype)


def _act_grad(z, act):
    """paddle_tpu/ops/pallas_kernels.py _act_grad: relu's step, or exact
    gelu's Phi(z) + z * phi(z)."""
    if act == "relu":
        return (z > 0.0).float()
    phi = torch.exp(-0.5 * z * z) * 0.3989422804014327
    return 0.5 * (1.0 + torch.erf(z * 2.0 ** -0.5)) + z * phi


def bias_act_bwd_plain(x, b, g, act="gelu"):
    """The arithmetic of _bias_act_bwd_kernel: dz = g * act'(x + b) in
    float32; returns (dx in x.dtype, dbias float32 [D])."""
    dz = g.float() * _act_grad(x.float() + b.float(), act)
    return dz.to(x.dtype), dz.sum(0)


BIAS_ACT_BWD_RULE = ("dx: one rounding of x's dtype of |plain| (stored_step) + 2^-20 * |g| * the "
                     "magnitudes of act'(z)'s terms; dbias: 1e-5 * sum|dz| + 2^-20 * sum(|g| * "
                     "terms) of the column")


def bias_act_bwd_allowed(x, b, g, act, want):
    """What a backward's (dx, dbias) may differ from bias_act_bwd_plain's
    (`want`) by, element by element and column by column
    (BIAS_ACT_BWD_RULE).  dx: the float32 dz = g * act'(z) of both sides
    differ by the float32 noise of act'(z) (erf, exp and the sum of gelu's
    terms 0.5, 0.5*erf and z*phi each carry a few roundings; relu's step
    none), under 2^-20 of the terms' magnitudes times |g|; rounding to x's
    dtype then adds at most one unit in the last place (stored_step: 2^-7 of
    |dx| in bfloat16, 2^-10 in float16 or 2^-24 below its normal range,
    2^-23 in float32).  dbias: float32 column sums of dz taken in
    another order, 1e-5 of the sum of their magnitudes, plus the sum of dz's
    own noise (where Phi(z) and z*phi(z) cancel, as near z = -0.75, a small
    dz carries the noise of its larger terms; with few rows that noise is
    the column's).  A kernel that loses a band of 16 rows moves a column by
    about 4 terms, orders of magnitude past it; gelu' swapped for relu'
    moves dx by about phi(z)*|g|."""
    z = x.float() + b.float()
    gf = g.float()
    if act == "relu":
        terms = (z > 0.0).float()
    else:
        phi = torch.exp(-0.5 * z * z) * 0.3989422804014327
        terms = 0.5 * (1.0 + torch.erf(z * 2.0 ** -0.5).abs()) + (z * phi).abs()
    noise = 2.0 ** -20 * gf.abs() * terms
    dz = gf * _act_grad(z, act)
    return (stored_step(x.dtype, want[0]) + noise + 1e-30,
            1e-5 * dz.abs().sum(0) + noise.sum(0) + 1e-30)


def bias_act_fwd_allowed(x, b, want):
    """fwd_allowed of the bias+activation forward: the term is |x + b|
    (gelu's 0.5 z (1 + erf(z / sqrt 2)), or relu's z)."""
    return fwd_allowed(x.dtype, want, (x.float() + b.float()).abs())


def _bias_act_fwd(x, bias, act):
    if not on_card("fused_bias_act", x, bias):
        return bias_act_plain(x, bias, act)
    check_operand("fused_bias_act", "x", x)
    if x.dim() != 2 or bias.shape != (x.shape[1],):
        raise ValueError(f"fused_bias_act: x must be [R, D] and bias [D], got "
                         f"{tuple(x.shape)} and {tuple(bias.shape)}")
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    _build.call("ptt_bias_act_fwd", x.data_ptr(), bias.data_ptr(), out.data_ptr(),
                x.shape[0], x.shape[1], _ACT_CODE[act], _DTYPE_CODE[x.dtype], stream_ptr(x))
    LAUNCHES["bias_act_fwd"] += 1
    return out


def bias_act_bwd(x, bias, g, act):
    """(dx, dbias) of fused_bias_act: the kernel on the card, the plain
    backward on the CPU."""
    name = "fused_bias_act backward"
    if not on_card(name, x, bias, g):
        return bias_act_bwd_plain(x, bias, g, act)
    check_operand(name, "x", x)
    check_operand(name, "g", g, x.dtype)
    if x.dim() != 2 or g.shape != x.shape or bias.shape != (x.shape[1],):
        raise ValueError(f"{name}: x and g must be [R, D] and bias [D]")
    rows, d = x.shape
    dx = torch.empty_like(x)
    if not rows:
        db = torch.zeros(d, dtype=torch.float32, device=x.device)
    else:
        # the column pass writes every element of db.  part holds a row for
        # each band the kernel may take: bands of at least 16 rows, at most
        # 1024; the kernel takes as many of them as one wave of its blocks
        # fills
        db = torch.empty(d, dtype=torch.float32, device=x.device)
        n_blocks = _row_blocks(rows, 16, 1024)
        part = torch.empty(n_blocks, d, dtype=torch.float32, device=x.device)
        bias = bias.float().contiguous()
        _build.call("ptt_bias_act_bwd", x.data_ptr(), bias.data_ptr(), g.data_ptr(),
                    dx.data_ptr(), part.data_ptr(), db.data_ptr(), rows, d, _ACT_CODE[act],
                    n_blocks, _DTYPE_CODE[x.dtype], stream_ptr(x))
        LAUNCHES["bias_act_bwd"] += 1
    return dx, db


class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, act):
        ctx.save_for_backward(x, bias)
        ctx.act = act
        return _bias_act_fwd(x, bias, act)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx, db = bias_act_bwd(x, bias, g.contiguous(), ctx.act)
        return dx, db.to(bias.dtype), None


def fused_bias_act(x, bias, act="gelu"):
    """y = act(x + bias) with bias [D] broadcast over the rows of x:[R, D];
    act in ("relu", "gelu"), gelu the exact erf form.  The backward
    recomputes the pre-activation (only x and bias are saved)."""
    if act not in _ACT_CODE:
        raise ValueError(f"fused_bias_act: act must be relu or gelu, got {act!r}")
    return _BiasAct.apply(x, bias, act)


# --------------------------------------------------------------------------
# batch-norm epilogue: per-row scale / shift (+ relu)
# --------------------------------------------------------------------------


def bn_epilogue_plain(x, mul, add, relu=True):
    """paddle_tpu/ops/pallas_kernels.py _epilogue_fwd_kernel over x:[R, W]
    with per-row float32 mul/add: max(x*mul + add, 0), or without the relu,
    in float32 (a multiply, then an add), output in x.dtype."""
    y = x.float() * mul.float()[:, None] + add.float()[:, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def bn_epilogue_fwd_allowed(x, mul, add, want):
    """fwd_allowed of the BN epilogue forward over x:[R, W]: the terms are
    |x * mul| and |add|."""
    return fwd_allowed(x.dtype, want, (x.float() * mul.float()[:, None]).abs()
                       + add.float().abs()[:, None])


def bn_epilogue_bwd_plain(x, mul, add, g, relu=True):
    """The arithmetic of _epilogue_bwd_kernel: the relu mask recomputed as
    x*mul + add > 0, dx = g*mul*live in x.dtype, and per-row float32
    dmul = sum(g*live*x), dadd = sum(g*live)."""
    xf = x.float()
    m = mul.float()[:, None]
    gf = g.float()
    if relu:
        live = (xf * m + add.float()[:, None]) > 0.0
        gf = torch.where(live, gf, torch.zeros_like(gf))
    return (gf * m).to(x.dtype), (gf * xf).sum(-1), gf.sum(-1)


def _check_epilogue(name, x, mul, add, g=None):
    check_operand(name, "x", x)
    if g is not None:
        check_operand(name, "g", g, x.dtype)
    if x.dim() != 2 or (g is not None and g.shape != x.shape):
        raise ValueError(f"{name}: x (and g) must be [R, W], got {tuple(x.shape)}")
    for what, v in (("mul", mul), ("add", add)):
        if v.dtype != torch.float32 or v.shape != (x.shape[0],) or not v.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous float32 [{x.shape[0]}], got "
                             f"{v.dtype} {tuple(v.shape)}")


def _epilogue_fwd(x, mul, add, relu):
    name = "fused_scale_shift_relu"
    if not on_card(name, x, mul, add):
        return bn_epilogue_plain(x, mul, add, relu)
    _check_epilogue(name, x, mul, add)
    out = torch.empty_like(x)
    if x.numel():
        _build.call("ptt_bn_epilogue_fwd", x.data_ptr(), mul.data_ptr(), add.data_ptr(),
                    out.data_ptr(), x.shape[0], x.shape[1], int(relu), _DTYPE_CODE[x.dtype],
                    stream_ptr(x))
        LAUNCHES["bn_epilogue_fwd"] += 1
    return out


def bn_epilogue_bwd(x, mul, add, g, relu=True):
    """(dx, dmul, dadd) of fused_scale_shift_relu: the kernel on the card, the
    plain backward on the CPU."""
    name = "fused_scale_shift_relu backward"
    if not on_card(name, x, mul, add, g):
        return bn_epilogue_bwd_plain(x, mul, add, g, relu)
    _check_epilogue(name, x, mul, add, g)
    dx = torch.empty_like(x)
    dmul = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    dadd = torch.empty_like(dmul)
    if x.numel():
        _build.call("ptt_bn_epilogue_bwd", x.data_ptr(), mul.data_ptr(), add.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), dmul.data_ptr(), dadd.data_ptr(), x.shape[0],
                    x.shape[1], int(relu), _DTYPE_CODE[x.dtype], stream_ptr(x))
        LAUNCHES["bn_epilogue_bwd"] += 1
    else:
        dmul.zero_()
        dadd.zero_()
    return dx, dmul, dadd


class _ScaleShiftRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mul, add, relu):
        ctx.save_for_backward(x, mul, add)
        ctx.relu = relu
        return _epilogue_fwd(x, mul, add, relu)

    @staticmethod
    def backward(ctx, g):
        x, mul, add = ctx.saved_tensors
        dx, dm, da = bn_epilogue_bwd(x, mul, add, g.contiguous(), ctx.relu)
        return dx, dm, da, None


def fused_scale_shift_relu(x, mul, add, relu=True):
    """y = max(x * mul + add, 0) (or without the relu) with PER-ROW float32
    mul/add [R] over x:[R, W]; y has x's dtype.  The backward recomputes the
    mask (only x, mul and add are saved) and gives dx in x.dtype and per-row
    float32 dmul, dadd."""
    return _ScaleShiftRelu.apply(x, mul, add, bool(relu))


def bn_epilogue(x, mul, add, relu):
    """The fused epilogue over an NCHW / NC* activation with per-channel
    float32 mul/add (channel axis 1): flatten to [N*C, prod(spatial)], tile
    the channel vectors to rows, run the kernel, restore the shape."""
    n, c = x.shape[0], x.shape[1]
    x2 = x.reshape(n * c, math.prod(x.shape[2:])).contiguous()
    y = fused_scale_shift_relu(x2, mul.reshape(-1).repeat(n), add.reshape(-1).repeat(n), relu)
    return y.reshape(x.shape)


# --------------------------------------------------------------------------
# softmax + cross-entropy (hard labels)
# --------------------------------------------------------------------------


def softmax_xent_fwd_plain(logits, labels, ignore_index=-100):
    """The arithmetic of paddle_tpu/ops/pallas_kernels.py _sxe_fwd_kernel:
    loss = lse(x) - x[label] in float32, 0 where label == ignore_index (and
    a label outside [0, V) picks 0).  Returns (loss [R], lse [R]), both
    float32; the kernel saves lse for its backward."""
    xf = logits.float()
    m = xf.max(-1, keepdim=True).values
    lse = (torch.log(torch.exp(xf - m).sum(-1, keepdim=True)) + m)[:, 0]
    v = logits.shape[-1]
    lab = labels.long()
    inside = (lab >= 0) & (lab < v)
    picked = xf.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
    picked = torch.where(inside, picked, torch.zeros_like(picked))
    loss = torch.where(lab == ignore_index, torch.zeros_like(lse), lse - picked)
    return loss, lse


def softmax_xent_bwd_plain(logits, labels, lse, g, ignore_index=-100):
    """The arithmetic of _sxe_bwd_kernel, with the softmax taken from the
    saved lse: dx = (exp(x - lse) - onehot(label)) * g, 0 on ignored rows,
    in logits' dtype."""
    xf = logits.float()
    lab = labels.long()
    v = logits.shape[-1]
    onehot = torch.arange(v, device=logits.device)[None, :] == lab[:, None]
    dx = (torch.exp(xf - lse[:, None]) - onehot.float()) * g.float()[:, None]
    dx = torch.where((lab == ignore_index)[:, None], torch.zeros_like(dx), dx)
    return dx.to(logits.dtype)


def _check_xent(name, logits, labels):
    if logits.dim() != 2 or labels.shape != (logits.shape[0],):
        raise ValueError(f"{name}: logits must be [R, V] and labels [R], got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    check_operand(name, "logits", logits)


def softmax_xent_fwd(logits, labels, ignore_index=-100):
    """(loss [R], lse [R]) float32: the kernel on the card, the plain
    version on the CPU.  Labels are taken as int32 (the x32 rule)."""
    name = "fused_softmax_xent"
    if not on_card(name, logits, labels):
        return softmax_xent_fwd_plain(logits, labels, ignore_index)
    _check_xent(name, logits, labels)
    labels = labels.to(torch.int32).contiguous()
    rows, v = logits.shape
    loss = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lse = torch.empty(rows, dtype=torch.float32, device=logits.device)
    _build.call("ptt_softmax_xent_fwd", logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
                lse.data_ptr(), rows, v, int(ignore_index), _DTYPE_CODE[logits.dtype],
                stream_ptr(logits))
    LAUNCHES["softmax_xent_fwd"] += 1
    return loss, lse


def softmax_xent_bwd(logits, labels, lse, g, ignore_index=-100):
    """d(loss)/d(logits) for the upstream g [R]: the kernel on the card,
    the plain backward on the CPU."""
    name = "fused_softmax_xent backward"
    if not on_card(name, logits, labels, lse, g):
        return softmax_xent_bwd_plain(logits, labels, lse, g, ignore_index)
    _check_xent(name, logits, labels)
    labels = labels.to(torch.int32).contiguous()
    g = g.float().contiguous()
    if lse.shape != labels.shape or g.shape != labels.shape or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse and g must be float32 [{labels.shape[0]}]")
    dx = torch.empty_like(logits)
    rows, v = logits.shape
    _build.call("ptt_softmax_xent_bwd", logits.data_ptr(), labels.data_ptr(),
                lse.contiguous().data_ptr(), g.data_ptr(), dx.data_ptr(), rows, v,
                int(ignore_index), _DTYPE_CODE[logits.dtype], stream_ptr(logits))
    LAUNCHES["softmax_xent_bwd"] += 1
    return dx


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, ignore_index):
        loss, lse = softmax_xent_fwd(logits, labels, ignore_index)
        ctx.save_for_backward(logits, labels, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return softmax_xent_bwd(logits, labels, lse, g.contiguous(), ctx.ignore_index), None, None


def fused_softmax_xent(logits, labels, ignore_index=-100):
    """loss[i] = logsumexp(logits[i]) - logits[i, labels[i]].

    logits: [R, V]; labels: [R] integer.  Loss is float32 [R, 1]; rows whose
    label equals ignore_index get zero loss and zero gradient.  The softmax
    is never materialized."""
    return _SoftmaxXent.apply(logits, labels, int(ignore_index))[:, None]


# --------------------------------------------------------------------------
# Adam
# --------------------------------------------------------------------------


def adam_plain(p, g, m, v, lr_t, beta1, beta2, eps):
    """paddle_tpu/ops/pallas_kernels.py _adam_kernel: one Adam step in
    float32 with the bias-corrected step size lr_t given; returns new
    (p, m, v) in the dtypes of the inputs."""
    gf = g.float()
    m2 = beta1 * m.float() + (1.0 - beta1) * gf
    v2 = beta2 * v.float() + (1.0 - beta2) * (gf * gf)
    p2 = p.float() - lr_t * m2 / (torch.sqrt(v2) + eps)
    return p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)


def fused_adam(p, g, m, v, lr_t, beta1, beta2, eps, found_inf=None):
    """One Adam step over a parameter of any shape and size; lr_t is a
    float32 tensor of one element, read by the kernel on the device.
    found_inf (AMP's overflow flag, one bool, or None) skips the step when
    set: the kernel reads it on the device and writes nothing, and is
    launched (and counted) whatever it says, as a graph's replay launches it.

    On the card p, m and v are updated in place and returned; on the CPU
    the plain version returns new tensors, the inputs' values where
    found_inf is set (a device select, no host read)."""
    name = "fused_adam"
    if not on_card(name, p, g, m, v, lr_t, found_inf):
        new = adam_plain(p, g, m, v, lr_t.reshape(()).float(), beta1, beta2, eps)
        if found_inf is None:
            return new
        return tuple(torch.where(found_inf.reshape(()), old, n) for old, n in zip((p, m, v), new))
    check_operand(name, "p", p)
    check_operand(name, "g", g)
    check_operand(name, "m", m)
    check_operand(name, "v", v, m.dtype)
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"{name}: p, g, m and v must share a shape")
    if lr_t.numel() != 1 or lr_t.dtype != torch.float32:
        raise ValueError(f"{name}: lr_t must be one float32")
    if found_inf is not None and (found_inf.numel() != 1 or found_inf.dtype != torch.bool):
        raise ValueError(f"{name}: found_inf must be one bool")
    _build.call("ptt_adam", p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                lr_t.contiguous().data_ptr(),
                None if found_inf is None else found_inf.contiguous().data_ptr(), p.numel(),
                float(beta1), float(beta2), float(eps),
                _DTYPE_CODE[p.dtype], _DTYPE_CODE[g.dtype], _DTYPE_CODE[m.dtype], stream_ptr(p))
    LAUNCHES["adam"] += 1
    return p, m, v


# --------------------------------------------------------------------------
# kernel registry (tools/port_opbench.py --fused, the tests)
# --------------------------------------------------------------------------
# paddle_tpu/ops/pallas_kernels.py FUSED_KERNELS: the same five entries,
# examples at the same shapes and dtypes from the same seeds, the same
# tolerances and `analytic` (flops, bytes) formulas.  `fused` is the port's
# kernel (its plain version on CPU tensors), `reference` the plain version;
# both take the example tuple.  On the card `fused_adam` updates p, m and v
# in place.


def _example_tensor(a, dtype, device):
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _ln_example(dtype, rows=256, d=512, residual=True, rng_seed=0, device="cpu"):
    import numpy as np

    rng = np.random.RandomState(rng_seed)
    x = _example_tensor(rng.randn(rows, d), dtype, device)
    res = _example_tensor(rng.randn(rows, d), dtype, device) if residual else None
    scale = _example_tensor(rng.rand(d) + 0.5, torch.float32, device)
    bias = _example_tensor(rng.randn(d) * 0.1, torch.float32, device)
    return (x, res, scale, bias)


def _epilogue_example(dtype, n=8, c=64, hw=196, rng_seed=0, device="cpu"):
    import numpy as np

    rng = np.random.RandomState(rng_seed)
    x = _example_tensor(rng.randn(n, c, hw), dtype, device)
    mul = _example_tensor(rng.rand(c) + 0.5, torch.float32, device)
    add = _example_tensor(rng.randn(c) * 0.1, torch.float32, device)
    return (x, mul, add)


def _adam_example(dtype, shape=(512, 256), rng_seed=0, device="cpu"):
    import numpy as np

    rng = np.random.RandomState(rng_seed)
    p = _example_tensor(rng.randn(*shape), dtype, device)
    g = _example_tensor(rng.randn(*shape) * 0.01, dtype, device)
    m = _example_tensor(rng.randn(*shape) * 0.001, torch.float32, device)
    v = _example_tensor(rng.rand(*shape) * 1e-4, torch.float32, device)
    return (p, g, m, v)


def _sxe_example(dtype, rows=256, v=1024, rng_seed=0, device="cpu"):
    import numpy as np

    rng = np.random.RandomState(rng_seed)
    logits = _example_tensor(rng.randn(rows, v) * 2.0, dtype, device)
    labels = _example_tensor(rng.randint(0, v, size=rows), torch.int32, device)
    return (logits, labels)


def _bias_act_example(dtype, rows=512, d=1024, rng_seed=0, device="cpu"):
    import numpy as np

    rng = np.random.RandomState(rng_seed)
    x = _example_tensor(rng.randn(rows, d), dtype, device)
    b = _example_tensor(rng.randn(d) * 0.1, torch.float32, device)
    return (x, b)


_ADAM_LR_T: Dict[torch.device, torch.Tensor] = {}


def _adam_lr_t(device):
    """The registry's Adam step size 1e-3 as the one-element float32 tensor
    `fused_adam` reads on the device, made once a device."""
    if device not in _ADAM_LR_T:
        _ADAM_LR_T[device] = torch.full((1,), 1e-3, dtype=torch.float32, device=device)
    return _ADAM_LR_T[device]


def _nbytes(a):
    return int(a.numel()) * int(a.element_size())


def _ln_analytic(args):
    x, res, scale, bias = args
    streams = _nbytes(x) * (3 if res is not None else 2)
    return 10.0 * x.numel(), float(streams + _nbytes(scale) + _nbytes(bias))


def _epilogue_analytic(args):
    x, mul, add = args
    return 3.0 * x.numel(), float(2 * _nbytes(x) + _nbytes(mul) + _nbytes(add))


def _adam_analytic(args):
    p, g, m, v = args
    io = 2 * (_nbytes(p) + _nbytes(m) + _nbytes(v)) + _nbytes(g)
    return 10.0 * p.numel(), float(io)


def _sxe_analytic(args):
    logits, labels = args
    return (8.0 * logits.numel(),
            float(_nbytes(logits) + _nbytes(labels) + logits.shape[0] * 4))


def _bias_act_analytic(args):
    x, b = args
    return 9.0 * x.numel(), float(2 * _nbytes(x) + _nbytes(b))


FUSED_KERNELS: Dict[str, dict] = {
    "ln_residual": {
        "fused": lambda args: fused_ln_residual(args[0], args[1], args[2], args[3], 1e-5),
        "reference": lambda args: ln_residual_plain(*args),
        "example": _ln_example,
        "tol": {"float32": 2e-5, "bfloat16": 5e-2},
        "grad_argnums": (0, 1, 2, 3),
        "analytic": _ln_analytic,
    },
    "bn_scale_shift_relu": {
        "fused": lambda args: bn_epilogue(args[0], args[1], args[2], True),
        "reference": lambda args: bn_epilogue_plain(
            args[0].reshape(-1, args[0].shape[-1]), args[1].repeat(args[0].shape[0]),
            args[2].repeat(args[0].shape[0]), True).reshape(args[0].shape),
        "example": _epilogue_example,
        "tol": {"float32": 2e-5, "bfloat16": 2e-2},
        "grad_argnums": (0, 1, 2),
        "analytic": _epilogue_analytic,
    },
    "adam_slab": {
        "fused": lambda args: fused_adam(args[0], args[1], args[2], args[3],
                                         _adam_lr_t(args[0].device), 0.9, 0.999, 1e-8),
        "reference": lambda args: adam_plain(args[0], args[1], args[2], args[3],
                                             _adam_lr_t(args[0].device), 0.9, 0.999, 1e-8),
        "example": _adam_example,
        "tol": {"float32": 2e-6, "bfloat16": 1e-2},
        "grad_argnums": (),  # state update, not a differentiable layer
        "analytic": _adam_analytic,
    },
    "softmax_xent": {
        "fused": lambda args: fused_softmax_xent(args[0], args[1], -100),
        "reference": lambda args: softmax_xent_fwd_plain(args[0], args[1], -100)[0][:, None],
        "example": _sxe_example,
        "tol": {"float32": 2e-5, "bfloat16": 5e-2},
        "grad_argnums": (0,),  # labels are integral
        "analytic": _sxe_analytic,
    },
    "bias_act": {
        "fused": lambda args: fused_bias_act(args[0], args[1], "gelu"),
        "reference": lambda args: bias_act_plain(args[0], args[1], "gelu"),
        "example": _bias_act_example,
        "tol": {"float32": 2e-5, "bfloat16": 5e-2},
        "grad_argnums": (0, 1),
        "analytic": _bias_act_analytic,
    },
}


def registered_fused_kernels():
    return sorted(FUSED_KERNELS)
