"""Hand-written Hopper scaled-dot-product attention, forward and backward,
with its plain PyTorch versions (counterpart of
paddle_tpu/ops/pallas_attention.py fused_sdpa and of the stock streaming
flash kernel that paddle_tpu/ops/nn_ops.py calls for long sequences).

Routing as in ops/cuda_kernels.py: CPU tensors take `sdpa_plain` and
`sdpa_bwd_plain`; CUDA tensors launch `csrc/flash_attention.cu` (forward,
then in the backward the dQ kernel and the dK/dV kernel) and bump
`LAUNCHES["attention_fwd"]`, `["attention_bwd_dq"]` and
`["attention_bwd_dkv"]`.

Contract (the JAX composite's and fused_sdpa's): q [B, H, Lq, dh], k and v
[B, H, Lk, dh], one dtype (float32, bfloat16 or float16), dh in {16, 32, 64,
128} on the card, any length; optional additive bias [B, 1|H, Lq, Lk], not
differentiable (pallas_attention.py:16-19); causal masking keeps key c for
query i when c <= i + (Lk - Lq), masked scores are -1e30.

float16 inputs take the bfloat16 inputs' mma.sync kernels instantiated for
float16 (P rounded to float16 before the PV product, as the composite's
p.astype(q.dtype)), and their own rules, FWD_F16_RULE and BWD_F16_RULE.

`score_bf16=True` is the composite's score_dtype="bfloat16"
(paddle_tpu/ops/nn_ops.py:680-684), for float32, bfloat16 and float16
inputs alike:
s is rounded to bf16, the row max m is taken over the rounded scores, and
P = exp(f32(bf16(s - m))) / sum, the sum in float32.  For bfloat16 inputs
its kernels are warpgroup kernels of their own (wgmma fed by a TMA producer
warp): the forward in csrc/attention_fwd_bs.cu (each score computed once and
kept on chip, long rows split over a thread-block cluster, see
`bf16_score_fwd_plan`), dQ and dK/dV in csrc/attention_bwd_bs.cu; float32
inputs take flash_attention.cu's float32 twins (compile-time variant kBS),
and so do float16 inputs, the twins instantiated for float16 loads (P / l
rounded to float16 before the PV product and in dV, dS kept float32).
They count under `LAUNCHES["attention_fwd_bf16_scores"]`,
`["attention_bwd_dq_bf16_scores"]` and `["attention_bwd_dkv_bf16_scores"]`;
their saved statistics are [2, B, H, Lq]: log of the row sum, and m; the
dQ kernel hands the dK/dV kernel [2, B, H, Lq] too: di, and each row's share
of its max's cotangent (the backward is the composite's full VJP, the
gradient through the row max included).
"""
from __future__ import annotations

import torch

from .. import _build
from .cuda_kernels import LAUNCHES, ROUNDING, _DTYPE_CODE, _ptr, check_operand, on_card, stream_ptr

_HEAD_DIMS = (16, 32, 64, 128)
# the bf16-score forward (csrc/attention_fwd_bs.cu): keys a tile, score tiles
# one CTA's buffer holds (by head dim), the largest cluster
_BS_TILE = 64
_BS_BUF_TILES = {16: 8, 32: 8, 64: 8, 128: 4}
_BS_MAX_CLUSTER = 8


def bf16_score_fwd_plan(lk, dh):
    """The path the bf16-score forward of bfloat16 inputs takes at key length
    `lk` (csrc/attention_fwd_bs.cu plan_of, which ptt_attention_fwd_bs_plan
    reports): `cluster` CTAs (the least power of 2 whose score buffers hold
    the row's key tiles, at most 8) share each block of 64 query rows, each
    takes at most `per_cta` key tiles of 64, keeps `buffered` of them on
    chip and recomputes the other `recomputed` in its later passes."""
    if dh not in _BS_BUF_TILES or lk < 1:
        raise ValueError(f"bf16_score_fwd_plan: head dim {dh}, key length {lk}")
    tiles = -(-lk // _BS_TILE)
    buf = _BS_BUF_TILES[dh]
    need = -(-tiles // buf)
    cluster = 1
    while cluster < need and cluster < _BS_MAX_CLUSTER:
        cluster *= 2
    per = -(-tiles // cluster)
    kept = min(per, buf)
    return {"cluster": cluster, "per_cta": per, "buffered": kept, "recomputed": per - kept}


def _scores_plain(q, k, bias, causal, scale):
    """float32 scores of the composite, and the causal keep-mask (or None)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    keep = None
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril(lk - lq)
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    return s, keep


def _probs_plain(q, k, bias, causal, scale, score_bf16):
    """float32 P of the composite, the rounded scores and their row max (the
    last two None unless score_bf16), and the causal keep-mask."""
    s, keep = _scores_plain(q, k, bias, causal, scale)
    if not score_bf16:
        return torch.softmax(s, dim=-1), None, None, keep
    sb = s.to(torch.bfloat16)
    m = sb.amax(-1, keepdim=True)
    e = torch.exp((sb - m).float())
    return e / e.sum(-1, keepdim=True), sb.float(), m.float(), keep


def sdpa_plain(q, k, v, bias, causal, scale, score_bf16=False):
    """The JAX composite attention (paddle_tpu/ops/nn_ops.py:672-689): float32
    scores and softmax (score_bf16: the bf16-score softmax of :680-684), P
    rounded to q.dtype before the PV product, which accumulates in float32."""
    p = _probs_plain(q, k, bias, causal, scale, score_bf16)[0]
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def _xla_bf16_sum(x):
    """Sum over the last axis of `x` (float32 holding bf16 values) as XLA's
    CPU backend sums a bfloat16 reduce_sum: every partial sum rounded to
    bf16 (the reduction's add is a float32 add converted to bf16), in its
    order: a row of at most 32 left to right; a longer one zero-padded to a
    multiple of 32 (the lower half of the padding first), each window of 32
    summed left to right, then the window sums reduced the same way."""
    n = x.shape[-1]
    if n > 32:
        m = -(-n // 32) * 32
        lo = (m - n) // 2
        x = torch.nn.functional.pad(x, (lo, m - n - lo))
        x = _xla_bf16_sum(x.reshape(*x.shape[:-1], m // 32, 32))
        return _xla_bf16_sum(x)
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(n):
        acc = (acc + x[..., i]).to(torch.bfloat16).float()
    return acc


def _max_cotangent(g, sb, m):
    """The bf16 cotangent of the rounded scores with the row max's share
    (score_bf16): g = bf16(P (dP - di)) everywhere, plus t = bf16(dm / c) in
    bf16 at the c scores tied at the row max m, dm = -sum_j g_j (jax.vjp of
    the composite's max, paddle_tpu/ops/nn_ops.py:681: the max's cotangent
    split evenly among its ties, add_any in bf16).  The sum and the count
    are taken in float32 and rounded once, as the kernels take them (the
    JAX composite's order is `_xla_bf16_sum`'s)."""
    tied = sb == m
    dm = -g.sum(-1).to(torch.bfloat16).float()
    t = (dm / tied.sum(-1).float()).to(torch.bfloat16).float().unsqueeze(-1)
    return torch.where(tied, (g + t).to(torch.bfloat16).float(), g)


def _probs_and_dscores(q, k, v, bias, causal, scale, out, dout, score_bf16=False):
    """float32 P and dS of the backward: dP = dO V^T, di = rowsum(dO * O)
    from the forward's output, dS = P (dP - di) scale rounded to q.dtype
    (save with bf16 scores and float16 inputs, below).

    score_bf16: the full VJP of the composite's bf16 scores.  P (dP - di) is
    rounded to bf16 (the VJP of the cast of s - m), and the row max m sends
    back dm = -sum_j bf16(P_j (dP_j - di)), 0 in exact arithmetic but not
    after the roundings: its share bf16(dm / c) is added in bf16 at each of
    the c scores tied at m (`_max_cotangent`), then the sum is scaled.  XLA's
    CPU backend forms that bf16 sum in bf16 steps, each partial sum rounded
    (a probe of rows whose partial sums land on bf16 boundaries: 1 + 4 x
    2^-8 sums to 1, not to 1 + 2^-6), over windows of 32 keys
    (`_xla_bf16_sum` mirrors it bit for bit).  The kernels cannot mirror that
    order (a row's keys are spread over the lanes of a quad and over tiles)
    at a cost the backward can carry: they sum the bf16 values in float32 and
    round once, and so does this version, the kernels' plain version.  The
    two orders part by about as much as dm itself (each step's rounding is
    of the order of the g's own), so TIE_RULE states what the float32 orders
    may move, and, against the composite (`tie_allowed`'s xla_order), what
    its order moves.  A masked score is a constant, so its dS is 0.

    float16 inputs with bf16 scores, as jax.make_jaxpr(jax.vjp(...)) of the
    composite reads at 65 keys and with forced ties: the scores and s - m
    round to bf16 as above; the normalized P = e / l (float32) is rounded to
    float16 once, before the PV product (`u:f16 = convert(s)`), and that
    float16 P is also dV's operand (dV = f16(P16^T dO), summed in float32);
    the cotangent of P is float16 (dP = f16(dO V^T), widened to float32),
    that of the rounded scores is bf16 (`bf16(P (dP - di))`), and the row
    max's cotangent is C5's: dm = -sum_j of those bf16 values in bf16 steps,
    each of the c ties taking bf16(dm / c) added in bf16; then the sum is
    widened to float32 and scaled, and dS stays float32 into dQ = dS K and
    dK = dS^T Q (each summed in float32, rounded once to float16).  The port
    follows those roundings but two: dP stays float32, and di is rowsum(dO *
    O) from the rounded output, not sum_j P_j f16(dP_j) (the flash
    formulation every kernel of the port shares; the tests hold the
    difference by their tolerances).  So dS is not rounded to float16 here,
    nor in the kernels (flash_attention.cu's FFMA kBS twins, instantiated
    for float16 loads)."""
    p, sb, m, keep = _probs_plain(q, k, bias, causal, scale, score_bf16)
    do = dout.float()
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    di = (do * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - di)
    if score_bf16:
        ds = _max_cotangent(ds.to(torch.bfloat16).float(), sb, m)
    ds = ds * scale
    if keep is not None:
        ds = torch.where(keep, ds, torch.zeros_like(ds))
    if score_bf16 and q.dtype == torch.float16:
        return p, ds
    return p, ds.to(q.dtype).float()


def sdpa_bwd_dq_plain(q, k, v, bias, causal, scale, out, dout, score_bf16=False):
    """dq of `sdpa_plain`, the plain version of the dQ kernel: dQ = dS K."""
    _, ds = _probs_and_dscores(q, k, v, bias, causal, scale, out, dout, score_bf16)
    return torch.matmul(ds, k.float()).to(q.dtype)


def sdpa_bwd_dkv_plain(q, k, v, bias, causal, scale, out, dout, score_bf16=False):
    """(dk, dv) of `sdpa_plain`, the plain version of the dK/dV kernel:
    dK = dS^T Q, dV = P^T dO with P rounded to q.dtype."""
    p, ds = _probs_and_dscores(q, k, v, bias, causal, scale, out, dout, score_bf16)
    return _dkv(p, ds, q, v, dout)


def _dkv(p, ds, q, v, dout):
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), dout.float())
    return dk.to(q.dtype), dv.to(v.dtype)


FWD_BF16_RULE = "2^-7 * (|plain| + sdpa_plain(q, k, |v|)), at most 5e-2"
FWD_F16_RULE = ("2^-10 * (|plain| + sdpa_plain(q, k, |v|)) + 2^-24 * (1 + sum_j |v_j|), at most "
                "6.25e-3")
# the flat cap of a 16-bit dtype's rules: 5e-2 in bf16, the same 12.8 steps,
# 6.25e-3, in float16
_RULE_CAP = {torch.bfloat16: 5e-2, torch.float16: 6.25e-3}


def _rule_form(dtype):
    """(one step of a rounding on either side, 2 u, u the unit roundoff;
    the subnormal step, 2^-24 in float16, which an element below 2^-14 may
    move by; the flat cap) of the rules of 16-bit inputs of `dtype`, from
    cuda_kernels.ROUNDING."""
    u, sub = ROUNDING[dtype]
    return 2.0 * u, 2.0 * sub, _RULE_CAP[dtype]


def fwd_rule(dtype):
    """The name of the forward rule of 16-bit inputs of `dtype`."""
    return FWD_F16_RULE if dtype == torch.float16 else FWD_BF16_RULE


def bwd_rule(dtype):
    """The name of the backward rule of 16-bit inputs of `dtype`."""
    return BWD_F16_RULE if dtype == torch.float16 else BWD_BF16_RULE


def sdpa_fwd_bf16_allowed(q, k, v, bias, causal, scale, want, score_bf16=False):
    """What a 16-bit forward's output may differ from the plain output
    `want` by, element by element (FWD_BF16_RULE; float16 inputs
    FWD_F16_RULE, the same with float16's step 2^-10 in place of 2^-7, its
    subnormal step 2^-24 for each P below 2^-14 and for the output, and the
    cap scaled alike).  Of bfloat16: the worst case of the
    roundings the two make differently.  Each rounds every probability to
    bfloat16 before the PV product (a kernel the unnormalized exp(s - m),
    the plain version the normalized p), 2^-8 of each term at most, so
    2^-7 * sum_j p_j |v_j| for the two, which is sdpa_plain(q, k, |v|); each
    rounds its output once, 2^-7 * |want| for the two.  At most the flat
    5e-2 of the other bfloat16 forwards.  At seq 2048 a row spreads over
    hundreds of keys and |out| is ~0.04, below what a flat 5e-2 can see."""
    step, sub, cap = _rule_form(q.dtype)
    pv = sdpa_plain(q, k, v.abs(), bias, causal, scale, score_bf16).float()
    allowed = step * (want.float().abs() + pv)
    if sub:
        allowed += sub * (1.0 + v.float().abs().sum(-2, keepdim=True))
    return torch.clamp(allowed, max=cap)


BWD_BF16_RULE = ("2^-7 * (|plain| + |dS| |K|) + E |K| for dq, 2^-7 * (|plain| + |dS|^T |Q|) "
                 "+ E^T |Q| for dk, 2^-7 * (|plain| + P^T |dO|) for dv, E = 2^-16 * P * scale * "
                 "(|dO| |V|^T + rowsum(|dO| |O|)); at most 5e-2 * max|plain|")
BWD_F16_RULE = ("BWD_BF16_RULE with float16's step: 2^-10 * (|plain| + |dS| |K|) + (E + 2^-24) |K| "
                "for dq, 2^-10 * (|plain| + |dS|^T |Q|) + (E + 2^-24)^T |Q| for dk, 2^-10 * "
                "|plain| + (2^-10 P + 2^-24)^T |dO| for dv, each + 2^-24; at most 6.25e-3 * "
                "max|plain|")


def sdpa_bwd_bf16_allowed(q, k, v, bias, causal, scale, out, dout, want, score_bf16=False):
    """What a 16-bit backward's (dq, dk, dv) may differ from the plain
    versions' `want` by, element by element (BWD_BF16_RULE; float16 inputs
    BWD_F16_RULE, the same with float16's step 2^-10 in place of 2^-7 and
    its subnormal step 2^-24 for every rounded dS and P and each output,
    the cap scaled alike).  Of bfloat16: the roundings
    the two make differently.  Both round dS (and, for dv, P) to bfloat16
    from float32 values whose last bits differ (sums taken in another
    order), so a term of each product may land one bfloat16 step apart, at
    most 2^-7 of it: 2^-7 |dS| |K|, |dS|^T |Q|, P^T |dO| summed.  Where
    dP - di cancels (a query row that sees one key has dP = di), dS is the
    float32 error of dP - di itself, not relative to dS: each of the two
    dh-term sums is off by at most dh * 2^-24 <= 2^-17 of the sum of its
    terms' magnitudes on either side, so E = 2^-16 * P * scale * (|dO| |V|^T
    + rowsum(|dO| |O|)) more in dS.  Both round their float32 sums once, at
    most 2^-7 |want| apart.  Capped at the flat 5e-2 * max|want| it
    replaces."""
    step, sub, cap = _rule_form(q.dtype)
    p, ds = _probs_and_dscores(q, k, v, bias, causal, scale, out, dout, score_bf16)
    ado = dout.float().abs()
    e = torch.matmul(ado, v.float().abs().transpose(-1, -2))
    e += (ado * out.float().abs()).sum(-1, keepdim=True)
    e *= p * (2.0 ** -16 * scale)
    ads = ds.abs().mul_(step).add_(e).add_(sub)
    del e
    pb = p.to(q.dtype).float().mul_(step).add_(sub)
    terms = (torch.matmul(ads, k.float().abs()),
             torch.matmul(ads.transpose(-1, -2), q.float().abs()),
             torch.matmul(pb.transpose(-1, -2), ado))
    allowed = []
    for w, t in zip(want, terms):
        wf = w.float().abs()
        allowed.append(torch.clamp(step * wf + sub + t, max=cap * float(wf.max())) + 1e-30)
    return tuple(allowed)


SCORE_ROUNDING_RULE = ("2^-6 (|s_j| + |m|) of each term of sum_j P_j (v_j - out) for out, of "
                       "|dS| |K| for dq, |dS|^T |Q| for dk, P^T |dO| for dv, at the scores whose "
                       "bf16 rounding can flip (s within eps = 2 dh 2^-24 scale |q| |k|^T + "
                       "2^-23 (|s| + |bias|) of a rounding boundary, and every score of a row "
                       "whose max can flip); float32 and float16 inputs also 2^-7 of the terms "
                       "of |dS| |K| "
                       "and |dS|^T |Q| at the dS whose bf16 rounding can flip (P (dP - di) "
                       "within P 2^-16 (|dO| |V|^T + rowsum(|dO| |O|)) + |P (dP - di)| "
                       "2^-24 (2 Lk + 8 + 3 |log P|) of a rounding boundary)")


def _near_boundary(x, xb, eps):
    """Where the float32 `x`, rounded to bf16 as `xb`, lies within `eps` of
    a bf16 rounding boundary (half a bf16 step from `xb`): a value that
    differs from `x` by at most eps may round to a neighbouring bf16 value."""
    half_ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 9)
    return (half_ulp - (x - xb).abs()) <= eps


def _score_flips(q, k, bias, causal, scale):
    """(P, the rounded scores, their row max m, share, rival) of the
    bf16-score softmax: share is 2^-6 (|s| + |m|) at the scores whose bf16
    rounding can flip between two orders of the same sums (s within eps = 2
    dh 2^-24 scale |q| |k|^T + 2^-23 (|s| + |bias|) of a rounding boundary)
    and at every score of a row whose max can flip, else 0; rival marks, in
    a row where a score near a boundary lies within two bf16 steps of m (its
    max or its ties may differ), the scores that may be tied at the max on
    either side."""
    s, keep = _scores_plain(q, k, bias, causal, scale)
    p, sb, m, _ = _probs_plain(q, k, bias, causal, scale, True)
    dh = q.shape[-1]
    eps = torch.matmul(q.float().abs(), k.float().abs().transpose(-1, -2)) * (
        2.0 * dh * 2.0 ** -24 * scale) + 2.0 ** -23 * s.abs()
    if bias is not None:
        eps += 2.0 ** -23 * bias.float().abs()
    near = _near_boundary(s, sb, eps)
    del eps, s
    if keep is not None:
        near &= keep
    flip = (near & (sb == m)).any(-1, keepdim=True)
    # the scores that may round to a row's max, or off it: near a boundary
    # and within two bf16 steps of m; their rows' ties may differ
    step = torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8)
    close = near & (sb >= m - 2 * step)
    rival = close.any(-1, keepdim=True) & (close | (sb == m))
    near |= flip
    if keep is not None:
        near &= keep
        rival &= keep
    share = torch.where(near, (sb.abs() + m.abs()) * 2.0 ** -6, torch.zeros_like(sb))
    return p, sb, m, share, rival


def _dscore_flips(p, v, out, dout):
    """(x, near, e): x = P (dP - di) in float32, e the most another order
    of its sums may move it (dP and di are dh-term sums, each side within dh
    2^-24 <= 2^-17 of the sum of its terms' magnitudes, and P's relative
    error is the row sum's, the log's and the exp's, within 2^-24 (2 Lk + 8
    + 3 |log P|)), and where x lies near enough to a bf16 rounding boundary
    that it may round to the neighbouring value."""
    do = dout.float()
    x = p * (torch.matmul(do, v.float().transpose(-1, -2))
             - (do * out.float()).sum(-1, keepdim=True))
    ado = do.abs()
    e = torch.matmul(ado, v.float().abs().transpose(-1, -2))
    e += (ado * out.float().abs()).sum(-1, keepdim=True)
    e *= p * 2.0 ** -16
    lk = v.shape[-2]
    e += x.abs() * (2.0 ** -24 * (2 * lk + 8 + 3 * p.clamp_min(1e-38).log().abs()))
    return x, _near_boundary(x, x.to(torch.bfloat16).float(), e), e


def score_rounding_allowed(q, k, v, bias, causal, scale, out=None, dout=None):
    """What a bf16-score kernel's output (out=None) or gradients (dq, dk, dv)
    may differ from the plain versions' by beyond the other terms of their
    rules (SCORE_ROUNDING_RULE).  Both sides round each float32 score to
    bf16 from float32 values that differ in their last bits (dh products
    summed in another order: at most eps apart), so a score within eps of a
    bf16 rounding boundary may round one bf16 step (at most 2^-7 of it)
    apart, and with it s - m; a row whose max is such a score may have
    another m, and then every s - m of the row rounds anew.  Such a P_j
    moves by at most a factor exp(2^-7 (|s_j| + |m| + |s_j - m|)), within
    2^-6 (|s_j| + |m|) of 1.  The output moves by that share of the terms of
    sum_j P_j (v_j - out); each gradient by that share of the terms of its
    product (dS = P (dP - di) moves with P).  Elsewhere both sides round
    alike: a kernel that does not round its scores is not admitted.

    With float32 inputs (and float16 ones, whose kernels are the float32
    twins with float16 loads: the same float32 arithmetic from there, so
    the rule's float16 form is its float32 one) both sides also round each
    x = P (dP - di) to bf16
    (the cast's VJP) from float32 values that differ in their last bits:
    dP and di are dh-term sums (each side within dh 2^-24 <= 2^-17 of the
    sum of its terms' magnitudes, as BWD_BF16_RULE's E), and P's relative
    error is the row sum's (at most Lk - 1 roundings of positive terms on
    either side), the log's and exp's of its argument, within 2^-24 (2 Lk +
    8 + 3 |log P|).  An x within that of a rounding boundary may round one
    bf16 step (2^-7 of dS) apart; elsewhere both round alike, so a kernel
    that does not round dS is not admitted.  The bfloat16 inputs' rule
    (BWD_BF16_RULE) holds a step of every dS already."""
    p, sb, m, share, _ = _score_flips(q, k, bias, causal, scale)
    if dout is None:
        w = p * share
        ref = sdpa_plain(q, k, v, bias, causal, scale, True).float().abs()
        return torch.matmul(w, v.float().abs()) + w.sum(-1, keepdim=True) * ref
    _, ds = _probs_and_dscores(q, k, v, bias, causal, scale, out, dout, True)
    ads = ds.abs().mul_(share)
    if q.dtype != torch.bfloat16:
        near = _dscore_flips(p, v, out, dout)[1]
        ads += torch.where(near, ds.abs() * 2.0 ** -7, torch.zeros_like(ds))
    return (torch.matmul(ads, k.float().abs()),
            torch.matmul(ads.transpose(-1, -2), q.float().abs()),
            torch.matmul((p * share).transpose(-1, -2), dout.float().abs()))


TIE_RULE = ("the kernel's share t' of each row's max cotangent within bf16(bf16(-S') / c), S' "
            "between the plain version's and the kernel's float32 row sums of g = bf16(P (dP - "
            "di)) (the kernel's order mirrored), widened in a row where some g_j may round apart "
            "by e_j + 2^-7 (|g_j| + e_j) + share_j |g_j| (e_j: the error of P (dP - di) "
            "across orders) and 2^-24 Lk sum |g| (against the JAX composite also "
            "its sum in XLA's bf16 steps); then dq and dk: at each score tied at m, scale "
            "|bf16(g + t') - bf16(g + t)|, and in a row whose ties can differ (a score near a "
            "boundary within two bf16 steps of m), scale (d + 2^-7 (|g| + d)), d the largest "
            "|bf16(S')|, at the scores that may be tied at its max; times |K| for dq, |Q| for dk")


def kernel_order_sum(g, dtype):
    """The float32 row sums of g [..., Lk] in the order the dQ kernel of
    inputs of `dtype` takes them, bit for bit: bfloat16 inputs
    (attention_bwd_bs.cu) a lane of a quad its keys 8 j + 2 lane + (0, 1)
    of each 64-key tile, a pair's sum added to the tile's, the tiles' sums
    in order, then (lane 0 + lane 1) + (lane 2 + lane 3); float32 and
    float16 inputs (flash_attention.cu's FFMA twins) a lane its keys lane
    and lane + 32 of each tile in
    order, then the warp's butterfly (16, 8, 4, 2, 1) as lane 0 sees it.
    Masked and past-the-end keys are 0 there, as in `g`."""
    n = g.shape[-1]
    tiles = -(-n // 64)
    gp = torch.nn.functional.pad(g, (0, tiles * 64 - n))
    if dtype == torch.bfloat16:
        gp = gp.reshape(*g.shape[:-1], tiles, 8, 4, 2)
        pair = gp[..., 0] + gp[..., 1]
        part = torch.zeros_like(pair[..., 0, :])
        for j in range(8):
            part = part + pair[..., j, :]
        acc = torch.zeros_like(part[..., 0, :])
        for t in range(tiles):
            acc = acc + part[..., t, :]
        return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    gp = gp.reshape(*g.shape[:-1], tiles, 2, 32)
    acc = torch.zeros_like(gp[..., 0, 0, :])
    for t in range(tiles):
        for h in range(2):
            acc = acc + gp[..., t, h, :]
    lanes = torch.arange(32, device=g.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def _tie_range(q, k, v, bias, causal, scale, out, dout, xla_order=False):
    """The pieces of TIE_RULE: g, the plain version's bf16 cotangent (with
    its shares), the tied scores, the rival ones (rows whose ties can differ),
    the causal keep-mask, the ends of dm's range and of t's.

    Both the plain version and a kernel sum the row's bf16 values g in
    float32 and round once, each in an order of its own: the kernel's is
    mirrored bit for bit (`kernel_order_sum`), so where both take the same
    g the range is the two sums.  A g_j that may round apart (every one
    with bfloat16 inputs, those near a boundary with float32 and float16
    inputs,
    `_dscore_flips`: by its x's error e_j and a bf16 step of the larger,
    all of g_j where dP - di cancels), or whose P may move with a flipped
    score (share, as in score_rounding_allowed), moves its row's sum by
    that much more, and the roundings after it by at most 2^-24 Lk sum |g|.
    The kernels count only the unmasked ties (a row all masked is masked
    whole).  Rounding and dividing by a positive count keep order, so t =
    bf16(bf16(-S) / c) lies between its values at the ends of S's range and
    the counts.  xla_order: the JAX composite's sum and count, in XLA's
    bf16 steps (`_xla_bf16_sum`), make one more end."""
    p, sb, m, share, rival = _score_flips(q, k, bias, causal, scale)
    keep = None
    if causal:
        lq, lk = sb.shape[-2:]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=sb.device).tril(lk - lq)
    x, near, e = _dscore_flips(p, v, out, dout)
    g = x.to(torch.bfloat16).float()
    near |= (x == 0) & (e > 0)  # an exact 0 (dP = di) may come out as a tiny value
    del x
    if q.dtype == torch.bfloat16:
        near = torch.ones_like(near)
    ag = g.abs()
    apart = near | (share > 0)
    del near
    # rows where some g may round apart: their float32 sums may part too.
    # Such a g moves by its x's error e, and the two roundings by a bf16
    # step of the larger (where dP - di cancels, e exceeds x itself)
    moved = torch.where(apart, e + 2.0 ** -7 * (ag + e), torch.zeros_like(ag)) + share * ag
    del e
    eps = torch.where(apart.any(-1), moved.sum(-1) + 2.0 ** -24 * k.shape[-2] * ag.sum(-1),
                      torch.zeros_like(ag[..., 0])).double()
    del moved, apart
    gk = g if keep is None else torch.where(keep, g, torch.zeros_like(g))
    sums = torch.stack([g.sum(-1), kernel_order_sum(gk, q.dtype)]).double()
    del gk
    tied = sb == m
    counts = (tied.sum(-1).float(), (tied if keep is None else tied & keep).sum(-1).float())
    dms = [(-(sums.amax(0) + eps)).float().to(torch.bfloat16).float(),
           (-(sums.amin(0) - eps)).float().to(torch.bfloat16).float()]
    ts = [(dm / c.clamp_min(1.0)).to(torch.bfloat16).float() for dm in dms for c in counts]
    if xla_order:
        dms.append(-_xla_bf16_sum(g))
        ts.append((dms[-1] / _xla_bf16_sum(tied.float())).to(torch.bfloat16).float())
    ts = torch.stack(ts)
    want = _max_cotangent(g, sb, m)
    d = torch.stack(dms).abs().amax(0)
    return g, want, tied, rival, keep, d, ts.amin(0), ts.amax(0)


def tie_share_range(q, k, v, bias, causal, scale, out, dout):
    """(lo, hi, held) [B, H, Lq]: the range TIE_RULE gives each row's share
    t of its max's cotangent (what the dQ kernel writes beside di), and the
    rows it holds: not those whose ties can differ (`_score_flips`' rival),
    nor those that see no key."""
    return _held_range(_tie_range(q, k, v, bias, causal, scale, out, dout))


def _held_range(parts):
    _, _, _, rival, keep, _, lo, hi = parts
    held = ~rival.any(-1)
    if keep is not None:
        held &= keep.any(-1)
    return lo, hi, held


def tie_allowed(q, k, v, bias, causal, scale, out, dout, t=None, xla_order=False):
    """What a bf16-score kernel's (dq, dk) may differ from the plain
    versions' by through the row max's cotangent, beyond the other terms of
    their rules (TIE_RULE), at the tied scores: |bf16(g + t') - bf16(g + t)|
    * scale, t the plain version's share and t' the kernel's (`t`, [B, H,
    Lq], as the dQ kernel writes it; the share itself is held by
    `tie_share_range`), or, without `t`, either end of the share's range
    (`_tie_range`; xla_order: against the JAX composite).  In a row whose
    max or ties can flip (a score near a boundary within two bf16 steps of
    m) the ties themselves may differ: there each score that may be tied at
    the max on either side may take or lose a share of dm whole.  Elsewhere
    both sides take the same ties, so a kernel that leaves dm out is not
    admitted.  float16 inputs take the rule as float32 inputs do: their
    kernels are the FFMA twins (flash_attention.cu, float16 loads), whose
    row sums `kernel_order_sum` mirrors for every dtype but bfloat16."""
    parts = _tie_range(q, k, v, bias, causal, scale, out, dout, xla_order)
    return _tie_term(parts, t, q, k, scale)


def tie_terms(q, k, v, bias, causal, scale, out, dout, t):
    """tie_share_range, tie_allowed(t=t) and tie_allowed() of one case from
    one `_tie_range`: (lo, hi, held), the (dq, dk) terms of the kernel's
    shares `t`, and those of any share in the range."""
    parts = _tie_range(q, k, v, bias, causal, scale, out, dout)
    return (_held_range(parts), _tie_term(parts, t, q, k, scale),
            _tie_term(parts, None, q, k, scale))


def _tie_term(parts, t, q, k, scale):
    g, want, tied, rival, keep, d, lo, hi = parts
    if t is not None:
        lo = hi = t.float()
    term = torch.maximum((g + lo.unsqueeze(-1)).to(torch.bfloat16).float().sub_(want).abs_(),
                         (g + hi.unsqueeze(-1)).to(torch.bfloat16).float().sub_(want).abs_())
    term = torch.where(tied, term, torch.zeros_like(term))
    d = d.unsqueeze(-1)
    term = torch.where(rival, torch.maximum(term, d + 2.0 ** -7 * (g.abs() + d)), term)
    term *= scale
    if keep is not None:
        term = torch.where(keep, term, torch.zeros_like(term))
    return (torch.matmul(term, k.float().abs()),
            torch.matmul(term.transpose(-1, -2), q.float().abs()))


def sdpa_bwd_plain(q, k, v, bias, causal, scale, out, dout, score_bf16=False):
    """(dq, dk, dv) of `sdpa_plain` for the output gradient `dout`, by the
    backward's own arithmetic (the Pallas _sdpa_tile_bwd's): P recomputed in
    float32, dS as in `_probs_and_dscores`, dQ = dS K, dK = dS^T Q,
    dV = P^T dO, all accumulated in float32."""
    p, ds = _probs_and_dscores(q, k, v, bias, causal, scale, out, dout, score_bf16)
    return (torch.matmul(ds, k.float()).to(q.dtype),) + _dkv(p, ds, q, v, dout)


def _check_shapes(name, q, k, v, bias):
    """q [B, H, Lq, dh], k and v [B, H, Lk, dh], bias [B, 1|H, Lq, Lk]."""
    B, H, Lq, dh = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, dh) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if bias is not None and (bias.dim() != 4 or bias.shape[0] != B or bias.shape[1] not in (1, H)
                             or bias.shape[2:] != (Lq, Lk)):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} is not [{B}, 1|{H}, {Lq}, {Lk}]")


def _check(name, q, k, v, bias, more=(), stats=()):
    """Operands of a kernel: all on one CUDA device; q, k, v and `more`
    (shaped as q) of one dtype, contiguous, 16-byte aligned, dh the kernel
    takes; `stats` contiguous float32 [B, H, Lq].  Returns the bias as a
    contiguous float32 tensor (or None)."""
    if not on_card(name, q, k, v, bias, *(t for _, t in more + stats)):
        raise ValueError(f"{name}: the kernel takes CUDA tensors")
    _check_shapes(name, q, k, v, bias)
    for what, t in (("q", q), ("k", k), ("v", v)) + more:
        check_operand(name, what, t, q.dtype)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    for what, t in more:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} is not q's {tuple(q.shape)}")
    for what, t in stats:
        want = ((2,) if what in ("stats", "dstats") else ()) + tuple(q.shape[:3])
        if t.dtype != torch.float32 or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous float32 {want}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} not in {_HEAD_DIMS}")
    return None if bias is None else bias.float().contiguous()


def _dims(q, k, bias):
    B, H, Lq, dh = q.shape
    return (B, H, Lq, k.shape[2], dh, 0 if bias is None else bias.shape[1])


def _stats(lse, score_bf16):
    """(what, tensor) of the forward's saved statistics for _check, and the
    pointers of lse and the row maxima (0 for none)."""
    if score_bf16:
        return ("stats", lse), lse[0].data_ptr(), lse[1].data_ptr()
    return ("lse", lse), lse.data_ptr(), 0


def _key(name, score_bf16):
    return name + ("_bf16_scores" if score_bf16 else "")


def attention_fwd(q, k, v, bias, causal, scale, score_bf16=False):
    """(out, lse): the forward kernel on the card (lse float32 [B, H, Lq],
    the log-sum-exp of each score row, saved for the backward; score_bf16:
    [2, B, H, Lq], log l and the row max m); on the CPU (sdpa_plain, None)."""
    name = "attention forward"
    if not on_card(name, q, k, v, bias):
        return sdpa_plain(q, k, v, bias, causal, scale, score_bf16), None
    bias = _check(name, q, k, v, bias)
    out = torch.empty_like(q)
    lse = torch.empty(((2,) if score_bf16 else ()) + tuple(q.shape[:3]), dtype=torch.float32,
                      device=q.device)
    _, lse_p, m_p = _stats(lse, score_bf16)
    _build.call("ptt_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                out.data_ptr(), lse_p, m_p or None, *_dims(q, k, bias), float(scale),
                int(bool(causal)), _DTYPE_CODE[q.dtype], int(bool(score_bf16)), stream_ptr(q))
    LAUNCHES[_key("attention_fwd", score_bf16)] += 1
    return out, lse


def attention_bwd_dq(q, k, v, bias, causal, scale, out, lse, dout, score_bf16=False):
    """(dq, di) on the card: the dQ kernel, which also writes di =
    rowsum(dout * out) (float32 [B, H, Lq]) for the dK/dV kernel; score_bf16:
    [2, B, H, Lq], di and t = bf16(dm / c), the share of its row max's
    cotangent each tied score takes (`_max_cotangent`)."""
    name = "attention backward dQ"
    st, lse_p, m_p = _stats(lse, score_bf16)
    bias = _check(name, q, k, v, bias, (("out", out), ("dout", dout)), (st,))
    dq = torch.empty_like(q)
    di = torch.empty(((2,) if score_bf16 else ()) + tuple(q.shape[:3]), dtype=torch.float32,
                     device=q.device)
    _build.call("ptt_attention_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                out.data_ptr(), dout.data_ptr(), lse_p, m_p or None, di.data_ptr(),
                dq.data_ptr(), *_dims(q, k, bias), float(scale), int(bool(causal)),
                _DTYPE_CODE[q.dtype], int(bool(score_bf16)), stream_ptr(q))
    LAUNCHES[_key("attention_bwd_dq", score_bf16)] += 1
    return dq, di


def attention_bwd_dkv(q, k, v, bias, causal, scale, lse, di, dout, score_bf16=False):
    """(dk, dv) on the card: the dK/dV kernel, from the forward's lse and
    the dQ kernel's di (score_bf16: with t)."""
    name = "attention backward dK/dV"
    st, lse_p, m_p = _stats(lse, score_bf16)
    bias = _check(name, q, k, v, bias, (("dout", dout),),
                  (st, ("dstats" if score_bf16 else "di", di)))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _build.call("ptt_attention_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                dout.data_ptr(), lse_p, m_p or None, di.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *_dims(q, k, bias), float(scale), int(bool(causal)),
                _DTYPE_CODE[q.dtype], int(bool(score_bf16)), stream_ptr(q))
    LAUNCHES[_key("attention_bwd_dkv", score_bf16)] += 1
    return dk, dv


def attention_bwd(q, k, v, bias, causal, scale, out, lse, dout, score_bf16=False):
    """(dq, dk, dv): on the card the dQ kernel, then the dK/dV kernel; on the
    CPU sdpa_bwd_plain."""
    if not on_card("attention backward", q, k, v, bias, out, lse, dout):
        return sdpa_bwd_plain(q, k, v, bias, causal, scale, out, dout, score_bf16)
    dq, di = attention_bwd_dq(q, k, v, bias, causal, scale, out, lse, dout, score_bf16)
    dk, dv = attention_bwd_dkv(q, k, v, bias, causal, scale, lse, di, dout, score_bf16)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, score_bf16):
        out, lse = attention_fwd(q, k, v, bias, causal, scale, score_bf16)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.scale, ctx.score_bf16 = causal, scale, score_bf16
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, bias, ctx.causal, ctx.scale, out, lse,
                                   dout.contiguous(), ctx.score_bf16)
        return dq, dk, dv, None, None, None, None


def fused_sdpa(q, k, v, bias, causal, scale, score_bf16=False):
    """Fused attention over [B, H, L, dh], any length; the backward
    recomputes P (only q, k, v, out and lse are saved).  The bias is not
    differentiable: one that requires grad raises.  score_bf16: the
    composite's score_dtype="bfloat16"."""
    _check_shapes("fused_sdpa", q, k, v, bias)
    if bias is not None and torch.is_grad_enabled() and bias.requires_grad:
        raise ValueError("fused_sdpa: the bias requires grad, but it is not differentiable "
                         "in the fused_sdpa contract (paddle_tpu/ops/pallas_attention.py"
                         ":16-19); detach it")
    return _Attention.apply(q, k, v, bias, bool(causal), float(scale), bool(score_bf16))
