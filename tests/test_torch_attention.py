"""The port's attention, forward and backward, against the JAX package on
the CPU.

The plain versions (`sdpa_plain`, `sdpa_bwd_plain`, reached through
`fused_sdpa`'s autograd Function on CPU tensors) are held against
`fused_sdpa` of paddle_tpu/ops/pallas_attention.py in interpret mode and its
jax.vjp, and against the stock TPU flash kernel (the JAX package's route for
kv >= 2048 on a TPU) run in TPU interpret mode, where the two contracts
agree (no bias, Lq == Lk).  Inputs come from numpy seeds.  Tolerances:
forward float32 1e-4, bfloat16 5e-2, float16 1e-3; gradients 1e-4 * (1 +
max|ref|) in float32 (as tests/test_pallas_kernels.py holds the Pallas
backward), 5e-2 * max|ref| in bfloat16, 6.25e-3 * max|ref| in float16
(bfloat16's scaled by the 2^-3 of float16's three more bits).  The kernels
run only on the card (tests/test_torch_gpu.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention

from paddle_tpu.ops import pallas_attention as jatt
from paddle_tpu_torch.core.dtypes import to_tensor
from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.ops import cuda_kernels as ck
from test_torch_kernels import SDPA_CASES

DTYPES = ["float32", "bfloat16", "float16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
FWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2, "float16": 1e-3}
GRAD_RTOL = {"bfloat16": 5e-2, "float16": 6.25e-3}


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU call must not count a kernel launch"


def _grad_tol(dtype, ref):
    peak = float(np.abs(np.asarray(ref, np.float32)).max())
    return 1e-4 * (1.0 + peak) if dtype == "float32" else GRAD_RTOL[dtype] * peak


def _err(want, got):
    return float(np.abs(np.asarray(want, np.float32) - got.detach().float().numpy()).max())


def _inputs(rng, B, H, Lq, Lk, dh, dtype, bias_kind=None):
    q, k, v = (jnp.asarray(rng.randn(B, H, L, dh), JDT[dtype]) for L in (Lq, Lk, Lk))
    g = jnp.asarray(rng.randn(B, H, Lq, dh), JDT[dtype])
    bias = None
    if bias_kind is not None:
        bias = jnp.asarray(rng.randn(B, 1 if bias_kind == "bcast" else H, Lq, Lk) * 2, jnp.float32)
    return q, k, v, g, bias


def _port(q, k, v, g, bias, causal, scale):
    """out and (dq, dk, dv) of the port's fused_sdpa on the CPU, through its
    autograd Function (plain forward, explicit plain backward)."""
    tq, tk, tv = (to_tensor(np.asarray(a)).clone().requires_grad_(True) for a in (q, k, v))
    tb = None if bias is None else to_tensor(np.asarray(bias))
    out = ca.fused_sdpa(tq, tk, tv, tb, causal, scale)
    return out, torch.autograd.grad(out, (tq, tk, tv), to_tensor(np.asarray(g)))


def _hold(dtype, want_out, want_grads, out, grads):
    assert _err(want_out, out) <= FWD_TOL[dtype]
    for name, w, got in zip(("dq", "dk", "dv"), want_grads, grads):
        assert got.dtype == out.dtype
        assert _err(w, got) <= _grad_tol(dtype, w), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SDPA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_forward_and_backward_match_fused_sdpa(dtype, case):
    B, H, Lq, Lk, dh, bias_kind, causal = case
    q, k, v, g, bias = _inputs(np.random.RandomState(0), B, H, Lq, Lk, dh, dtype, bias_kind)
    scale = 1.0 / np.sqrt(dh)
    want, vjp = jax.vjp(lambda q, k, v: jatt.fused_sdpa(q, k, v, bias, causal, scale, True),
                        q, k, v)
    out, grads = _port(q, k, v, g, bias, causal, scale)
    assert out.shape == (B, H, Lq, dh)
    _hold(dtype, want, vjp(g), out, grads)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_forward_and_backward_match_stock_flash_kernel(causal, dtype):
    """The stock kernel (jax/experimental/pallas/ops/tpu/flash_attention.py)
    in TPU interpret mode at [1, 2, 256, 32]: no bias and Lq == Lk, where its
    bias-before-scale and offset-free causal rules agree with the composite."""
    q, k, v, g, _ = _inputs(np.random.RandomState(1), 1, 2, 256, 256, 32, dtype)
    scale = 32 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                                            sm_scale=scale), q, k, v)
        want_grads = vjp(g)
    out, grads = _port(q, k, v, g, None, causal, scale)
    _hold(dtype, want, want_grads, out, grads)


def _composite(q, k, v, bias, causal, scale):
    """The JAX package's composite attention (paddle_tpu/ops/nn_ops.py:672-689)."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32) * scale
    if bias is not None:
        s = s + bias
    if causal:
        Lq, Lk = s.shape[-2], s.shape[-1]
        s = jnp.where(jnp.tril(jnp.ones((Lq, Lk), bool), k=Lk - Lq), s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    out = jnp.einsum("bhqk,bhkd->bhqd", p.astype(q.dtype), v, preferred_element_type=jnp.float32)
    return out.astype(q.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("late", ["bias_grows_along_keys", "keys_scaled_by_position"])
def test_late_moving_row_max(late, dtype):
    """Rows whose max sits in the last keys (the case an online softmax that
    forgets to rescale gets wrong), over 200 keys: more than three of the
    kernel's 64-key tiles."""
    rng = np.random.RandomState(2)
    q, k, v, g, _ = _inputs(rng, 1, 2, 40, 200, 16, dtype)
    bias = None
    if late == "bias_grows_along_keys":
        bias = jnp.asarray(np.broadcast_to(np.linspace(0.0, 12.0, 200), (1, 1, 40, 200)),
                           jnp.float32)
    else:
        k = (k.astype(jnp.float32) * jnp.linspace(0.1, 4.0, 200)[None, None, :, None]).astype(k.dtype)
    scale = 0.25
    want, vjp = jax.vjp(lambda q, k, v: jatt.fused_sdpa(q, k, v, bias, False, scale, True), q, k, v)
    out, grads = _port(q, k, v, g, bias, False, scale)
    # the max does move late: past the kernel's first two tiles in most rows
    s = np.einsum("bhqd,bhkd->bhqk", np.asarray(q, np.float32), np.asarray(k, np.float32)) * scale
    if bias is not None:
        s = s + np.asarray(bias)
    assert (s.argmax(-1) >= 128).mean() >= 0.9
    _hold(dtype, want, vjp(g), out, grads)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_with_no_visible_key(dtype):
    """Causal with Lq > Lk: the first Lq - Lk query rows see no key.  The
    composite masks with the finite -1e30, so such a row is the uniform
    average of V, and its scores are constants: no gradient reaches q or k
    from it.  Held against jax.vjp of the composite (fused_sdpa's VJP
    differentiates the masked scores of such rows; ROADMAP C)."""
    q, k, v, g, _ = _inputs(np.random.RandomState(3), 1, 2, 24, 8, 8, dtype)
    scale = 8 ** -0.5
    want, vjp = jax.vjp(lambda q, k, v: _composite(q, k, v, None, True, scale), q, k, v)
    out, grads = _port(q, k, v, g, None, True, scale)
    uniform = np.asarray(v, np.float32).mean(2)
    assert np.abs(out[:, :, :16].detach().float().numpy() - uniform[:, :, None]).max() <= FWD_TOL[dtype]
    assert not grads[0][:, :, :16].any()
    _hold(dtype, want, vjp(g), out, grads)
    fwd = jatt.fused_sdpa(q, k, v, None, True, scale, True)
    assert _err(fwd, out) <= FWD_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_plain_backwards_split_the_plain_backward(dtype):
    """The plain versions of the dQ and the dK/dV kernel give, bit for bit,
    the parts of sdpa_bwd_plain."""
    rng = np.random.RandomState(5)
    q, k, v, g, bias = (None if a is None else to_tensor(np.asarray(a))
                        for a in _inputs(rng, 2, 2, 24, 40, 16, dtype, "per_head"))
    out = ca.sdpa_plain(q, k, v, bias, True, 0.25)
    dq, dk, dv = ca.sdpa_bwd_plain(q, k, v, bias, True, 0.25, out, g)
    assert torch.equal(ca.sdpa_bwd_dq_plain(q, k, v, bias, True, 0.25, out, g), dq)
    got = ca.sdpa_bwd_dkv_plain(q, k, v, bias, True, 0.25, out, g)
    assert torch.equal(got[0], dk) and torch.equal(got[1], dv)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_backward_rule_admits_other_roundings_and_sees_a_skipped_tile(causal):
    """sdpa_bwd_bf16_allowed, the rule the bfloat16 backward kernels are held
    to on the card: the backward taken in float64, which rounds P and dS to
    bfloat16 from other last bits as a kernel does, stays within it; the
    same with the last 64 keys left out of dq, or the last 64 queries out of
    dk and dv (a kernel that skips its last tile), does not."""
    rng = np.random.RandomState(6)
    L, dh, scale = 512, 32, 32 ** -0.5
    q, k, v, g = (torch.from_numpy(rng.randn(1, 2, L, dh)).to(torch.bfloat16) for _ in range(4))
    out = ca.sdpa_plain(q, k, v, None, causal, scale)
    want = ca.sdpa_bwd_plain(q, k, v, None, causal, scale, out, g)
    allowed = ca.sdpa_bwd_bf16_allowed(q, k, v, None, causal, scale, out, g, want)
    q64, k64, v64, g64 = (t.double() for t in (q, k, v, g))
    s = torch.matmul(q64, k64.transpose(-1, -2)) * scale
    keep = torch.ones(L, L, dtype=torch.bool).tril() if causal else torch.ones(L, L, dtype=torch.bool)
    p = torch.softmax(torch.where(keep, s, torch.full_like(s, -1e30)), dim=-1)
    dp = torch.matmul(g64, v64.transpose(-1, -2))
    di = (g64 * out.double()).sum(-1, keepdim=True)
    ds = torch.where(keep, p * (dp - di) * scale, torch.zeros_like(p))
    ds, pb = ds.to(torch.bfloat16).double(), p.to(torch.bfloat16).double()

    def grads(n):  # keys [0, n) in dq, queries [0, n) in dk and dv
        return (torch.matmul(ds[..., :n], k64[..., :n, :]),
                torch.matmul(ds[..., :n, :].transpose(-1, -2), q64[..., :n, :]),
                torch.matmul(pb[..., :n, :].transpose(-1, -2), g64[..., :n, :]))

    def share(got):
        return [float(((a.to(torch.bfloat16).float() - w.float()).abs() / t).max())
                for a, w, t in zip(got, want, allowed)]

    assert max(share(grads(L))) <= 1.0
    assert min(share(grads(L - 64))) > 2.0


def _online_forward(q, k, v, causal, scale, keys=None, rescale=True):
    """The bfloat16 forward kernel's arithmetic in float64: tiles of 64 keys,
    the running max m, alpha = exp(m_old - m_new) rescaling O and the sum l,
    P = exp(s - m_new) rounded to bfloat16 before P V (l sums the unrounded
    P), and O / l rounded once.  `keys` keeps keys [0, keys) only; with
    `rescale` False alpha is left out."""
    q64, k64, v64 = (t.double() for t in (q, k, v))
    s = torch.matmul(q64, k64.transpose(-1, -2)) * scale
    if causal:
        lq, lk = s.shape[-2:]
        keep = torch.ones(lq, lk, dtype=torch.bool).tril(lk - lq)
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    n = s.shape[-1] if keys is None else keys
    m = torch.full(s.shape[:-1] + (1,), -float("inf"), dtype=torch.float64)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float64)
    for t0 in range(0, n, 64):
        st = s[..., t0:min(t0 + 64, n)]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new) if rescale else torch.ones_like(m)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(torch.bfloat16).double(), v64[..., t0:t0 + st.shape[-1], :])
        m = m_new
    return (o / l).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_forward_rule_admits_other_roundings_and_sees_a_wrong_kernel(causal):
    """sdpa_fwd_bf16_allowed, the rule the bfloat16 forward kernel is held to
    on the card: the kernel's own arithmetic taken in float64 (unnormalized
    P rounded to bfloat16 a tile at a time, the output rounded once) stays
    within it; the same with the last 64 keys left out (a kernel that skips
    its last tile) fails it by more than 2x, and so does, on keys scaled by
    position (the row max moves late), the same without the alpha rescale."""
    rng = np.random.RandomState(7)
    L, dh, scale = 512, 32, 32 ** -0.5
    q, k, v = (torch.from_numpy(rng.randn(1, 2, L, dh)).to(torch.bfloat16) for _ in range(3))
    late = (k.float() * torch.linspace(0.1, 4.0, L)[:, None]).to(torch.bfloat16)

    def share(keys_in, got):
        want = ca.sdpa_plain(q, keys_in, v, None, causal, scale)
        allowed = ca.sdpa_fwd_bf16_allowed(q, keys_in, v, None, causal, scale, want)
        return float(((got.float() - want.float()).abs() / allowed).max())

    assert share(k, _online_forward(q, k, v, causal, scale)) <= 1.0
    assert share(late, _online_forward(q, late, v, causal, scale)) <= 1.0
    assert share(k, _online_forward(q, k, v, causal, scale, keys=L - 64)) > 2.0
    assert share(late, _online_forward(q, late, v, causal, scale, rescale=False)) > 2.0


def test_backward_kernel_wrappers_refuse_operands_off_one_device():
    """The dQ and dK/dV wrappers take their saved statistics and bias on q's
    device only (a CUDA q with a host lse would hand the kernel a host
    pointer); any other device raises before a launch."""
    q = torch.zeros(1, 1, 8, 16)
    lse = torch.zeros(1, 1, 8)
    meta = torch.zeros(1, 1, 8, device="meta")
    bias = torch.zeros(1, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        ca.attention_bwd_dq(q, q, q, None, False, 1.0, q, meta, q)
    with pytest.raises(ValueError, match="several devices"):
        ca.attention_bwd_dkv(q, q, q, None, False, 1.0, lse, meta, q)
    with pytest.raises(ValueError, match="several devices"):
        ca.attention_bwd_dkv(q, q, q, bias, False, 1.0, lse, lse, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ca.attention_bwd_dq(q, q, q, None, False, 1.0, q, lse, q)


def _composite_bf16_scores(q, k, v, bias, causal, scale, stop_max=False):
    """The JAX package's composite with score_dtype="bfloat16"
    (paddle_tpu/ops/nn_ops.py:672-689): s rounded to bf16, m the max of the
    rounded scores, exp of f32(bf16(s - m)), the sum in float32.  stop_max
    stops the gradient through m, as the port's backward did before it took
    the row max's cotangent."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32) * scale
    if bias is not None:
        s = s + bias
    if causal:
        Lq, Lk = s.shape[-2], s.shape[-1]
        s = jnp.where(jnp.tril(jnp.ones((Lq, Lk), bool), k=Lk - Lq), s, -1e30)
    s = s.astype(jnp.bfloat16)
    m = jnp.max(s, axis=-1, keepdims=True)
    if stop_max:
        m = jax.lax.stop_gradient(m)
    e = jnp.exp((s - m).astype(jnp.float32))
    p = e / jnp.sum(e, axis=-1, keepdims=True)
    out = jnp.einsum("bhqk,bhkd->bhqd", p.astype(q.dtype), v, preferred_element_type=jnp.float32)
    return out.astype(q.dtype)


# the bf16-score forward's path (csrc/attention_fwd_bs.cu plan_of) at key
# length Lk and head dim dh: (cluster, per_cta, buffered, recomputed)
BS_PLANS = [
    (1, 64, (1, 1, 1, 0)),
    (128, 64, (1, 2, 2, 0)),       # BERT at seq 128: one CTA keeps every score
    (512, 64, (1, 8, 8, 0)),       # one CTA's buffer, full
    (513, 64, (2, 5, 5, 0)),       # one key past it: a cluster of 2
    (2048, 64, (4, 8, 8, 0)),      # BERT at seq 2048
    (4096, 64, (8, 8, 8, 0)),      # what the largest cluster holds
    (4196, 64, (8, 9, 8, 1)),      # past it: each CTA recomputes a tile
    (2048, 128, (8, 4, 4, 0)),     # dh 128 keeps 4 tiles a CTA
    (2049, 128, (8, 5, 4, 1)),
    (200, 16, (1, 4, 4, 0)),
    (600, 32, (2, 5, 5, 0)),
]


@pytest.mark.parametrize("lk,dh,want", BS_PLANS, ids=lambda c: str(c))
def test_bf16_score_fwd_plan(lk, dh, want):
    """The Python mirror of the kernel's plan (chip_smoke.py holds it to the
    kernel's own, ptt_attention_fwd_bs_plan)."""
    got = ca.bf16_score_fwd_plan(lk, dh)
    assert (got["cluster"], got["per_cta"], got["buffered"], got["recomputed"]) == want


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_bf16_score_fwd_plan_covers_every_key_with_the_least_cluster(dh):
    """At every key length: the cluster is a power of 2 up to 8, its CTAs
    take every key tile, each keeps what its buffer holds and recomputes
    the rest, and no smaller cluster would have held the row."""
    buf = {16: 8, 32: 8, 64: 8, 128: 4}[dh]
    for lk in range(1, 9000, 7):
        p = ca.bf16_score_fwd_plan(lk, dh)
        tiles, c = -(-lk // 64), p["cluster"]
        assert c in (1, 2, 4, 8) and c * p["per_cta"] >= tiles > c * (p["per_cta"] - 1)
        assert p["buffered"] == min(p["per_cta"], buf)
        assert p["recomputed"] == p["per_cta"] - p["buffered"]
        assert c == 1 or (c // 2) * buf < tiles
        assert p["recomputed"] == 0 or c == 8
    with pytest.raises(ValueError):
        ca.bf16_score_fwd_plan(128, 48)


BF16_SCORE_CASES = [  # (B, H, Lq, Lk, dh, bias, causal)
    (2, 2, 32, 32, 16, None, False),
    (2, 2, 24, 40, 16, "per_head", True),   # causal with Lq < Lk, a bias
    (1, 2, 40, 24, 16, "bcast", True),      # causal with Lq > Lk: rows with no visible key
    (1, 2, 65, 65, 16, None, False),        # a row past two windows of XLA's bf16 sum
    (1, 2, 48, 40, 16, "ties", False),      # keys 3, 5 and 7 the same: ties at the row max
]


def _tied_keys(q, k):
    """k with keys 3, 5 and 7 made one key that most queries score highest
    (2.5 times the queries' mean direction, rounded to q's dtype), so that
    their rounded scores tie at the row max."""
    k = np.array(k, np.float32)
    u = np.asarray(q, np.float32).mean(axis=2, keepdims=True)
    u = 2.5 * u * np.sqrt(k.shape[-1]) / np.linalg.norm(u, axis=-1, keepdims=True)
    k[:, :, [3, 5, 7], :] = u
    return jnp.asarray(k, q.dtype)


class _OpStub:
    """An op of the JAX package as its lowerings read it: attributes only."""

    def __init__(self, **attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _jax_fused_attention(q, k, v, bias, causal, scale):
    """The JAX package's own fused_attention lowering on the CPU
    (paddle_tpu/ops/nn_ops.py:610-689) with score_dtype="bfloat16"."""
    from types import SimpleNamespace

    from paddle_tpu.core.registry import get_op_def

    ins = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        ins["Bias"] = [bias]
    op = _OpStub(causal=causal, scale=scale, score_dtype="bfloat16")
    return get_op_def("fused_attention").lower(SimpleNamespace(platform="cpu"), op, ins)["Out"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", BF16_SCORE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_scores_plain_matches_composite(dtype, case):
    """fused_sdpa(score_bf16=True) on the CPU (sdpa_plain and sdpa_bwd_plain
    with bf16 scores) against the JAX composite with score_dtype="bfloat16",
    forward and the full jax.vjp (the gradient through the row max m
    included), float32 and bfloat16 inputs; the tied case runs the JAX
    package's own fused_attention lowering.  Tolerances: the forward's and
    gradients' of the f32-score tests, plus, element by element,
    cuda_attention.score_rounding_allowed (the two sides may round a float32
    score that differs in its last bits to neighbouring bf16 values) and,
    for dq and dk, cuda_attention.tie_allowed with xla_order (such a
    rounding of a bf16(P (dP - di)) moves the row max's cotangent, and the
    composite sums it in XLA's bf16 steps, the port in float32).  The composite with m
    stopped (the port's backward before the repair) lies outside those
    tolerances with float32 inputs from 65 keys on and at the forced ties
    (bfloat16's 5e-2 of the largest gradient cannot see it)."""
    B, H, Lq, Lk, dh, bias_kind, causal = case
    rng = np.random.RandomState(8)
    q, k, v, g, bias = _inputs(rng, B, H, Lq, Lk, dh, dtype,
                               None if bias_kind == "ties" else bias_kind)
    composite = _composite_bf16_scores
    if bias_kind == "ties":
        k = _tied_keys(q, k)
        composite = (lambda q, k, v, bias, causal, scale, stop_max=False:
                     composite_stop(q, k, v, bias, causal, scale) if stop_max
                     else _jax_fused_attention(q, k, v, bias, causal, scale))
        composite_stop = lambda *a: _composite_bf16_scores(*a, stop_max=True)  # noqa: E731
    scale = 1.0 / np.sqrt(dh)
    want, vjp = jax.vjp(lambda q, k, v: composite(q, k, v, bias, causal, scale), q, k, v)
    want_grads = vjp(g)
    stopped = jax.vjp(lambda q, k, v: composite(q, k, v, bias, causal, scale, True),
                      q, k, v)[1](g)
    tq, tk, tv = (to_tensor(np.asarray(a)).clone().requires_grad_(True) for a in (q, k, v))
    tb = None if bias is None else to_tensor(np.asarray(bias))
    out = ca.fused_sdpa(tq, tk, tv, tb, causal, scale, True)
    grads = torch.autograd.grad(out, (tq, tk, tv), to_tensor(np.asarray(g)))
    assert out.dtype == tq.dtype and out.shape == (B, H, Lq, dh)
    qd, kd, vd, gd = (t.detach() for t in (tq, tk, tv, to_tensor(np.asarray(g))))
    allowed = FWD_TOL[dtype] + ca.score_rounding_allowed(qd, kd, vd, tb, causal, scale).numpy()
    assert (np.abs(np.asarray(want, np.float32) - out.detach().float().numpy()) <= allowed).all()
    extra = list(ca.score_rounding_allowed(qd, kd, vd, tb, causal, scale, out.detach(), gd))
    for i, t in enumerate(ca.tie_allowed(qd, kd, vd, tb, causal, scale, out.detach(), gd,
                                         xla_order=True)):
        extra[i] = extra[i] + t
    seen = []
    for name, w, got, e, stop in zip(("dq", "dk", "dv"), want_grads, grads, extra, stopped):
        assert got.dtype == out.dtype
        tol = _grad_tol(dtype, w) + e.numpy()
        w32 = np.asarray(w, np.float32)
        assert (np.abs(w32 - got.float().numpy()) <= tol).all(), name
        seen.append(bool((np.abs(w32 - np.asarray(stop, np.float32)) > tol).any()))
    if dtype == "float32" and (Lk >= 65 or bias_kind == "ties"):
        assert seen[0] or seen[1], "the tolerance cannot see the row max's cotangent"
    assert not seen[2]  # dV = P^T dO holds no dS


@pytest.mark.parametrize("dtype", DTYPES)
def test_bf16_scores_differ_from_f32_scores(dtype):
    """The bf16-score plain version is not the f32-score one: at scores of
    magnitude ~4 the rounding of s and of s - m moves the output by far
    more than the f32-score tolerance, while a second call agrees bit for
    bit; the fused_attention lowering routes score_dtype="bfloat16" there."""
    q, k, v, _, _ = _inputs(np.random.RandomState(9), 1, 2, 32, 32, 16, dtype)
    tq, tk, tv = (to_tensor(np.asarray(a)) for a in (q, k, v))
    a = ca.sdpa_plain(tq, tk, tv, None, False, 1.0, True)
    assert torch.equal(a, ca.sdpa_plain(tq, tk, tv, None, False, 1.0, True))
    b = ca.sdpa_plain(tq, tk, tv, None, False, 1.0)
    assert float((a.float() - b.float()).abs().max()) > 10 * FWD_TOL["float32"]
    want = _composite_bf16_scores(q, k, v, None, False, 1.0)
    assert _err(want, a) <= FWD_TOL[dtype] + 1e-6
    if dtype == "float32":  # the rule admits a flip only near a rounding boundary
        allowed = FWD_TOL[dtype] + ca.score_rounding_allowed(tq, tk, tv, None, False, 1.0)
        assert ((a - b).abs() > allowed).any()


def _bf16_score_bwd_f64(q, k, v, bias, causal, scale, out, dout):
    """(dq, dk, dv) of the bf16-score backward in float64 (another order of
    the same arithmetic): the scores, s - m, P (dP - di), the row max's
    cotangent and its share rounded to bf16 from float64 values, the
    cotangent summed exactly and rounded once (as the kernels sum it in
    float32), everything else exact until the float32 result."""
    d = torch.float64
    s = torch.matmul(q.to(d), k.to(d).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(d)
    keep = None
    if causal:
        lq, lk = s.shape[-2:]
        keep = torch.ones(lq, lk, dtype=torch.bool).tril(lk - lq)
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    sb = s.to(torch.bfloat16).to(d)
    e = torch.exp((sb - sb.amax(-1, keepdim=True)).to(torch.bfloat16).to(d))
    p = e / e.sum(-1, keepdim=True)
    do = dout.to(d)
    x = p * (do @ v.to(d).transpose(-1, -2) - (do * out.to(d)).sum(-1, keepdim=True))
    g = x.to(torch.bfloat16).to(d)
    # the row max's cotangent: the sum of g rounded to bf16 once, its share
    # at the unmasked ties
    tied = sb == sb.amax(-1, keepdim=True)
    if keep is not None:
        tied &= keep
    dm = (-g.sum(-1, keepdim=True)).to(torch.bfloat16).to(d)
    t = (dm / tied.sum(-1, keepdim=True).clamp_min(1)).to(torch.bfloat16).to(d)
    ds = torch.where(tied, (g + t).to(torch.bfloat16).to(d), g) * scale
    if keep is not None:
        ds = torch.where(keep, ds, torch.zeros_like(ds))
    return tuple(t.float() for t in (ds @ k.to(d), ds.transpose(-1, -2) @ q.to(d),
                                     p.transpose(-1, -2) @ do))


@pytest.mark.parametrize("case", BF16_SCORE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_score_backward_rule_sees_rounding(case):
    """The rule chip_smoke.py holds the float32 bf16-score backward kernels
    by (grad_tol + score_rounding_allowed, + tie_allowed for dq and dk) sees
    each rounding: the f32-score backward exceeds it in dq, dk and dv, and
    the bf16-score backward without the rounding of dS
    (chip_smoke.unrounded_ds_grads) exceeds it in dq and dk, and from 65
    keys on and at forced ties so does the one without the row max's
    cotangent (chip_smoke.no_max_cotangent_grads), while the same backward
    computed in float64 (another order of the same roundings) stays within
    it."""
    import chip_smoke

    B, H, Lq, Lk, dh, bias_kind, causal = case
    q, k, v, g, bias = _inputs(np.random.RandomState(10), B, H, Lq, Lk, dh, "float32",
                               None if bias_kind == "ties" else bias_kind)
    if bias_kind == "ties":
        k = _tied_keys(q, k)
    tq, tk, tv, tg = (to_tensor(np.asarray(a)) for a in (q, k, v, g))
    args = (tq, tk, tv, None if bias is None else to_tensor(np.asarray(bias)), causal,
            1.0 / np.sqrt(dh))
    out = ca.sdpa_plain(*args, score_bf16=True)
    want = ca.sdpa_bwd_plain(*args, out, tg, score_bf16=True)
    allowed = [_grad_tol("float32", w.numpy()) + e
               for w, e in zip(want, ca.score_rounding_allowed(*args, out, tg))]
    for i, t in enumerate(ca.tie_allowed(*args, out, tg)):
        allowed[i] = allowed[i] + t

    def worst(got):
        return [float(((a - w).abs() / t).max()) for a, w, t in zip(got, want, allowed)]

    assert max(worst(_bf16_score_bwd_f64(*args, out, tg))) <= 1.0
    assert min(worst(ca.sdpa_bwd_plain(*args, ca.sdpa_plain(*args), tg))) > 1.0
    assert min(worst(chip_smoke.unrounded_ds_grads(torch, ca, args, out, tg))[:2]) > 1.0
    if Lk >= 65 or bias_kind == "ties":
        assert max(worst(chip_smoke.no_max_cotangent_grads(torch, ca, args, out, tg))) > 1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lk", [1, 64, 65, 200])
def test_kernel_order_sum_is_the_dq_kernels_loop(dtype, lk):
    """cuda_attention.kernel_order_sum, which TIE_RULE takes as the dQ
    kernel's float32 sum of a row's g, against the kernels' loops written
    out scalar by scalar (attention_bwd_bs.cu for bfloat16 inputs: a quad's
    lanes, a pair at a time, a tile's sum into the lane's; flash_attention.cu
    for float32: 32 lanes, two columns a tile, the warp's butterfly), bit
    for bit."""
    rng = np.random.RandomState(lk)
    g = (rng.randn(3, lk) * np.exp2(rng.randint(-12, 2, (3, lk)))).astype(np.float32)
    g = g.astype(ml_dtypes.bfloat16).astype(np.float32)
    f = np.float32
    want = []
    for row in g:
        padded = np.concatenate([row, np.zeros(-lk % 64, np.float32)])
        tiles = padded.reshape(-1, 64)
        if dtype == "bfloat16":
            acc = [f(0)] * 4
            for tile in tiles:
                for lane in range(4):
                    part = f(0)
                    for j in range(8):
                        key = 8 * j + 2 * lane
                        part = f(part + f(tile[key] + tile[key + 1]))
                    acc[lane] = f(acc[lane] + part)
            want.append(f(f(acc[0] + acc[1]) + f(acc[2] + acc[3])))
        else:
            acc = [f(0)] * 32
            for tile in tiles:
                for lane in range(32):
                    for h in range(2):
                        acc[lane] = f(acc[lane] + tile[lane + 32 * h])
            for o in (16, 8, 4, 2, 1):
                acc = [f(acc[lane] + acc[lane ^ o]) for lane in range(32)]
            want.append(acc[0])
    got = ca.kernel_order_sum(torch.from_numpy(g), getattr(torch, dtype)).numpy()
    np.testing.assert_array_equal(got, np.array(want, np.float32))
