"""The float16 cases of the port's kernel modules that have no float32 or
bfloat16 counterpart, on the CPU against the JAX package (fault C6: the
kernels refused float16, which the JAX kernels compute).  The plain versions
in float16 against the Pallas kernels and the attention composite are cases
of the dtype-parametrised tests of tests/test_torch_kernels.py,
test_torch_training.py, test_torch_resnet.py and test_torch_attention.py.

Here: Adam with a float16 parameter and AMP's found_inf skip; a value past
65504 becomes +-inf at the same elements with the same sign on both sides
(AMP's isfinite must see it), forwards and the cross-entropy backward at a
loss scale of 2^32; the f32-score attention at forced ties; and the float16
forms of the attention kernels' rules.

Tolerances: one float16 step of the JAX value element by element
(test_torch_kernels.one_float16_step: cuda_kernels.stored_step, 2^-10 of
it, or 2^-24 below float16's normal range); Adam's float32 moments 2e-6;
attention forward 1e-3 and gradients 2^-8 of max(1, max|ref|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention as jatt
from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu_torch.core.dtypes import to_tensor
from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.ops import cuda_kernels as ck
from test_torch_attention import _composite, _tied_keys
from test_torch_kernels import one_float16_step

F16 = jnp.float16
SPECS = jpk.FUSED_KERNELS


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU call must not count a kernel launch"


def _t(a):
    return None if a is None else to_tensor(np.asarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(want, got, rel):
    w, g = _np(want), _np(got)
    err = float(np.abs(w - g).max())
    assert err <= rel * max(1.0, float(np.abs(w).max())), err


def test_adam_float16_and_its_skip():
    """A float16 parameter with float32 moments (the example's): the step
    in float32, p rounded once; with found_inf set the plain version returns
    its inputs' values bit for bit, with it clear the step."""
    args = SPECS["adam_slab"]["example"](F16)
    want = SPECS["adam_slab"]["fused"](args, interpret=True)
    p, g, m, v = (_t(a) for a in args)
    lr = torch.tensor([1e-3])
    got = ck.fused_adam(p, g, m, v, lr, 0.9, 0.999, 1e-8)
    one_float16_step(want[0], got[0])
    for w, t in zip(want[1:], got[1:]):
        assert t.dtype == torch.float32
        _close(w, t, 2e-6)
    skipped = ck.fused_adam(p, g, m, v, lr, 0.9, 0.999, 1e-8, torch.tensor([True]))
    for a, b in zip(skipped, (p, m, v)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    applied = ck.fused_adam(p, g, m, v, lr, 0.9, 0.999, 1e-8, torch.tensor([False]))
    for a, b in zip(applied, got):
        assert torch.equal(a, b)


# finite float16 inputs whose outputs pass float16's 65504 (the float32
# scale, bias or multipliers lift them): the JAX kernel's astype and the
# port's .to(float16) both give +-inf there
OVERFLOW = {
    "ln_residual": lambda: (lambda a: (a[0], a[1], a[2] * 3e4, a[3]))(
        SPECS["ln_residual"]["example"](F16, residual=True)),
    "bias_act": lambda: (lambda a: (a[0] * jnp.asarray(1e3, F16), a[1] + 6.5e4))(
        SPECS["bias_act"]["example"](F16)),
    "bn_epilogue": lambda: (lambda a: (a[0], a[1] * 4e4, a[2]))(jpk._epilogue_example(F16, hw=49)),
}


@pytest.mark.parametrize("kernel", list(OVERFLOW))
def test_forward_overflow_is_inf_at_the_same_elements(kernel):
    args = OVERFLOW[kernel]()
    if kernel == "ln_residual":
        want = jpk.fused_ln_residual(*args, 1e-5, True)
        got = ck.fused_ln_residual(*(_t(a) for a in args), 1e-5)
    elif kernel == "bias_act":
        want = jpk.fused_bias_act(*args, "gelu", True)
        got = ck.fused_bias_act(*(_t(a) for a in args), "gelu")
    else:
        want = jpk.bn_epilogue(*args, False, True)
        got = ck.bn_epilogue(*(_t(a) for a in args), False)
    assert np.isinf(_np(want)).any() and np.isinf(_np(got)).any()
    one_float16_step(want, got)


def test_xent_backward_overflows_as_amp_needs():
    """A loss scale of 2^32 over 8 rows makes the float16 logits' gradient
    +-inf (the float32 upstream is finite): the overflow AMP's isfinite
    must see, on both sides at the same elements."""
    logits, labels = SPECS["softmax_xent"]["example"](F16)
    g = jnp.full((logits.shape[0], 1), 2.0 ** 32 / 8, jnp.float32)
    _, vjp = jax.vjp(lambda x: jpk.fused_softmax_xent(x, labels, -100, True), logits)
    (jdx,) = vjp(g)
    _, lse = ck.softmax_xent_fwd_plain(_t(logits), _t(labels), -100)
    dx = ck.softmax_xent_bwd_plain(_t(logits), _t(labels), lse, _t(g)[:, 0], -100)
    assert np.isinf(_np(jdx)).any()
    one_float16_step(jdx, dx)


# attention at forced ties (keys 3, 5 and 7 one key that most queries score
# highest): (B, H, Lq, Lk, dh, causal, keys)
ATTENTION_CASES = [(2, 4, 96, 130, 32, False, "ties")]


def _attention_inputs(B, H, Lq, Lk, dh, keys):
    rng = np.random.RandomState(8)
    q, k, v = (jnp.asarray(rng.randn(B, H, L, dh), F16) for L in (Lq, Lk, Lk))
    g = jnp.asarray(rng.randn(B, H, Lq, dh), F16)
    if keys == "ties":
        k = _tied_keys(q, k)
    return q, k, v, g


def _port_attention(q, k, v, g, causal, scale, score_bf16):
    tq, tk, tv = (_t(a).clone().requires_grad_(True) for a in (q, k, v))
    out = ca.fused_sdpa(tq, tk, tv, None, causal, scale, score_bf16)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    assert out.dtype == torch.float16 and all(t.dtype == torch.float16 for t in grads)
    return out, grads


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_float16_f32_scores(case):
    """sdpa_plain and sdpa_bwd_plain in float16 at forced ties against the
    composite and its jax.vjp, and against fused_sdpa (Pallas, interpret
    mode); with bf16 scores the tied case is one of
    test_torch_attention.BF16_SCORE_CASES."""
    B, H, Lq, Lk, dh, causal, keys = case
    q, k, v, g = _attention_inputs(B, H, Lq, Lk, dh, keys)
    scale = 1.0 / np.sqrt(dh)
    out, grads = _port_attention(q, k, v, g, causal, scale, False)
    for fn in (lambda q, k, v: _composite(q, k, v, None, causal, scale),
               lambda q, k, v: jatt.fused_sdpa(q, k, v, None, causal, scale, True)):
        want, vjp = jax.vjp(fn, q, k, v)
        _close(want, out, 1e-3)
        for w, got in zip(vjp(g), grads):
            _close(w, got, 2.0 ** -8)


def test_float16_rules_hold_a_step_and_see_a_wrong_rounding():
    """FWD_F16_RULE and BWD_F16_RULE, which the float16 kernels are held to
    on the card: the output from float64 values, P rounded to float16,
    stays within the forward's; one that loses the last key (a kernel that
    skips a ragged tail) fails it by more than 2x; the backward's is
    positive everywhere."""
    rng = np.random.RandomState(11)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 128, 32)).to(torch.float16) for _ in range(4))
    scale = 32 ** -0.5
    want = ca.sdpa_plain(q, k, v, None, False, scale)
    allowed = ca.sdpa_fwd_bf16_allowed(q, k, v, None, False, scale, want)
    p = torch.softmax(torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale, -1)
    exact = torch.matmul(p.to(torch.float16).double(), v.double()).to(torch.float16)
    assert float(((exact.float() - want.float()).abs() / allowed).max()) <= 1.0
    wrong = torch.matmul(p[..., :-1].to(torch.float16).double(),
                         v[..., :-1, :].double()).to(torch.float16)
    assert float(((wrong.float() - want.float()).abs() / allowed).max()) > 2.0
    grads = ca.sdpa_bwd_plain(q, k, v, None, False, scale, want, do)
    allowed = ca.sdpa_bwd_bf16_allowed(q, k, v, None, False, scale, want, do, grads)
    assert all(a.shape == w.shape and bool((a > 0).all()) for a, w in zip(allowed, grads))
    assert ca.fwd_rule(torch.float16) == ca.FWD_F16_RULE
    assert ca.bwd_rule(torch.bfloat16) == ca.BWD_BF16_RULE
