"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the wrappers take their plain versions, which must match the
Pallas kernels run in interpret mode on the same numpy inputs, at the
tolerances of paddle_tpu/ops/pallas_kernels.py FUSED_KERNELS (float32
2e-5, bfloat16 5e-2) and, for attention, 1e-4 in float32.  In float16
(which FUSED_KERNELS does not list) a forward is held element by element
to one float16 step of the JAX value (cuda_kernels.stored_step: 2^-10 of
it, or 2^-24 below float16's normal range; the two sides compute in
float32 in other orders and round once), plus 2^-20 of the output's float32
terms where the forward has them (cuda_kernels.*_fwd_allowed), with
infinities at the same elements; attention's forward in float16 to 1e-3.
The kernels themselves run only on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention as jatt
from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu_torch import _build
from paddle_tpu_torch.core.dtypes import to_tensor
from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.ops import cuda_kernels as ck

DTYPES = ["float32", "bfloat16", "float16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
SDPA_TOL = {"float32": 1e-4, "bfloat16": 5e-2, "float16": 1e-3}


def _t(a):
    return None if a is None else to_tensor(np.asarray(a))


def _err(jax_out, torch_out):
    return float(np.abs(np.asarray(jax_out, np.float32) - torch_out.float().numpy()).max())


def _np16(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def one_float16_step(want, got, allowed=None):
    """got within `allowed` of want (default one float16 step of it),
    element by element; both float16, with infinities at the same elements
    and of the same sign, save where the other side is the largest finite
    value of that sign, +-65504: the float32 value lay within its noise of
    the threshold 65520, and the two lie one step apart."""
    assert got.dtype == torch.float16 and str(want.dtype) == "float16"
    w, g = _np16(want), _np16(got)
    apart = np.isinf(w) != np.isinf(g)
    edge = np.where(np.isinf(w), g, w)[apart]
    assert (np.abs(edge) == 65504.0).all() and (np.sign(edge) == np.sign(
        np.where(np.isinf(w), w, g)[apart])).all()
    both = np.isinf(w) & np.isinf(g)
    assert np.array_equal(w[both], g[both])
    fin = np.isfinite(w) & np.isfinite(g)
    if allowed is None:
        allowed = ck.stored_step(torch.float16, torch.from_numpy(w))
    allowed = _np16(allowed)[fin]
    assert (np.abs(w[fin] - g[fin]) <= allowed).all(), float(np.abs(w[fin] - g[fin]).max())


@pytest.fixture
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU call must not count a kernel launch"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("residual", [True, False])
def test_ln_residual_matches_pallas(dtype, residual, launches_unchanged):
    spec = jpk.FUSED_KERNELS["ln_residual"]
    args = spec["example"](JDT[dtype], residual=residual)
    want = spec["fused"](args, interpret=True)
    x, res, scale, bias = (_t(a) for a in args)
    got = ck.fused_ln_residual(x, res, scale, bias, 1e-5)
    assert got.dtype == x.dtype and got.shape == x.shape
    if dtype == "float16":
        one_float16_step(want, got, ck.ln_residual_fwd_allowed(x, res, scale, bias, _t(want)))
    else:
        assert _err(want, got) <= spec["tol"][dtype]
    assert torch.equal(got, ck.ln_residual_plain(x, res, scale, bias, 1e-5))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ln_backward_column_rule_admits_another_order_and_sees_lost_rows(dtype):
    """ln_residual_bwd_allowed, the rule the LayerNorm backward kernel's
    dscale and dbias are held to on the card: the column sums taken in
    float64 and in another row order stay within it; the same sums with 16
    rows left out (a lost block of the kernel's first pass) fail it by more
    than 2x."""
    rng = np.random.RandomState(8)
    rows, d = 1024, 256
    x, res, g = (torch.from_numpy(rng.randn(rows, d)).to(getattr(torch, dtype)) for _ in range(3))
    scale = torch.from_numpy(rng.rand(d) + 0.5).float()
    _, dscale, dbias = ck.ln_residual_bwd_plain(x, res, scale, g, 1e-5)
    allowed = ck.ln_residual_bwd_allowed(x, res, g, 1e-5)
    r = x.double() + res.double()
    c = r - r.mean(-1, keepdim=True)
    xhat = c / torch.sqrt((c * c).mean(-1, keepdim=True) + 1e-5)
    terms = (g.double() * xhat, g.double())
    order = torch.from_numpy(rng.permutation(rows))

    def share(keep):
        return max(float(((t[keep].sum(0) - w.double()).abs() / a.double()).max())
                   for t, w, a in zip(terms, (dscale, dbias), allowed))

    assert share(order) <= 1.0
    assert share(order[16:]) > 2.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_bias_act_backward_rule_admits_another_order_and_sees_lost_rows(dtype):
    """bias_act_bwd_allowed, the rule the bias+activation backward kernel's
    dx and dbias are held to on the card: dz taken in float64, rounded once
    to x's dtype and summed over the rows in another order, stays within it;
    the same sums with one band of 16 rows left out (a lost band of the
    kernel's first pass) fail it by more than 2x, and so does a dx computed
    with relu' in place of gelu'.  One thread: torch's threaded float32 erf
    on the CPU is off by ~2e-4 at an element in about one run in six, which
    the float64 comparison here would see."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _bias_act_rule_cases(dtype)
    finally:
        torch.set_num_threads(threads)


def _bias_act_rule_cases(dtype):
    rng = np.random.RandomState(9)
    rows, d = 1024, 256
    dt = getattr(torch, dtype)
    x, g = (torch.from_numpy(rng.randn(rows, d)).to(dt) for _ in range(2))
    b = torch.from_numpy(rng.randn(d) * 0.1).float()
    want = ck.bias_act_bwd_plain(x, b, g, "gelu")
    allowed = ck.bias_act_bwd_allowed(x, b, g, "gelu", want)
    z = x.double() + b.double()
    gelu_grad = (0.5 * (1.0 + torch.erf(z / np.sqrt(2.0)))
                 + z * torch.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi))
    dz = g.double() * gelu_grad
    order = torch.from_numpy(rng.permutation(rows))

    def share(got, i):
        return float(((got.double() - want[i].double()).abs() / allowed[i].double()).max())

    assert share(dz.to(dt), 0) <= 1.0
    assert share(dz[order].sum(0), 1) <= 1.0
    assert share(dz[order[16:]].sum(0), 1) > 2.0
    assert share((g.double() * (z > 0).double()).to(dt), 0) > 2.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_bias_act_matches_pallas(dtype, act, launches_unchanged):
    spec = jpk.FUSED_KERNELS["bias_act"]
    x, b = spec["example"](JDT[dtype])
    want = jpk.fused_bias_act(x, b, act, True)
    got = ck.fused_bias_act(_t(x), _t(b), act)
    assert got.dtype == _t(x).dtype
    if dtype == "float16":
        one_float16_step(want, got, ck.bias_act_fwd_allowed(_t(x), _t(b), _t(want)))
    else:
        assert _err(want, got) <= spec["tol"][dtype]


SDPA_CASES = [
    # (B, H, Lq, Lk, dh, bias, causal)
    (2, 4, 16, 16, 8, None, False),
    (2, 4, 16, 16, 8, "bcast", False),
    (2, 4, 16, 16, 8, "per_head", False),
    (2, 4, 16, 16, 8, None, True),
    (2, 4, 16, 16, 8, "per_head", True),
    (1, 2, 8, 24, 8, None, True),     # causal, Lq < Lk: key offset Lk - Lq
    (1, 2, 8, 24, 16, "bcast", False),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SDPA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_sdpa_matches_pallas(dtype, case, launches_unchanged):
    B, H, Lq, Lk, dh, bias_kind, causal = case
    rng = np.random.RandomState(0)
    q = jnp.asarray(rng.randn(B, H, Lq, dh), JDT[dtype])
    k = jnp.asarray(rng.randn(B, H, Lk, dh), JDT[dtype])
    v = jnp.asarray(rng.randn(B, H, Lk, dh), JDT[dtype])
    bias = None
    if bias_kind is not None:
        bias = jnp.asarray(rng.randn(B, 1 if bias_kind == "bcast" else H, Lq, Lk) * 2, jnp.float32)
    scale = 1.0 / np.sqrt(dh)
    want = jatt.fused_sdpa(q, k, v, bias, causal, scale, True)
    got = ca.fused_sdpa(_t(q), _t(k), _t(v), _t(bias), causal, scale)
    assert got.dtype == _t(q).dtype and got.shape == (B, H, Lq, dh)
    assert _err(want, got) <= SDPA_TOL[dtype]


def _xent_edge_labels(case, rows, v):
    rng = np.random.RandomState(3)
    labels = rng.randint(0, v, rows)
    if case == "all_ignored":
        labels[:] = -100
    elif case == "first_and_last":
        labels[::2], labels[1::2] = 0, v - 1
    elif case == "outside":  # neither in [0, V) nor ignored: picks 0
        labels[::3], labels[1::3] = v + 3, -7
        labels[2] = -100
    return labels.astype(np.int32)


XENT_EDGES = [("all_ignored", 8, 33), ("first_and_last", 8, 33), ("outside", 9, 64),
              ("odd_v", 6, 1001)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,rows,v", XENT_EDGES, ids=[c[0] for c in XENT_EDGES])
def test_xent_forward_edges_match_pallas(case, rows, v, dtype, launches_unchanged):
    """The cross-entropy forward's plain version (what the CPU runs, and what
    the card's kernel is held to) against the Pallas kernel in interpret
    mode at the row-6 kernel's edges: every row ignored (loss 0), labels 0
    and V-1, labels outside [0, V) that are not ignored (they pick 0), and
    an odd V, whose bf16 rows start off the 16-byte grid.  Loss float32 on
    both sides: 2e-5, as FUSED_KERNELS."""
    logits = (np.random.RandomState(4).randn(rows, v) * 3).astype(np.float32)
    logits = np.asarray(jnp.asarray(logits, JDT[dtype]))
    labels = _xent_edge_labels(case, rows, v)
    want = np.asarray(jpk.fused_softmax_xent(jnp.asarray(logits), jnp.asarray(labels), -100, True))
    loss, lse = ck.softmax_xent_fwd(_t(logits), _t(labels), -100)
    assert loss.dtype == lse.dtype == torch.float32
    assert float(np.abs(loss.numpy() - want[:, 0]).max()) <= 2e-5
    assert (loss.numpy()[labels == -100] == 0).all()
    if case == "all_ignored":
        assert not loss.any()
    if case == "outside":  # picks 0: the loss is the row's lse
        out = (labels < 0) & (labels != -100) | (labels >= v)
        assert out.sum() == 6
        np.testing.assert_allclose(loss.numpy()[out], lse.numpy()[out], atol=1e-6)


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 8, device="meta")
    b = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.fused_bias_act(x, b, "gelu")
    with pytest.raises(ValueError, match="several devices"):
        ck.fused_bias_act(torch.zeros(4, 8), b, "gelu")
    with pytest.raises(ValueError, match="relu or gelu"):
        ck.fused_bias_act(torch.zeros(4, 8), torch.zeros(8), "tanh")


def test_sdpa_contract_checks():
    """No length limit; the bias shape, a bias that requires grad (not
    differentiable in the fused_sdpa contract) and mismatched head dims raise."""
    q = torch.zeros(1, 2, 1025, 8)
    assert ca.fused_sdpa(q, q, q, None, False, 1.0).shape == q.shape
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="bias"):
        ca.fused_sdpa(q, q, q, torch.zeros(1, 3, 4, 4), False, 1.0)
    with pytest.raises(ValueError, match="do not match"):
        ca.fused_sdpa(q, torch.zeros(1, 2, 4, 16), q, None, False, 1.0)
    bias = torch.zeros(1, 1, 4, 4, requires_grad=True)
    with pytest.raises(ValueError, match="not differentiable"):
        ca.fused_sdpa(q, q, q, bias, False, 1.0)
    with torch.no_grad():  # where nothing differentiates, such a bias is fine
        assert ca.fused_sdpa(q, q, q, bias, False, 1.0).shape == q.shape


def test_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise; nothing falls back."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc: refusing' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.library()
    assert not os.path.exists(_build.lib_path(_build.source_hash()))


_BUILD_RACER = """
import os, sys, time
from paddle_tpu_torch import _build
build_dir, count, ready, go = sys.argv[1:]
_build.BUILD_DIR = build_dir

def counted_build():
    with open(count, "a") as f:
        f.write("built\\n")
    time.sleep(0.5)  # the other process reaches the lock meanwhile
    path = _build.lib_path(_build.source_hash())
    open(path, "w").close()
    return {"path": path}

_build.build = counted_build
open(ready, "w").close()
deadline = time.monotonic() + 60
while not os.path.exists(go):
    if time.monotonic() > deadline:
        sys.exit("no go")
    time.sleep(0.01)
print(_build.ensure_built())
"""


def test_two_processes_build_the_library_once(tmp_path):
    """Two processes check-and-build at once (released together after both
    have imported the package): the build lock lets one build, and the
    other loads the library the first made."""
    import subprocess
    import sys
    import time

    build_dir, count, go = tmp_path / "build", tmp_path / "count", tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_RACER, str(build_dir), str(count),
                               str(tmp_path / f"ready{i}"), str(go)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for i in range(2)]
    try:
        deadline = time.monotonic() + 60
        while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
            time.sleep(0.01)
        go.touch()
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert count.read_text() == "built\n"
    want = build_dir / os.path.basename(_build.lib_path(_build.source_hash()))
    assert outs[0][0] == outs[1][0] == f"{want}\n"


def test_source_hash_covers_sources_and_flags(monkeypatch):
    h = _build.source_hash()
    assert h == _build.source_hash()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.source_hash() != h


def _wrapper_calls():
    """(name, call, the LAUNCHES keys it must count) for every public
    wrapper of the kernel modules, on small CPU operands."""
    r = np.random.RandomState(0)
    f = lambda *s: torch.from_numpy(r.randn(*s).astype(np.float32))  # noqa: E731
    x, g = f(4, 8), f(4, 8)
    q, k, v = f(1, 2, 16, 64), f(1, 2, 16, 64), f(1, 2, 16, 64)
    lse = torch.zeros(1, 2, 16)
    labels = torch.tensor([1, 0, 7, 3], dtype=torch.int32)
    lr = torch.tensor([0.01])
    return [
        ("fused_ln_residual", lambda: ck.fused_ln_residual(x, f(4, 8), f(8), f(8), 1e-5),
         ["ln_residual_fwd"]),
        ("ln_residual_bwd", lambda: ck.ln_residual_bwd(x, None, f(8), g, 1e-5),
         ["ln_residual_bwd"]),
        ("fused_bias_act", lambda: ck.fused_bias_act(x, f(8), "gelu"), ["bias_act_fwd"]),
        ("bias_act_bwd", lambda: ck.bias_act_bwd(x, f(8), g, "relu"), ["bias_act_bwd"]),
        ("bn_epilogue", lambda: ck.bn_epilogue(f(2, 2, 2, 4), f(2), f(2), True),
         ["bn_epilogue_fwd"]),
        ("bn_epilogue_bwd", lambda: ck.bn_epilogue_bwd(x, f(4), f(4), g), ["bn_epilogue_bwd"]),
        ("fused_softmax_xent", lambda: ck.fused_softmax_xent(x, labels), ["softmax_xent_fwd"]),
        ("softmax_xent_bwd", lambda: ck.softmax_xent_bwd(x, labels, torch.zeros(4), torch.ones(4)),
         ["softmax_xent_bwd"]),
        ("fused_adam", lambda: ck.fused_adam(f(4, 8), g, f(4, 8), f(4, 8).abs(), lr, 0.9, 0.999,
                                             1e-8), ["adam"]),
        ("fused_sdpa", lambda: ca.fused_sdpa(q, k, v, None, True, 0.125), ["attention_fwd"]),
        ("attention_bwd", lambda: ca.attention_bwd(q, k, v, None, False, 0.125, q, lse, g.new_zeros(
            q.shape)), ["attention_bwd_dq", "attention_bwd_dkv"]),
    ]


@pytest.mark.parametrize("which", [c[0] for c in _wrapper_calls()])
def test_every_wrapper_launches_its_kernel_on_a_card_tensor(which, monkeypatch):
    """With its operands on the card (on_card answers True here), every
    wrapper launches its kernel, counts the launch and takes no plain path:
    the kernel entry is called (stubbed: there is no card) once per count."""
    calls = []
    for mod in (ck, ca):
        monkeypatch.setattr(mod, "on_card", lambda name, *t: True)
        monkeypatch.setattr(mod, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "call", lambda entry, *args: calls.append(entry))
    for mod in (ck, ca):  # a plain version reached on the card would fail the test
        for plain in [n for n in dir(mod) if n.endswith("_plain")]:
            monkeypatch.setattr(mod, plain, lambda *a, **kw: pytest.fail("plain path taken"))
    monkeypatch.setattr(ck, "LAUNCHES", dict.fromkeys(ck.LAUNCHES, 0))
    monkeypatch.setattr(ca, "LAUNCHES", ck.LAUNCHES)
    _, call, keys = next(c for c in _wrapper_calls() if c[0] == which)
    call()
    assert {k: n for k, n in ck.LAUNCHES.items() if n} == dict.fromkeys(keys, 1)
    assert calls == ["ptt_" + k for k in keys]
