"""tools/port_opbench.py on the CPU (the port's counterpart of
tests/test_opbench.py): the interleaved A/B timer, one op through the
port's Executor with its gradient, the CLI's JSON line; and the fused-kernel
registry (ops/cuda_kernels.py FUSED_KERNELS) against the JAX package's
(paddle_tpu/ops/pallas_kernels.py): the same entries, `analytic` equal for
each kernel and dtype, and the port's plain versions — what `--fused --cpu`
runs — within the JAX tolerances of the JAX composites, forward and
backward, on the same inputs."""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import port_opbench  # noqa: E402

DTYPES = ("float32", "bfloat16")


def test_interleave_stats_shape():
    calls = {"a": [], "b": []}

    def mk(name):
        def f():
            calls[name].append(1)
            return np.zeros(3)
        return f

    stats = port_opbench.interleave({"a": mk("a"), "b": mk("b")}, rounds=3, iters=2,
                                    warmup=1)
    assert set(stats) == {"a", "b"}
    for s in stats.values():
        assert len(s["windows_ms"]) == 3
        assert s["best_ms"] <= s["median_ms"]
        assert s["spread_pct"] >= 0
        assert "device_best_ms" not in s  # no card: host windows only
    # warmup(1) + rounds*iters(6) dispatches per variant, interleaved equally
    assert len(calls["a"]) == len(calls["b"]) == 7


def test_op_dispatch_fwd_and_grad():
    import paddle_tpu_torch as fluid

    d = port_opbench.build_op_dispatch(
        "relu", {"X": np.random.RandomState(0).randn(4, 8).astype("float32")},
        grad=True, place=fluid.CPUPlace())
    out = d()
    assert np.isfinite(np.asarray(out[0])).all()
    assert len(out) == 2  # loss + dX


def test_cli_json_line(capsys):
    port_opbench.main(["--op", "scale", "--input", "X=4x4", "--attr", "scale=2.0",
                       "--cpu", "--rounds", "2", "--iters", "2"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["op"] == "scale"
    assert rec["attrs"] == {"scale": 2.0}
    assert rec["best_ms"] > 0


# --------------------------------------------------------------------------
# the registry against the JAX package's
# --------------------------------------------------------------------------

def _jax_registry():
    from paddle_tpu.ops import pallas_kernels

    return pallas_kernels.FUSED_KERNELS


def _to_jax(args):
    import jax.numpy as jnp

    out = []
    for a in args:
        if a is None:
            out.append(None)
        elif a.dtype == torch.bfloat16:
            out.append(jnp.asarray(a.float().numpy(), jnp.bfloat16))
        else:
            out.append(jnp.asarray(a.numpy()))
    return tuple(out)


def _leaves(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def test_registry_entries_equal():
    from paddle_tpu_torch.ops import cuda_kernels as ck

    jreg = _jax_registry()
    assert ck.registered_fused_kernels() == sorted(jreg)
    for name, spec in ck.FUSED_KERNELS.items():
        assert spec["tol"] == jreg[name]["tol"], name
        assert tuple(spec["grad_argnums"]) == tuple(jreg[name]["grad_argnums"]), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["adam_slab", "bias_act", "bn_scale_shift_relu", "ln_residual",
                                    "softmax_xent"])
def test_analytic_equals_the_jax_entrys(kernel, dtype):
    import jax.numpy as jnp

    from paddle_tpu_torch.ops import cuda_kernels as ck

    jspec = _jax_registry()[kernel]
    spec = ck.FUSED_KERNELS[kernel]
    args = spec["example"](getattr(torch, dtype))
    jargs = jspec["example"](jnp.dtype(dtype))
    assert [None if a is None else (tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in args] == [None if a is None else (tuple(a.shape), str(a.dtype))
                               for a in jargs]
    assert spec["analytic"](args) == jspec["analytic"](jargs)
    # the same seeded values
    for a, j in zip(args, jargs):
        if a is not None:
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["adam_slab", "bias_act", "bn_scale_shift_relu", "ln_residual",
                                    "softmax_xent"])
def test_plain_versions_match_the_jax_composites(kernel, dtype):
    """What `--fused --cpu` runs (the wrappers take the plain versions on
    CPU tensors) against the JAX package's composite reference, forward and,
    for the layers, backward (the gradients of sum(out**2), the JAX tool's
    scale-aware bound)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.ops import cuda_kernels as ck

    jspec = _jax_registry()[kernel]
    spec = ck.FUSED_KERNELS[kernel]
    tol = jspec["tol"][dtype]
    args = spec["example"](getattr(torch, dtype))
    jargs = _to_jax(args)
    fresh = [None if a is None else a.clone() for a in args]
    got = [t.float().numpy() for t in _leaves(spec["fused"](fresh))]
    want = [np.asarray(jnp.asarray(t, jnp.float32)) for t in _leaves(jspec["reference"](jargs))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(np.max(np.abs(g - w))) <= tol, kernel
    argnums = tuple(i for i in spec["grad_argnums"] if args[i] is not None)
    if not argnums:
        return

    def jloss(*a):
        return sum(jnp.sum(jnp.square(leaf.astype(jnp.float32)))
                   for leaf in _leaves(jspec["reference"](a)))

    jgrads = jax.grad(jloss, argnums=argnums)(*jargs)
    grads = port_opbench._grad_fn(spec["fused"], args, argnums)()
    assert len(grads) == len(jgrads)
    for g, w in zip(grads, jgrads):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape
        assert float(np.max(np.abs(g - w))) <= tol * (1.0 + float(np.max(np.abs(w)))), kernel


def test_fused_cpu_cli(capsys):
    assert port_opbench.main(["--fused", "--cpu"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert sorted({r["kernel"] for r in recs}) == sorted(_jax_registry())
    assert {r["dtype"] for r in recs} == set(DTYPES)
    for r in recs:
        assert r["cpu"] and r["parity_err"] <= r["parity_tol"]
        assert "kernel_stats" not in r  # no kernel runs on the CPU
