"""The port's install_check, transpiler and in-place update audit against
the JAX package's on the CPU: `run_check(place=CPUPlace())` prints the
success lines; both packages refuse the pserver mode; the dispatchers give
the same endpoints; one trainer's transpiled program trains to the JAX
package's losses (its one-device program; the JAX package's runs over its
mesh of CPU devices); `memory_optimize` and `release_memory` are accepted
no-ops; tools/port_donation_audit.py gives tools/donation_audit.py's
classes over the tiny zoo."""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch.core import unique_name as t_unique

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PKGS = {"jax": (jfluid, j_unique), "torch": (tfluid, t_unique)}


def test_run_check_on_the_cpu(capsys):
    tfluid.install_check.run_check(place=tfluid.CPUPlace())
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["Your paddle_tpu_torch works well on 1 device.", "install check passed."]


def test_run_check_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.install_check.run_check()


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("how", ["pservers", "mode"])
def test_pserver_mode_refused(pkg, how):
    fluid, _ = PKGS[pkg]
    config = fluid.DistributeTranspilerConfig()
    kw = {}
    if how == "mode":
        config.mode = "pserver"
    else:
        kw["pservers"] = "127.0.0.1:6170,127.0.0.1:6171"
    t = fluid.DistributeTranspiler(config)
    with pytest.raises(NotImplementedError, match="parameter-server mode"):
        t.transpile(0, program=fluid.Program(), **kw)
    with pytest.raises(NotImplementedError, match="get_pserver_program"):
        t.get_pserver_program("127.0.0.1:6170")


@pytest.mark.parametrize("trainers", [2, "127.0.0.1:6170,127.0.0.1:6171"])
def test_more_than_one_trainer_waits_for_a10(trainers):
    t = tfluid.DistributeTranspiler()
    with pytest.raises(NotImplementedError, match="A10"):
        t.transpile(0, program=tfluid.Program(), trainers=trainers)
    with pytest.raises(RuntimeError, match="transpile"):
        t.get_trainer_program()


@pytest.mark.parametrize("dispatcher", ["RoundRobin", "HashName"])
def test_dispatchers_give_the_same_endpoints(dispatcher):
    eps = [f"127.0.0.1:{6170 + i}" for i in range(3)]
    names = [f"fc_{i}.w_0" for i in range(7)] + ["embedding_0.w_0", "x@GRAD"]
    got = {}
    for pkg, (fluid, _) in PKGS.items():
        d = getattr(fluid.transpiler, dispatcher)(eps)
        got[pkg] = (d.dispatch(names), d.dispatch(names[:4]), d.eps)
        d.reset()
        got[pkg] += (d.dispatch(names[:2]),)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_memory_optimize_and_release_memory_are_no_ops(pkg):
    fluid, _ = PKGS[pkg]
    p = fluid.Program()
    assert fluid.memory_optimize(p, print_log=True, level=1) is None
    assert fluid.release_memory(p) is None
    assert fluid.transpiler.memory_optimize is fluid.memory_optimize


def _fc_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 1
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(x, 1), y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_one_trainer_transpiled_program_trains_to_the_jax_losses():
    rng = np.random.RandomState(0)
    feeds = [rng.rand(16, 4).astype("float32") for _ in range(3)]
    losses, state = {}, None
    for pkg in ("jax", "torch"):
        fluid, unique = PKGS[pkg]
        with unique.guard():
            main, startup, loss = _fc_program(fluid)
        t = fluid.DistributeTranspiler()
        t.transpile(0, program=main, trainers=1)
        prog = t.get_trainer_program()
        assert t.get_startup_program(startup_program=startup) is startup
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if pkg == "jax":
            state = {v.name: np.array(scope.find_var(v.name)) for v in main.list_vars()
                     if v.persistable and scope.find_var(v.name) is not None}
        else:
            assert isinstance(prog, fluid.CompiledProgram) and prog.program is main
            fluid.io.load_numpy_params(scope, state)
        losses[pkg] = [float(np.asarray(exe.run(prog, feed={"x": xv, "y": xv.sum(1, keepdims=True)},
                                                fetch_list=[loss], scope=scope)[0]).reshape(-1)[0])
                       for xv in feeds]
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5, atol=1e-6)
    assert losses["torch"][-1] < losses["torch"][0]


def test_donation_audit_gives_the_jax_tools_classes():
    from tools import donation_audit, port_donation_audit

    with j_unique.guard():
        want = donation_audit.audit_zoo(tiny=True)
    with t_unique.guard():
        got = port_donation_audit.audit_zoo(tiny=True)
    assert got == want
    assert all(r["clean"] for r in got.values())
    assert port_donation_audit.main(["--check", "--program", "mnist"]) == 0
