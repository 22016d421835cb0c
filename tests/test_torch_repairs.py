"""Three places where the port answered a call differently from the JAX
package, each call now run in both packages and held equal:

  * the four flags the JAX package accepts as documented no-ops
    (`FLAGS_cudnn_deterministic`, `FLAGS_fraction_of_gpu_memory_to_use`,
    `FLAGS_allocator_strategy`, `FLAGS_paddle_num_threads`) through
    `flag`, `set_flags`, `get_flags`, `all_flags` and `init_from_env`; in
    the port they set nothing, `torch.backends.cudnn.deterministic`
    included;
  * `io.load_vars(dirname, var_names, scope, verify)` positionally;
  * `FaultInjector.on_commit` of a commit without a directory (None, or a
    path that is not one): counted, nothing mutated, the argument
    returned.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import flags as jflags
from paddle_tpu.errors import IntegrityError as JIntegrityError
from paddle_tpu.faults import FaultInjector as JFaultInjector
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.errors import IntegrityError as TIntegrityError
from paddle_tpu_torch.faults import FaultInjector as TFaultInjector

NO_OP_FLAGS = {"FLAGS_cudnn_deterministic": (True, False, "0"),
               "FLAGS_fraction_of_gpu_memory_to_use": (1.0, 0.5, "0.25"),
               "FLAGS_allocator_strategy": ("auto_growth", "naive_best_fit", "naive_best_fit"),
               "FLAGS_paddle_num_threads": (1, 4, "8")}


@pytest.fixture
def restore_flags():
    saved = {m: m.get_flags(list(NO_OP_FLAGS)) for m in (jflags, tflags)}
    yield
    for m, values in saved.items():
        m.set_flags(values)


@pytest.mark.parametrize("name", sorted(NO_OP_FLAGS))
def test_no_op_flags_answer_as_in_the_jax_package(name, monkeypatch, restore_flags):
    default, value, env = NO_OP_FLAGS[name]
    seen = {}
    for pkg, m in (("jax", jflags), ("torch", tflags)):
        row = [m.flag(name), m.get_flags(name), name in m.all_flags(),
               type(m.flag(name)).__name__]
        m.set_flags({name: value})
        row += [m.flag(name), m.get_flags([name])]
        monkeypatch.setenv(name, env)
        m.init_from_env()
        row.append(m.flag(name))
        monkeypatch.delenv(name)
        seen[pkg] = row
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == default


@pytest.mark.parametrize("value", [True, False])
def test_cudnn_deterministic_flag_sets_nothing_on_the_card(value, restore_flags):
    before = torch.backends.cudnn.deterministic
    tfluid.set_flags({"FLAGS_cudnn_deterministic": value})
    assert torch.backends.cudnn.deterministic is before
    assert "torch.backends.cudnn.deterministic" in tflags._REGISTRY[
        "FLAGS_cudnn_deterministic"]["help"]


def _saved_vars(tmp_path):
    scope = jfluid.Scope()
    rng = np.random.RandomState(3)
    names = ["w", "b"]
    for n in names:
        scope.set_var(n, rng.rand(4, 3).astype("float32"))
    d = str(tmp_path / "vars")
    jfluid.io.save_vars(d, names, scope)
    return d, names


def test_load_vars_takes_verify_fourth(tmp_path):
    d, names = _saved_vars(tmp_path)
    loaded = {}
    for pkg, fluid in (("jax", jfluid), ("torch", tfluid)):
        scope = fluid.Scope()
        got = fluid.io.load_vars(d, ["w"], scope, False)
        loaded[pkg] = (got, np.asarray(scope.find_var("w")))
    assert loaded["torch"][0] == loaded["jax"][0] == ["w"]
    np.testing.assert_array_equal(loaded["torch"][1], loaded["jax"][1])
    manifest = jfluid.io.read_json(os.path.join(d, jfluid.io.MANIFEST))
    path = os.path.join(d, next(e["file"] for e in manifest["vars"] if e["name"] == "w"))
    with open(path, "r+b") as f:  # same length, other bytes
        f.seek(os.path.getsize(path) - 1)
        last = f.read(1)
        f.seek(os.path.getsize(path) - 1)
        f.write(bytes([last[0] ^ 0xFF]))
    raised = {}
    for pkg, fluid, err in (("jax", jfluid, JIntegrityError), ("torch", tfluid, TIntegrityError)):
        with pytest.raises(err) as ei:
            fluid.io.load_vars(d, ["w"], fluid.Scope(), True)
        raised[pkg] = (type(ei.value).__name__, os.path.basename(ei.value.file))
        # verify=False skips the digest: the tampered bytes load
        assert fluid.io.load_vars(d, ["w"], fluid.Scope(), False) == ["w"]
    assert raised["torch"] == raised["jax"]


def test_on_commit_without_a_directory_counts_and_mutates_nothing(tmp_path):
    missing = str(tmp_path / "not_there")
    seen = {}
    for pkg, cls in (("jax", JFaultInjector), ("torch", TFaultInjector)):
        inj = cls("rot_shard@0;rot_shard@1")
        row = [inj.on_commit(None), inj.on_commit(missing), inj._commits,
               [f.fired for f in inj.faults]]
        seen[pkg] = row
    assert seen["torch"] == seen["jax"] == [None, missing, 2, [False, False]]


def test_on_commit_still_rots_a_committed_directory(tmp_path):
    """The Nth commit with a directory is still the one rot_shard@N hits."""
    rotted = {}
    for pkg, cls in (("jax", JFaultInjector), ("torch", TFaultInjector)):
        d = tmp_path / pkg
        d.mkdir()
        np.save(d / "a.npy", np.arange(64, dtype=np.float32))
        before = (d / "a.npy").read_bytes()
        inj = cls("rot_shard@1")
        inj.on_commit(None)
        assert inj.on_commit(str(d)) == str(d)
        after = (d / "a.npy").read_bytes()
        rotted[pkg] = (inj._commits, [f.fired for f in inj.faults],
                       sum(a != b for a, b in zip(before, after)))
    assert rotted["torch"] == rotted["jax"] == (2, [True], 1)
