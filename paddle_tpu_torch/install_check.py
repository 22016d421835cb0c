"""Self-test (counterpart of paddle_tpu/install_check.py; reference:
python/paddle/fluid/install_check.py run_check — builds a tiny model, runs
a train step, prints success)."""
from __future__ import annotations

import numpy as np


def run_check(place=None):
    """One SGD step of a one-fc model on `place` (default CUDAPlace(0), the
    card; pass CPUPlace() for the CPU); raises on any failure.  Then, as the
    JAX package's mesh pass over every device: inside a gang of two or more
    ranks (parallel.init_distributed), one data-parallel step over the
    gang; on a host with two or more cards, a gang of one rank a card
    (launch.run_gang of this module) that runs the check there."""
    import torch

    import paddle_tpu_torch as fluid

    place = place if place is not None else fluid.CUDAPlace(0)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 1
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(fluid.layers.fc(x, 1), y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    xv = np.random.rand(8, 4).astype("float32")
    (l0,) = exe.run(main, feed={"x": xv, "y": xv.sum(1, keepdims=True)},
                    fetch_list=[loss], scope=scope)
    assert np.isfinite(np.asarray(l0)).all(), "non-finite loss in install check"

    from .parallel import distributed as dist

    world = dist.num_trainers()
    n = torch.cuda.device_count() if exe.place.device.type == "cuda" else 1
    if world >= 2:
        compiled = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
        scope2 = fluid.Scope()
        exe.run(startup, scope=scope2)
        xm = np.random.rand(2, 4).astype("float32")  # this rank's shard
        (l1,) = exe.run(compiled, feed={"x": xm, "y": xm.sum(1, keepdims=True)},
                        fetch_list=[loss], scope=scope2)
        assert np.isfinite(np.asarray(l1)).all(), "non-finite loss in the data-parallel pass"
        print(f"Your paddle_tpu_torch works well on {world} devices "
              f"(data parallel over a gang of {world} ranks, {dist.backend()}).")
    elif n >= 2:
        import sys

        from .launch import run_gang

        res = run_gang([sys.executable, "-m", "paddle_tpu_torch.install_check"], n,
                       max_restarts=0, log=False)
        if not res.ok:
            tails = "\n".join(f"rank {r}: exit {c}\n{e[-1000:]}"
                              for r, (c, _, e) in enumerate(res.workers))
            raise RuntimeError(f"install check: the data-parallel pass over {n} cards "
                               f"failed:\n{tails}")
        print(f"Your paddle_tpu_torch works well on {n} devices "
              f"(data parallel over a gang of {n} ranks, one a card).")
    else:
        print("Your paddle_tpu_torch works well on 1 device.")
    print("install check passed.")


def _gang_main():
    """A rank of the install check's gang: bring the gang up, then check on
    this rank's card."""
    import paddle_tpu_torch as fluid
    from .parallel import distributed as dist

    dist.init_distributed()
    run_check(fluid.CUDAPlace(dist.card()) if dist.card() is not None else fluid.CPUPlace())


if __name__ == "__main__":
    import os

    if os.environ.get("PADDLE_TRAINER_ENDPOINTS"):
        _gang_main()
    else:
        run_check()
