"""Self-test (counterpart of paddle_tpu/install_check.py; reference:
python/paddle/fluid/install_check.py run_check — builds a tiny model, runs
a train step, prints success)."""
from __future__ import annotations

import numpy as np


def run_check(place=None):
    """One SGD step of a one-fc model on `place` (default CUDAPlace(0), the
    card; pass CPUPlace() for the CPU); raises on any failure.  The JAX
    package also runs the step over a mesh of every device when there are
    two or more; the port's mesh comes with ROADMAP A10, so with several
    cards it runs the one-card step and says the mesh pass waits."""
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

    n = torch.cuda.device_count() if exe.place.device.type == "cuda" else 1
    if n >= 2:
        print(f"Your paddle_tpu_torch works well on 1 device; the mesh pass over "
              f"{n} devices waits for the data-parallel slice (ROADMAP A10).")
    else:
        print("Your paddle_tpu_torch works well on 1 device.")
    print("install check passed.")


if __name__ == "__main__":
    run_check()
