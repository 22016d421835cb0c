"""Dygraph checkpointing (counterpart of paddle_tpu/dygraph/checkpoint.py;
reference dygraph/checkpoint.py:27 save_persistables / load_persistables).
One `.npy` a variable and a `__manifest__.json`, byte for byte the JAX
package's files: a directory either package writes, the other loads."""
from __future__ import annotations

import json
import os

import numpy as np

from .layers import Layer


def save_persistables(model_dict, dirname: str, optimizers=None):
    if isinstance(model_dict, Layer):
        state = model_dict.state_dict()
    else:
        state = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
                 for k, v in model_dict.items()}
    os.makedirs(dirname, exist_ok=True)
    manifest = []
    for name, arr in state.items():
        fname = name.replace("/", "%2F") + ".npy"
        np.save(os.path.join(dirname, fname), arr)
        manifest.append({"name": name, "file": fname})
    with open(os.path.join(dirname, "__manifest__.json"), "w") as f:
        json.dump({"vars": manifest}, f)


def load_persistables(dirname: str):
    with open(os.path.join(dirname, "__manifest__.json")) as f:
        manifest = json.load(f)
    return {e["name"]: np.load(os.path.join(dirname, e["file"])) for e in manifest["vars"]}
