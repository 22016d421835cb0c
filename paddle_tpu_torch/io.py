"""Checkpoint and inference-model save/load (counterpart of paddle_tpu/io.py).

The on-disk format is the JAX package's: one `.npy` per variable and
`__manifest__.json` listing every file with its sha256 and byte length;
an inference model adds `__model__.json`, the pruned test-mode Program
(plus "feed_names"/"fetch_names").  bfloat16 arrays are stored as their
uint16 bit pattern with dtype "bfloat16" in the manifest.  A checkpoint or
model saved by either package loads in the other.  `save_persistables` /
`load_persistables` carry every persistable (parameters, optimizer
accumulators, the learning rate), so training resumes exactly;
`save_params` / `load_params` carry the parameters only.  A load verifies
each file against its manifest stamp (FLAGS_integrity_verify_load) and
raises `errors.IntegrityError` on a mismatch.  The sharded checkpoints
(`save_sharded` / `load_sharded`) come with data parallelism (ROADMAP A10)
and int8 models with a later slice.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import flags
from .core.dtypes import to_tensor
from .core.executor import CUDAPlace, _prune, _runnable_ops
from .core.program import Program, Variable, default_main_program
from .core.scope import Scope, global_scope
from .errors import IntegrityError  # also reachable as io.IntegrityError

MODEL_FILENAME = "__model__.json"
MANIFEST = "__manifest__.json"
QUANT_MANIFEST = "__quant__.json"


def _atomic_commit(path: str, mode: str, write_cb):
    """Write via `write_cb(f)` to a temp name, fsync, rename into place:
    the file exists whole or not at all."""
    tmp = f"{path}.{os.getpid()}.tmp~"
    try:
        with open(tmp, mode) as f:
            write_cb(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _file_stamp(path: str) -> dict:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
            n += len(chunk)
    return {"sha256": h.hexdigest(), "bytes": n}


def _verify(dirname: str, entry: dict):
    """The file of a manifest entry against its recorded sha256 and byte
    length; an entry without a digest (an old manifest) passes unchecked."""
    sha = entry.get("sha256")
    if not sha:
        return
    fname = entry["file"]
    try:
        got = _file_stamp(os.path.join(dirname, fname))
    except OSError as e:
        raise IntegrityError(f"manifest names {fname!r} but it cannot be read "
                             f"({type(e).__name__}: {e})", file=fname) from e
    if entry.get("bytes") is not None and got["bytes"] != int(entry["bytes"]):
        raise IntegrityError(
            f"{fname!r} is {got['bytes']} bytes but the manifest recorded {entry['bytes']} "
            f"-- truncated or grown since save", file=fname, expected=str(entry["bytes"]),
            actual=str(got["bytes"]))
    if got["sha256"] != sha:
        raise IntegrityError(
            f"{fname!r} content digest mismatch: manifest recorded sha256 {sha[:16]}..., "
            f"file hashes to {got['sha256'][:16]}... -- the bytes changed since save",
            file=fname, expected=sha, actual=got["sha256"])


def _host_array(t) -> np.ndarray:
    """Tensor -> numpy for storage; bfloat16 keeps its bits as uint16."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def save_vars(dirname: str, var_names: Sequence[str], scope: Optional[Scope] = None) -> List[dict]:
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    saved = []
    for name in var_names:
        v = scope.find_var(name)
        if v is None:
            raise KeyError(f"save_vars: {name!r} not found in scope")
        dtype = "bfloat16" if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 else None
        arr = _host_array(v)
        dtype = dtype or str(arr.dtype)
        fname = name.replace("/", "%2F") + ".npy"
        path = os.path.join(dirname, fname)
        _atomic_commit(path, "wb", lambda f: np.save(f, arr))
        saved.append({"name": name, "file": fname, "shape": list(arr.shape), "dtype": dtype,
                      **_file_stamp(path)})
    _atomic_commit(os.path.join(dirname, MANIFEST), "w",
                   lambda f: f.write(json.dumps({"vars": saved}, indent=1)))
    return saved


def load_vars(dirname: str, var_names: Optional[Sequence[str]] = None,
              scope: Optional[Scope] = None, device="cpu",
              verify: Optional[bool] = None) -> List[str]:
    """Load a save_vars directory into `scope` as tensors on `device`.
    `verify=None` follows FLAGS_integrity_verify_load."""
    scope = scope or global_scope()
    with open(os.path.join(dirname, MANIFEST)) as f:
        manifest = json.load(f)
    if os.path.exists(os.path.join(dirname, QUANT_MANIFEST)):
        raise NotImplementedError("int8 (quantized) inference models are not ported yet")
    verify = flags.flag("FLAGS_integrity_verify_load") if verify is None else bool(verify)
    want = set(var_names) if var_names is not None else None
    loaded = []
    for entry in manifest["vars"]:
        if want is not None and entry["name"] not in want:
            continue
        if verify:
            _verify(dirname, entry)
        arr = np.load(os.path.join(dirname, entry["file"]))
        if entry.get("dtype") == "bfloat16" and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
        else:
            t = to_tensor(arr, None, device)
        scope.set_var(entry["name"], t)
        loaded.append(entry["name"])
    if want is not None:
        missing = want - set(loaded)
        if missing:
            raise KeyError(f"load_vars: checkpoint lacks {sorted(missing)}")
    return loaded


def load_numpy_params(scope: Scope, params: Dict[str, np.ndarray], device="cpu") -> None:
    """Put numpy arrays into `scope` as tensors on `device`: for instance the
    JAX package's whole persistable state -- parameters, Adam's moment1 /
    moment2 and float32 beta pows, Momentum's velocities, batch norm's
    running mean and variance, the learning-rate var -- numpy bfloat16
    included."""
    for name, arr in params.items():
        scope.set_var(name, to_tensor(arr, None, device))


def _persistables(program: Program) -> List[Variable]:
    return [v for v in program.list_vars() if v.persistable]


def save_persistables(executor, dirname: str, main_program: Optional[Program] = None,
                      scope: Optional[Scope] = None) -> List[dict]:
    """Every persistable var of the program (parameters, optimizer
    accumulators, the learning rate), so training resumes exactly."""
    program = main_program or default_main_program()
    return save_vars(dirname, [v.name for v in _persistables(program)], scope)


def save_params(executor, dirname: str, main_program: Optional[Program] = None,
                scope: Optional[Scope] = None) -> List[dict]:
    """The program's parameters only."""
    program = main_program or default_main_program()
    return save_vars(dirname, [p.name for p in program.all_parameters()], scope)


def _load_device(executor):
    """The executor's device; with no executor, the card."""
    return (executor.place if executor is not None else CUDAPlace(0)).device


def load_persistables(executor, dirname: str, main_program: Optional[Program] = None,
                      scope: Optional[Scope] = None) -> List[str]:
    """Every persistable var of the program, onto the executor's device;
    a var the checkpoint lacks raises KeyError."""
    program = main_program or default_main_program()
    return load_vars(dirname, [v.name for v in _persistables(program)], scope,
                     device=_load_device(executor))


def load_params(executor, dirname: str, main_program: Optional[Program] = None,
                scope: Optional[Scope] = None) -> List[str]:
    """The program's parameters, onto the executor's device."""
    program = main_program or default_main_program()
    return load_vars(dirname, [p.name for p in program.all_parameters()], scope,
                     device=_load_device(executor))


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable], executor=None,
                         main_program: Optional[Program] = None,
                         scope: Optional[Scope] = None) -> List[str]:
    """Prune to the feed -> target subgraph, switch to test mode, and write
    the program and its parameters."""
    program = main_program or default_main_program()
    inference = program.clone(for_test=True)
    target_names = [t.name if isinstance(t, Variable) else str(t) for t in target_vars]
    block = inference.global_block()
    block.ops = _prune(_runnable_ops(block), target_names, set())
    used = {n for op in block.ops for n in op.input_arg_names + op.output_arg_names}
    os.makedirs(dirname, exist_ok=True)
    doc = inference.to_dict()
    doc["feed_names"] = list(feeded_var_names)
    doc["fetch_names"] = target_names
    _atomic_commit(os.path.join(dirname, MODEL_FILENAME), "w", lambda f: f.write(json.dumps(doc)))
    save_vars(dirname, [v.name for v in _persistables(inference) if v.name in used], scope)
    return target_names


def load_inference_model(dirname: str, executor, scope: Optional[Scope] = None,
                         verify: Optional[bool] = None):
    """Returns (program, feed_names, fetch_names); the parameters land in
    `scope` on the executor's device."""
    with open(os.path.join(dirname, MODEL_FILENAME)) as f:
        doc = json.load(f)
    program = Program.from_dict(doc)
    load_vars(dirname, None, scope, device=executor.place.device, verify=verify)
    return program, doc["feed_names"], doc["fetch_names"]
