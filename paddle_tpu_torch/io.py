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
raises `errors.IntegrityError` on a mismatch.  `save_sharded` /
`load_sharded` write and read the JAX package's sharded checkpoint format
for one process (`__sharded_manifest__.json`, one `<name>.p0s0.npy` a
var; SelectedRows as row and value files), which `CheckpointManager` uses;
a mesh and multi-process shards come with data parallelism (ROADMAP A10).
`save_quantized_inference_model` stores a model's weights as int8 with
their scales in `__quant__.json`; `load_vars` (and so
`load_inference_model` and `Predictor`) dequantizes them into their serve
dtype with no flag.

Storage choke point, as in the JAX package: every checkpoint, manifest
and sidecar byte goes through `atomic_write` / `save_array` /
`append_record` (writes) and `open_for_read` / `load_array` /
`read_journal` (reads).  One hook (`set_io_fault_hook`,
armed by faults.py) sees every operation first, writes are tmp + fsync +
rename, and an OSError crossing the seam carries phase="storage", which
`errors.classify` maps onto `StorageError`.
"""
from __future__ import annotations

import json
import logging
import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import flags
from . import integrity as _integrity
from .core.dtypes import _numpy_bfloat16, to_numpy, to_tensor
from .core.executor import CUDAPlace, _prune, _runnable_ops
from .core.program import Program, Variable, default_main_program
from .core.scope import RNG_STATE_VAR, Scope, global_scope
from .errors import IntegrityError  # also reachable as io.IntegrityError  # noqa: F401

MODEL_FILENAME = "__model__.json"
MANIFEST = "__manifest__.json"
QUANT_MANIFEST = "__quant__.json"


# --- storage choke point ----------------------------------------------------

_IO_FAULT_HOOK = None  # callable(op: "read" | "write", path) -> None; may raise
# path prefixes the fault hook leaves alone (a checkpoint fallback dir
# models another device: a fault injected on the primary must not follow)
_FAULT_EXEMPT: List[str] = []


class fault_exempt:
    """Context manager: operations on paths under `prefix` are exempt from
    fault injection while it is open (re-entrant; compared absolute)."""

    def __init__(self, prefix: str):
        self._p = os.path.abspath(prefix)

    def __enter__(self):
        _FAULT_EXEMPT.append(self._p)
        return self

    def __exit__(self, *exc):
        _FAULT_EXEMPT.remove(self._p)
        return False


def fault_exempt_prefixes():
    return tuple(_FAULT_EXEMPT)


def set_io_fault_hook(hook):
    """Install (or, with None, remove) the storage-fault hook every choke-
    point operation consults first; returns the previous hook."""
    global _IO_FAULT_HOOK
    prev, _IO_FAULT_HOOK = _IO_FAULT_HOOK, hook
    return prev


def _storage_ctx(e: BaseException) -> BaseException:
    from .errors import attach_context

    return attach_context(e, phase="storage")


def _gate(op: str, path: str):
    hook = _IO_FAULT_HOOK
    if hook is not None:
        try:
            hook(op, path)
        except OSError as e:
            raise _storage_ctx(e)


def _atomic_commit(path: str, mode: str, write_cb, fsync: bool = True):
    """Write via `write_cb(f)` to a writer-unique temp name, fsync, rename
    into place: the file exists whole or not at all.  A failure removes the
    temp and re-raises with the storage breadcrumb."""
    tmp = f"{path}.{os.getpid()}.tmp~"
    try:
        with open(tmp, mode) as f:
            write_cb(f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise _storage_ctx(e)


def atomic_write(path: str, data, *, fsync: bool = True):
    """The write discipline for small control files (manifests, markers,
    sidecars): gate, then `_atomic_commit`."""
    _gate("write", path)
    mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
    _atomic_commit(path, mode, lambda f: f.write(data), fsync=fsync)


def append_record(path: str, data: bytes, *, fsync: bool = True):
    """Append one length-prefixed record to a write-ahead journal through
    the choke point (the pserver's op journal, param_server.py).  The
    record is framed as u32 LE length + payload and fsynced before the
    caller applies the op it describes, so a crash leaves at most one torn
    tail record, which `read_journal` drops by its length prefix.  An
    append is no atomic rename (a journal is cheap incremental durability);
    the framing makes a torn append recoverable."""
    _gate("write", path)
    try:
        with open(path, "ab") as f:
            f.write(struct.pack("<I", len(data)) + data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
    except OSError as e:
        raise _storage_ctx(e)


def read_journal(path: str):
    """Yield each whole record `append_record` wrote to `path`, in order;
    a torn tail (a crash mid-append) is dropped: every record before it
    was fsynced whole."""
    with open_for_read(path, "rb") as f:
        buf = f.read()
    off = 0
    while off + 4 <= len(buf):
        (n,) = struct.unpack_from("<I", buf, off)
        if off + 4 + n > len(buf):
            break
        yield buf[off + 4:off + 4 + n]
        off += 4 + n


def save_array(path: str, arr) -> Optional[str]:
    """Atomic .npy write through the choke point; returns the `stored_as`
    tag ("bfloat16_as_uint16": a bf16 array is stored as its bits)."""
    _gate("write", path)
    stored_as = None
    if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:
        stored_as = "bfloat16_as_uint16"
    arr = _host_array(arr)
    if arr.dtype.kind == "V" or "bfloat16" in str(arr.dtype):
        arr = arr.view(np.uint16)
        stored_as = "bfloat16_as_uint16"
    _atomic_commit(path, "wb", lambda f: np.save(f, arr))
    return stored_as


def open_for_read(path: str, mode: str = "rb"):
    """The read seam: a failing store surfaces as a storage failure here."""
    _gate("read", path)
    try:
        return open(path, mode)
    except OSError as e:
        raise _storage_ctx(e)


def load_array(path: str, mmap_mode=None):
    """np.load through the read seam."""
    _gate("read", path)
    try:
        return np.load(path, mmap_mode=mmap_mode)
    except OSError as e:
        raise _storage_ctx(e)


def read_json(path: str):
    with open_for_read(path, "r") as f:
        return json.load(f)


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
        save_array(path, arr)
        saved.append({"name": name, "file": fname, "shape": list(arr.shape), "dtype": dtype,
                      **_integrity.stamp_file(path)})
    atomic_write(os.path.join(dirname, MANIFEST), json.dumps({"vars": saved}, indent=1))
    return saved


def load_vars(dirname: str, var_names: Optional[Sequence[str]] = None,
              scope: Optional[Scope] = None, verify: Optional[bool] = None,
              device="cpu") -> List[str]:
    """Load a save_vars directory into `scope` as tensors on `device`.
    `verify=None` follows FLAGS_integrity_verify_load."""
    scope = scope or global_scope()
    manifest = read_json(os.path.join(dirname, MANIFEST))
    qman = {}
    qpath = os.path.join(dirname, QUANT_MANIFEST)
    if os.path.exists(qpath):
        qman = read_json(qpath).get("weights", {})
    verify = flags.flag("FLAGS_integrity_verify_load") if verify is None else bool(verify)
    want = set(var_names) if var_names is not None else None
    loaded = []
    for entry in manifest["vars"]:
        if want is not None and entry["name"] not in want:
            continue
        if verify:  # an entry without a digest (an old manifest) passes unchecked
            _integrity.verify_file_entry(dirname, entry["file"], entry.get("sha256"),
                                         entry.get("bytes"))
        arr = load_array(os.path.join(dirname, entry["file"]))
        if entry["name"] in qman and arr.dtype == np.int8:
            # an int8 payload: dequantized on the host into its record's
            # dtype, in the JAX package's expression (the manifest may say
            # bfloat16 for it, so this comes before the bf16 branch)
            t = to_tensor(_dequantize(arr, qman[entry["name"]]), None, device)
        elif entry.get("dtype") == "bfloat16" and arr.dtype == np.uint16:
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


def _dequantize(q: np.ndarray, rec: dict) -> np.ndarray:
    """(q -> float32) * scale / qmax, cast to the record's dtype."""
    qmax = float(2 ** (rec["bits"] - 1) - 1)
    scale = np.asarray(rec["scale"], np.float32)
    shp = [1] * q.ndim
    axis = rec.get("axis")
    if axis is not None:
        shp[axis] = -1
    dtype = rec.get("dtype", "float32")
    return (q.astype(np.float32) * scale.reshape(shp) / qmax).astype(
        _numpy_bfloat16() if dtype == "bfloat16" else dtype)


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


# --- sharded checkpoints (the JAX package's format, one process) -------------

SHARDED_MANIFEST = "__sharded_manifest__.json"

_log = logging.getLogger("paddle_tpu_torch.io")


def _whole(shape) -> list:
    return [[0, int(d)] for d in shape]


def save_sharded(dirname: str, var_names: Optional[Sequence[str]] = None,
                 scope: Optional[Scope] = None, program: Optional[Program] = None,
                 process_index: Optional[int] = None) -> List[str]:
    """The JAX package's sharded checkpoint for one process: each var one
    shard `<name>.p0s0.npy` covering it whole (a SelectedRows var its row
    and value files), stamped with sha256 and byte length, listed in
    `__sharded_manifest__.json` with its global shape and dtype.  The
    scope's torch generator (`RNG_STATE_VAR`) is stored as its state, a
    uint8 array, with `"generator"` naming its device type.  Multi-process
    shards come with ROADMAP A10."""
    from .core.selected_rows import SelectedRows

    if process_index not in (None, 0):
        raise NotImplementedError(
            f"save_sharded(process_index={process_index}): shards of several processes "
            "come with data parallelism (ROADMAP A10)")
    scope = scope or global_scope()
    if var_names is None:
        program = program or default_main_program()
        var_names = [v.name for v in _persistables(program)]
    os.makedirs(dirname, exist_ok=True)
    entries = []
    for name in var_names:
        v = scope.find_var(name)
        if v is None:
            raise KeyError(f"save_sharded: {name!r} not found in scope")
        safe = name.replace("/", "%2F")
        if isinstance(v, SelectedRows):
            rows_f, vals_f = f"{safe}.rows.p0s0.npy", f"{safe}.vals.p0s0.npy"
            save_array(os.path.join(dirname, rows_f), v.rows)
            stored_as = save_array(os.path.join(dirname, vals_f), v.values)
            rstamp = _integrity.stamp_file(os.path.join(dirname, rows_f))
            vstamp = _integrity.stamp_file(os.path.join(dirname, vals_f))
            entries.append({"name": name, "selected_rows": True, "height": int(v.height),
                            "global_shape": list(v.shape),
                            "dtype": "bfloat16" if stored_as else str(_host_array(v.values).dtype),
                            "spec": None,
                            "shards": [{"rows_file": rows_f, "values_file": vals_f,
                                        "stored_as": stored_as,
                                        "rows_sha256": rstamp["sha256"],
                                        "rows_bytes": rstamp["bytes"],
                                        "values_sha256": vstamp["sha256"],
                                        "values_bytes": vstamp["bytes"]}]})
            continue
        extra = {}
        if isinstance(v, torch.Generator):
            extra["generator"] = v.device.type
            v = v.get_state()
        fname = f"{safe}.p0s0.npy"
        arr = _host_array(v)
        stored_as = save_array(os.path.join(dirname, fname), v)
        entries.append({"name": name, "global_shape": list(arr.shape),
                        "dtype": "bfloat16" if stored_as else str(arr.dtype), "spec": None,
                        "shards": [{"file": fname, "index": _whole(arr.shape),
                                    "stored_as": stored_as,
                                    **_integrity.stamp_file(os.path.join(dirname, fname))}],
                        **extra})
    atomic_write(os.path.join(dirname, SHARDED_MANIFEST),
                 json.dumps({"vars": entries, "process": 0}, indent=1))
    return [e["name"] for e in entries]


def _read_region(name, shape, shards) -> np.ndarray:
    """The whole array from its shards (a multi-process save of the JAX
    package covers it with several), checking that they cover it."""
    out = covered = None
    for idx, mm in shards:
        sel = tuple(slice(a, b) for a, b in idx)
        if out is None:
            out = np.empty(shape, mm.dtype)
            covered = np.zeros(shape, bool)
        out[sel] = mm
        covered[sel] = True
    if out is None or not covered.all():
        raise ValueError(f"checkpoint shards do not fully cover {name} (missing shard files? "
                         f"partial multi-host save?)")
    return out


def _as_tensor(arr: np.ndarray, stored_as, device) -> torch.Tensor:
    if stored_as == "bfloat16_as_uint16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16).to(device)
    return to_tensor(np.array(arr), None, device)


def _restore_generator(scope: Scope, entry: dict, arr: np.ndarray, device):
    """`RNG_STATE_VAR` back into a torch generator on `device`: the scope's
    own generator takes the state in place (a captured CUDA graph keeps
    drawing from it).  A uint8 array is a torch generator's state.  A
    uint32 array is a JAX PRNG key, which no torch generator can continue:
    the generator is seeded from the key's 64 bits, deterministically,
    with a warning and the `checkpoint.rng_reseeded` counter (never the
    program's seed)."""
    from .errors import CheckpointError
    from .monitor import MONITOR as _MON

    gen = scope.find_var(RNG_STATE_VAR)
    if not isinstance(gen, torch.Generator) or gen.device != torch.device(device):
        gen = torch.Generator(device=device)
    if arr.dtype == np.uint8:
        try:
            gen.set_state(torch.from_numpy(np.array(arr)))
        except RuntimeError as e:
            raise CheckpointError(
                f"checkpoint var {RNG_STATE_VAR!r} holds the state of a torch generator on "
                f"{entry.get('generator', 'another device')!r} ({arr.size} bytes), which the "
                f"generator on {device} cannot take: {e}") from e
    elif arr.dtype == np.uint32 and arr.size == 2:
        k = [int(x) for x in np.asarray(arr).reshape(-1)]
        seed = (k[0] << 32) | k[1]
        gen.manual_seed(seed)
        _MON.counter("checkpoint.rng_reseeded").inc()
        _log.warning("checkpoint var %r is a JAX PRNG key %s: no torch generator can continue "
                     "its stream, so the generator is seeded with %d from it", RNG_STATE_VAR,
                     k, seed)
    else:
        raise CheckpointError(
            f"checkpoint var {RNG_STATE_VAR!r} is a {arr.dtype} array of shape {arr.shape}: "
            "neither a torch generator's state (uint8) nor a JAX PRNG key (2 x uint32)")
    scope.set_var(RNG_STATE_VAR, gen)


def load_sharded(dirname: str, var_names: Optional[Sequence[str]] = None,
                 scope: Optional[Scope] = None, mesh=None, row_shard: Optional[tuple] = None,
                 verify: Optional[bool] = None, device="cpu",
                 into_existing: bool = False) -> List[str]:
    """Restore a sharded checkpoint of either package onto `device`:
    every shard is verified against its stamp (FLAGS_integrity_verify_load)
    before any is read, shards are assembled on the host, and each var is
    set in `scope`.  With `into_existing`, a var the scope already holds as
    a tensor of the same shape and dtype is copied into that tensor (a
    captured CUDA graph keeps reading it).  A mesh, and a row shard of more
    than one rank, come with ROADMAP A10."""
    import glob as _glob

    from .core.selected_rows import SelectedRows

    if mesh is not None:
        raise NotImplementedError("load_sharded(mesh=...): sharded placement comes with data "
                                  "parallelism (ROADMAP A10)")
    if row_shard is not None and int(row_shard[1]) > 1:
        raise NotImplementedError(f"load_sharded(row_shard={row_shard}): re-dealing rows over "
                                  "several ranks comes with ROADMAP A10")
    scope = scope or global_scope()
    manifest = read_json(os.path.join(dirname, SHARDED_MANIFEST))
    by_name = {e["name"]: e for e in manifest["vars"]}
    for extra in sorted(_glob.glob(os.path.join(dirname, "__sharded_manifest__.p*.json"))):
        for e in read_json(extra)["vars"]:
            tgt = by_name.get(e["name"])
            if tgt is None:
                manifest["vars"].append(e)
                by_name[e["name"]] = e
                continue
            key = "rows_file" if e.get("selected_rows") else "index"
            have = {json.dumps(sh.get(key)) for sh in tgt["shards"]}
            tgt["shards"] += [sh for sh in e["shards"] if json.dumps(sh.get(key)) not in have]
    want = set(var_names) if var_names is not None else None
    verify = flags.flag("FLAGS_integrity_verify_load") if verify is None else bool(verify)
    loaded = []
    for entry in manifest["vars"]:
        name = entry["name"]
        if want is not None and name not in want:
            continue
        if entry.get("selected_rows"):
            rows, vals = [], []
            for sh in entry["shards"]:
                if verify:
                    _integrity.verify_file_entry(dirname, sh["rows_file"], sh.get("rows_sha256"),
                                                 sh.get("rows_bytes"))
                    _integrity.verify_file_entry(dirname, sh["values_file"],
                                                 sh.get("values_sha256"), sh.get("values_bytes"))
                rows.append(load_array(os.path.join(dirname, sh["rows_file"])))
                vals.append(_as_tensor(load_array(os.path.join(dirname, sh["values_file"])),
                                       sh.get("stored_as"), "cpu"))
            height = int(entry["height"])
            r = np.concatenate(rows)
            live = r != height  # the merge's parking row
            order = np.argsort(r[live], kind="stable")
            v = torch.cat(vals)[torch.from_numpy(np.flatnonzero(live)[order])]
            scope.set_var(name, SelectedRows(torch.from_numpy(r[live][order]).to(device),
                                             v.to(device), height))
            loaded.append(name)
            continue
        shape = tuple(entry["global_shape"])
        if verify:
            for sh in entry["shards"]:
                _integrity.verify_file_entry(dirname, sh["file"], sh.get("sha256"),
                                             sh.get("bytes"))
        arr = _read_region(name, shape, [(sh["index"], load_array(os.path.join(dirname, sh["file"])))
                                         for sh in entry["shards"]])
        stored_as = entry["shards"][0].get("stored_as")
        if name == RNG_STATE_VAR:
            _restore_generator(scope, entry, arr, device)
            loaded.append(name)
            continue
        t = _as_tensor(arr, stored_as, device)
        old = scope.find_var(name) if into_existing else None
        if (isinstance(old, torch.Tensor) and old.shape == t.shape and old.dtype == t.dtype
                and old.device == t.device):
            old.copy_(t)
        else:
            scope.set_var(name, t)
        loaded.append(name)
    if want is not None:
        missing = want - set(loaded)
        if missing:
            raise KeyError(f"load_sharded: checkpoint lacks {sorted(missing)}")
    return loaded


# --- stream-state serde -------------------------------------------------------
# Reader states (reader.py state_dict) are nested dicts that may hold
# non-JSON values (random.Random states); a RESUME.json sidecar stores them
# pickled and base64'd, byte-compatible with the JAX package's.

def pack_stream_state(state) -> str:
    """Pickle + base64 a reader state for embedding in a JSON sidecar."""
    import base64
    import pickle

    return base64.b64encode(pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)).decode("ascii")


def unpack_stream_state(packed: str):
    """Inverse of pack_stream_state."""
    import base64
    import pickle

    return pickle.loads(base64.b64decode(packed.encode("ascii")))


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
    atomic_write(os.path.join(dirname, MODEL_FILENAME), json.dumps(doc))
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


# --- int8 quantized inference models ---------------------------------------

def save_quantized_inference_model(dirname: str, feeded_var_names: Sequence[str],
                                   target_vars: Sequence[Variable], executor,
                                   main_program: Optional[Program] = None,
                                   scope: Optional[Scope] = None, weight_bits: int = 8,
                                   serve_dtype: Optional[str] = None):
    """save_inference_model with int8 weight storage.  A QAT-instrumented
    program is frozen (slim.convert_quant_model: per-tensor or per-channel
    scales); a float program gets per-tensor post-training scales.  Each
    quantized weight is stored as an int8 `.npy` (its digest re-stamped in
    `__manifest__.json`) with its scale, axis, bits and serve dtype in
    `__quant__.json`; `load_vars` dequantizes it into that dtype (the
    weight's own, or `serve_dtype`, e.g. "bfloat16"), so the served program
    computes in float on values that lie on the int8 grid.  No int8
    product runs, as in the JAX package.

    The scope is left as it was: the freeze snaps weights by putting new
    tensors into it, and the snapshot taken first is put back by reference
    afterwards, with the shadows a child scope got of its parent's
    parameters erased."""
    from .contrib.slim.quantization import convert_quant_model, post_training_quantize

    program = main_program or default_main_program()
    scope = scope or global_scope()
    work = program.clone()
    snapshot = {n: scope.find_var(n) for n in scope.local_var_names()}
    try:
        manifest = convert_quant_model(work, scope, weight_bits=weight_bits)
        if not manifest["weights"]:
            # a float program: per-tensor post-training scales
            manifest["weights"] = {
                name: {"scale": np.float32(scale), "axis": None}
                for name, scale in post_training_quantize(
                    scope, work, weight_bits=weight_bits).items()}
        fetch = save_inference_model(dirname, feeded_var_names, target_vars,
                                     executor, work, scope)
        # the int8 payloads over the float files, with the scale sidecar
        qmax = float(2 ** (weight_bits - 1) - 1)
        qrec = {}
        for wname, rec in manifest["weights"].items():
            w = to_numpy(scope.find_var(wname))
            scale_arr = np.asarray(rec["scale"], np.float32)
            axis = rec["axis"]
            shp = [1] * w.ndim
            if axis is not None:
                shp[axis] = -1
            q = np.clip(np.round(w / scale_arr.reshape(shp) * qmax),
                        -qmax - 1, qmax).astype(np.int8)
            fname = wname.replace("/", "%2F") + ".npy"
            save_array(os.path.join(dirname, fname), q)
            qrec[wname] = {"scale": scale_arr.tolist(), "axis": axis,
                           "bits": weight_bits,
                           "dtype": serve_dtype or str(w.dtype)}
        if qrec:
            # the files save_vars stamped as floats hold int8 now
            mpath = os.path.join(dirname, MANIFEST)
            man = read_json(mpath)
            overwritten = {w.replace("/", "%2F") + ".npy" for w in qrec}
            for entry in man["vars"]:
                if entry["file"] in overwritten:
                    entry.update(_integrity.stamp_file(
                        os.path.join(dirname, entry["file"])))
            atomic_write(mpath, json.dumps(man, indent=1))
        atomic_write(os.path.join(dirname, QUANT_MANIFEST),
                     json.dumps({"weights": qrec,
                                 "activations": manifest["activations"]},
                                indent=1))
        return fetch
    finally:
        scope.erase(set(scope.local_var_names()) - set(snapshot))
        for n, v in snapshot.items():
            scope.set_var(n, v)
