"""Build and load the port's CUDA kernels.

The sources in `csrc/` compile with `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface,
`_build/libpaddle_tpu_torch_kernels.<digest>.so`, which `ctypes` loads.  The
file is named by the hash of the sources (and of the compiler flags), so it
is up to date exactly when it exists: it is built at first use and again
when the hash changes; each `.cu` compiles in its own `nvcc` process, all
started together.  Processes that load the library at once (the replicas
of a serving fleet) take an `flock` on `_build/build.lock` around the check
and the build, so one of them runs nvcc and the others load its library.
A build that fails raises: there is no fallback.

Nothing here runs at import time, so the CPU-only tests can import every
module of the package.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PREFIX = "libpaddle_tpu_torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_D = ctypes.c_double
# C entry point -> (argtypes, restype)
SIGNATURES = {
    "ptt_ln_residual_fwd": ([_P, _P, _P, _P, _P, _L, _I, _F, _I, _P], _I),
    "ptt_ln_residual_bwd": ([_P, _P, _P, _P, _P, _P, _P, _L, _I, _F, _I, _I, _P], _I),
    "ptt_bias_act_fwd": ([_P, _P, _P, _L, _I, _I, _I, _P], _I),
    "ptt_bias_act_bwd": ([_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P], _I),
    "ptt_softmax_xent_fwd": ([_P, _P, _P, _P, _L, _I, _I, _I, _P], _I),
    "ptt_softmax_xent_bwd": ([_P, _P, _P, _P, _P, _L, _I, _I, _I, _P], _I),
    "ptt_adam": ([_P, _P, _P, _P, _P, _P, _L, _D, _D, _F, _I, _I, _I, _P], _I),
    "ptt_bn_epilogue_fwd": ([_P, _P, _P, _P, _L, _I, _I, _I, _P], _I),
    "ptt_bn_epilogue_bwd": ([_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P], _I),
    "ptt_attention_fwd": ([_P] * 7 + [_I] * 6 + [_F, _I, _I, _I, _P], _I),
    "ptt_attention_bwd_dq": ([_P] * 10 + [_I] * 6 + [_F, _I, _I, _I, _P], _I),
    "ptt_attention_bwd_dkv": ([_P] * 10 + [_I] * 6 + [_F, _I, _I, _I, _P], _I),
    "ptt_attention_occupancy": ([_I, _I, _I, _I, _P], _I),
    "ptt_attention_fwd_bs_plan": ([_I, _I, _P], _I),
    "ptt_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def source_hash() -> str:
    """sha256 over every source file (name and bytes) and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def lib_path(digest: str) -> str:
    """Where the library of the sources with hash `digest` lives."""
    return os.path.join(BUILD_DIR, f"{LIB_PREFIX}.{digest[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
                       "kernels of paddle_tpu_torch cannot be built")


def build() -> Dict[str, object]:
    """Compile every `csrc/*.cu` in parallel and link the shared library.

    Returns {"path", "seconds", "log"}: `log` holds nvcc's output, with the
    `-Xptxas -v` register and shared-memory lines of every kernel."""
    nvcc = _nvcc()
    digest = source_hash()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
    try:
        srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        procs = []
        for src in srcs:
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode != 0:
                failed.append(os.path.basename(src))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", tmp_lib, *[o for _, o, _ in procs]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        path = lib_path(digest)
        os.replace(tmp_lib, path)  # atomic: a loader sees the whole library or none
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"path": path, "seconds": time.perf_counter() - t0, "log": "\n".join(log)}


def ensure_built() -> str:
    """The path of the library of the current sources, built first if it
    does not exist.  The check and the build hold an exclusive `flock` on
    `BUILD_DIR/build.lock`: of processes that call this at once, the first
    builds and the others wait for it and find the library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = lib_path(source_hash())
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not os.path.exists(path):
            path = build()["path"]
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or out of date."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(ensure_built())
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def call(entry: str, *args) -> None:
    """Call a kernel entry point; raise if it reports a CUDA error."""
    lib = library()
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = lib.ptt_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")
