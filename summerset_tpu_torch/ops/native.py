"""Build and load the port's native libraries: each is a shared library
with a plain C interface, loaded with ``ctypes``.  The CUDA kernels are
built from ``summerset_tpu_torch/csrc/<name>.cu`` with ``nvcc``; the host
C++ code (the native WAL, ``csrc/wal.cpp``) from ``csrc/<name>.cpp`` with
``g++`` and the flags of ``summerset_tpu/native/Makefile``.

Each library is built at first use into ``summerset_tpu_torch/_build/``
(listed in ``.gitignore``), under a file name that carries a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: per library: seconds the last build took here (0.0 when loaded as built)
build_seconds: Dict[str, float] = {}
#: per library: the compiler's report (ptxas registers / shared memory)
build_log: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def find_cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++) found for the native WAL")


def _source(name: str) -> str:
    """``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host)."""
    cu = os.path.join(CSRC_DIR, name + ".cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC_DIR,
                                                       name + ".cpp")


def _lib_path(name: str) -> str:
    src = _source(name)
    flags = NVCC_FLAGS if src.endswith(".cu") else CXX_FLAGS
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (g++)
    unless an up-to-date build exists; returns the library path."""
    path = _lib_path(name)
    if os.path.exists(path):
        build_seconds.setdefault(name, 0.0)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    src = _source(name)
    if src.endswith(".cu"):
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    else:
        cmd = [find_cxx(), *CXX_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed for "
            f"{os.path.basename(src)} (rc {proc.returncode}):\n"
            f"{build_log[name]}"
        )
    os.replace(tmp, path)
    return path


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name`` once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
