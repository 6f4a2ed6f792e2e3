"""Build the port's CUDA sources with nvcc and load them with ctypes.

Route (b) of the port's kernel rules: `nvcc` compiles `csrc/<name>.cu` into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes), and ctypes loads it. The build runs on first
use, into `build/srewd_tpu_torch/` beside the package (gitignored), and the
library's name carries a hash of the source and flags, so an edited source
is rebuilt and a stale library is never loaded. A failed build raises with
nvcc's stderr. `build_all` starts one nvcc per source at once, so the
sources build in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "srewd_tpu_torch")
SOURCES = ("flash_attention", "flash_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


def _paths(name: str) -> tuple:
    """(source, library path) of csrc/<name>.cu."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for csrc/<name>.cu; None if its library is already built."""
    src, lib_path = _paths(name)
    if os.path.exists(lib_path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, lib_path


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, lib_path = job
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}:\n{err}")
    os.replace(tmp, lib_path)


def build_all(names=SOURCES) -> None:
    """Build every named source, all nvcc processes running at once."""
    jobs = {name: _start(name) for name in names}
    try:
        for name, job in jobs.items():
            _finish(name, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()


def build(name: str) -> str:
    """Compile csrc/<name>.cu (if not built yet) and return the library path."""
    _finish(name, _start(name))
    return _paths(name)[1]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
