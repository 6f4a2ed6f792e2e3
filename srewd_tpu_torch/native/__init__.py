"""The native .npy batch reader (copy of srewd_tpu/native), loaded with ctypes.

`read_batch` is the bulk path of WeatherStore.read_many: the fastnpy shared
library preads all files of a batch into one buffer in parallel C++ threads
(the ctypes call releases the GIL). The library is compiled on first use
with the system C++ compiler into `build/srewd_tpu_torch/` beside the
package (gitignored), under a name that carries a hash of the source, so an
edited source is rebuilt. If no compiler is there, or a file is one the
reader does not take, callers read with numpy instead: the values are the
same, only the speed differs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastnpy.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "srewd_tpu_torch")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libfastnpy_{h.hexdigest()[:16]}.so")


def _compile(lib_path: str) -> bool:
    """Build the library with the first C++ compiler found; atomic rename."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    for cxx in ("c++", "g++", "clang++"):
        with tempfile.NamedTemporaryFile(suffix=".so", dir=_BUILD_DIR, delete=False) as tmp:
            tmp_path = tmp.name
        try:
            proc = subprocess.run([cxx, *_FLAGS, _SRC, "-o", tmp_path],
                                  capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            os.unlink(tmp_path)
            continue
        if proc.returncode == 0:
            os.replace(tmp_path, lib_path)
            return True
        os.unlink(tmp_path)
    return False


def get_lib():
    """The loaded fastnpy library, or None if it cannot be built here."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        lib_path = _lib_path()
        if not os.path.exists(lib_path) and not _compile(lib_path):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            _lib_failed = True
            return None
        lib.fastnpy_read_batch.restype = ctypes.c_int
        lib.fastnpy_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ]
        lib.fastnpy_version.restype = ctypes.c_int
        if lib.fastnpy_version() != 1:
            raise RuntimeError(f"fastnpy ABI mismatch in {lib_path}")
        _lib = lib
        return _lib


def read_batch(paths: list[str], item_shape: tuple, threads: int = 8) -> np.ndarray | None:
    """Read `paths` into one [N, *item_shape] float32 array, or None when the
    library is missing or a file is one it does not take (dtype, order,
    truncation): the caller then reads with numpy."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    n = len(paths)
    out = np.empty((n,) + tuple(item_shape), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.fastnpy_read_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(np.prod(item_shape)), int(threads),
    )
    return out if rc == 0 else None
