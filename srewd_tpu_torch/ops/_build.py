"""Build the port's CUDA sources with nvcc and load them with ctypes.

Route (b) of the port's kernel rules: `nvcc` compiles `csrc/<name>.cu` into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes), and ctypes loads it. The build runs on first
use, into `build/srewd_tpu_torch/` beside the package (gitignored), and the
library's name carries a hash of the source, of every header in `csrc/` and
of the flags, so an edited source or header is rebuilt and a stale library
is never loaded. A failed build raises with nvcc's stderr. `build_all`
starts one nvcc per source at once, so the sources build in parallel, and
keeps each one's seconds in `BUILD_SECONDS`.

nvcc runs with `-Xptxas -v`; its report (registers, shared memory and spill
bytes of every kernel instantiation) is kept beside the library as
`<library>.ptxas.txt` and read back by `ptxas_report`. `sass_mma_counts`
counts the tensor-core instructions of each kernel in the built library's
SASS, where `cuobjdump` can be found: HGMMA (warpgroup MMA, wgmma) and
HMMA (warp MMA, mma.sync), parsed by `parse_sass_mma`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "srewd_tpu_torch")
SOURCES = ("flash_attention", "flash_attention_bwd", "gn_swish", "conv3x3")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
BUILD_SECONDS: dict = {}  # {source: nvcc's seconds} of the last build_all, 0.0 if built before


def _find(tool: str):
    """A CUDA toolkit program, on PATH or in the toolkit's bin/; None if absent."""
    for cand in (shutil.which(tool), os.path.join("/usr/local/cuda/bin", tool)):
        if cand and os.path.exists(cand):
            return cand
    return None


def _nvcc() -> str:
    path = _find("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")
    return path


def _paths(name: str) -> tuple:
    """(source, library path) of csrc/<name>.cu; the hash covers the source,
    every csrc/*.cuh header and the flags."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
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


def _finish(name: str, job, out: str = None, err: str = None) -> None:
    if job is None:
        return
    proc, tmp, lib_path = job
    if out is None:
        out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}:\n{err}")
    with open(f"{lib_path}.ptxas.txt", "w") as f:
        f.write(out + err)
    os.replace(tmp, lib_path)


def build_all(names=SOURCES) -> None:
    """Build every named source, all nvcc processes running at once; each
    one's seconds go into BUILD_SECONDS."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in names}
    done = {}

    def wait(name, job):
        out, err = job[0].communicate()
        done[name] = (out, err, time.perf_counter() - t0)

    threads = [threading.Thread(target=wait, args=(name, job), daemon=True)
               for name, job in jobs.items() if job is not None]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        BUILD_SECONDS.clear()
        for name, job in jobs.items():
            out, err, sec = done.get(name, (None, None, 0.0))
            BUILD_SECONDS[name] = sec
            _finish(name, job, out, err)
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


def _demangle(names: list) -> dict:
    """{mangled: readable} through cu++filt / c++filt where one is found."""
    tool = _find("cu++filt") or _find("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def parse_ptxas(text: str) -> list:
    """[{kernel, registers, smem_static, spill_stores, spill_loads, stack}] from
    the text of `nvcc -Xptxas -v` (mangled kernel names)."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "smem_static": 0,
                   "spill_stores": None, "spill_loads": None, "stack": None}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_static"] = int(s.group(1)) if s else 0
    return rows


def ptxas_report(name: str) -> list:
    """parse_ptxas of csrc/<name>.cu's kept report (build first), with each
    kernel's readable name beside the mangled one."""
    with open(f"{_paths(name)[1]}.ptxas.txt") as f:
        rows = parse_ptxas(f.read())
    readable = _demangle([r["kernel"] for r in rows])
    for r in rows:
        r["name"] = readable[r["kernel"]]
    return rows


def _cuobjdump():
    """The toolkit's cuobjdump, else the copy Triton's package carries; None if absent."""
    tool = _find("cuobjdump")
    spec = importlib.util.find_spec("triton")
    if tool is None and spec is not None and spec.submodule_search_locations:
        cand = os.path.join(list(spec.submodule_search_locations)[0], "backends", "nvidia",
                            "bin", "cuobjdump")
        tool = cand if os.path.exists(cand) else None
    return tool


def parse_sass_mma(text: str) -> dict:
    """{mangled kernel: {"hgmma": n, "hmma": m}} from the text of `cuobjdump
    -sass`: the warpgroup (HGMMA, wgmma) and warp (HMMA, mma.sync)
    tensor-core instructions of each function."""
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), {"hgmma": 0, "hmma": 0})
        elif cur is not None:
            if re.search(r"\bHGMMA\b", line):
                cur["hgmma"] += 1
            elif re.search(r"\bHMMA\b", line):
                cur["hmma"] += 1
    return counts


def sass_mma_counts(name: str):
    """parse_sass_mma of the built csrc/<name>.cu's SASS, or None where no
    cuobjdump is found."""
    tool = _cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", _paths(name)[1]], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return parse_sass_mma(sass)
