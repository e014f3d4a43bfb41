"""Build and bind the port's hand-written CUDA kernels.

Every source under `csrc/` (`*.cu`, a plain C interface each) is compiled
by nvcc for sm_90a into its own shared library under `build/kernels/`,
named by a hash of the source and the flags, so an edit to either rebuilds
it. The first `bind` builds whatever is missing, every source at once in
parallel nvcc runs, and loads every library: so whichever wrapper binds
first (a benchmark's set-up warms the matcher) pays the only build, and
later wrappers only look their entry point up. Only a machine with a card
and nvcc builds; the CPU paths never get here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


def sources() -> list:
    """The CUDA sources of the port, file names under csrc/, sorted."""
    return sorted(f for f in os.listdir(_CSRC) if f.endswith(".cu"))


def _library_path(source: str) -> str:
    with open(os.path.join(_CSRC, source), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"lib{os.path.splitext(source)[0]}_{digest}.so")


def build_libraries(verbose: bool = False) -> dict:
    """Compile every source that has no library yet; the nvcc runs start
    together. Returns {source: library path}."""
    paths = {src: _library_path(src) for src in sources()}
    running = []
    for src, path in paths.items():
        if os.path.exists(path):
            continue
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp,
               os.path.join(_CSRC, src)]
        running.append((src, tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, tmp, path, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(err, flush=True)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def bind(source: str, entry: str, argtypes: list):
    """The C entry point `entry` of csrc/`source`, returning a CUDA error
    code; the first call builds and loads every library."""
    if not _libs:
        _libs.update({src: ctypes.CDLL(path) for src, path in build_libraries().items()})
    fn = getattr(_libs[source], entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
