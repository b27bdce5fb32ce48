"""Compile the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is built into its own
shared library under ``csrc/build/`` (listed in ``.gitignore``) at first use,
and again whenever the source or a shared header (``csrc/*.cuh``) is newer
than the library.  ``build_libraries`` builds several sources at once.  Nothing is built at
import time, and nothing here runs on a machine without a GPU.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
# sm_90a, not sm_90: later kernels use wgmma / setmaxnreg, which exist only there
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
# ptxas report (registers, shared memory, spills) of each build in this process
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _paths(source: str):
    return (os.path.join(CSRC_DIR, source),
            os.path.join(BUILD_DIR, os.path.splitext(source)[0] + ".so"))


def _stale(src: str, so: str) -> bool:
    """True when the library is missing or older than its source or a shared header."""
    if not os.path.exists(so):
        return True
    deps = [src] + [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def _build(source: str) -> None:
    src, so = _paths(source)
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {res.returncode}) on {source}:\n"
                           f"{res.stdout[-2000:]}{res.stderr[-6000:]}")
    BUILD_LOGS[source] = res.stdout + res.stderr
    os.replace(tmp, so)


def build_libraries(sources: Sequence[str]) -> None:
    """Build every stale ``csrc/<source>``, one nvcc per source, all started together."""
    with _LOCK:
        todo = [s for s in sources if _stale(*_paths(s))]
        if not todo:
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
            for done in [pool.submit(_build, s) for s in todo]:
                done.result()


def load_library(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and return the loaded library."""
    build_libraries([source])
    return ctypes.CDLL(_paths(source)[1])
