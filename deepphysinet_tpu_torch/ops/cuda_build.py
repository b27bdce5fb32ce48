"""Compile the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is built into its own
shared library under ``csrc/build/`` (listed in ``.gitignore``) at first use,
and again whenever the source is newer than the library.  Nothing is built at
import time, and nothing here runs on a machine without a GPU.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict

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


def load_library(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and return the loaded library."""
    with _LOCK:
        src = os.path.join(CSRC_DIR, source)
        so = os.path.join(BUILD_DIR, os.path.splitext(source)[0] + ".so")
        if not (os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {res.returncode}) on {source}:\n"
                                   f"{res.stdout[-2000:]}{res.stderr[-6000:]}")
            BUILD_LOGS[source] = res.stdout + res.stderr
            os.replace(tmp, so)
        return ctypes.CDLL(so)
