"""ctypes binding of the C++ host kernels of ``native/src/dpn_native.cc``.

Counterpart of ``deepphysinet_tpu/native/__init__.py``: the two entry points the port's data
layer calls, ``trilinear`` (``data/dataset.py``) and ``lzw_decode`` (``data/geotiff.py``), and the
row helpers ``gather`` and ``pack_tokens``, with the same numpy / Python fallbacks, so the host
data layer runs where no compiler exists.  The library
is built at first use with the local g++ (as the JAX package builds it: ``-O3 -march=native
-fopenmp``, then without OpenMP and ``-march``) into ``csrc/build/libdpn_native.so`` of this
package, which ``.gitignore`` lists, and again whenever the source is newer; the library that the
JAX package keeps beside the source is never written.
``available()`` says whether the library loaded, ``library_path()`` where it lies, and
``BUILD_ERROR`` why it did not build.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
BUILD_ERROR = ""  # the compilers' last complaint when no library could be built

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "src", "dpn_native.cc")
_SO = os.path.join(_PKG, "csrc", "build", "libdpn_native.so")


def library_path() -> str:
    return _SO


def _build() -> Optional[str]:
    global BUILD_ERROR
    if not os.path.exists(_SRC):
        BUILD_ERROR = f"{_SRC} is missing"
        return None
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"  # one writer's file, renamed into place whole
    for cc in ("g++", "c++", "clang++"):
        for flags in (["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"], ["-O3", "-shared", "-fPIC"]):
            try:
                r = subprocess.run([cc, *flags, _SRC, "-o", tmp], capture_output=True, text=True, timeout=120)
            except (FileNotFoundError, subprocess.TimeoutExpired) as e:
                BUILD_ERROR = f"{cc}: {e!r}"
                break
            if r.returncode == 0:
                os.replace(tmp, _SO)
                return _SO
            BUILD_ERROR = f"{cc} {' '.join(flags)}: {r.stderr[-2000:]}"
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        i64, f32p, f64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
        lib.dpn_trilinear.argtypes = [f32p] + [i64] * 4 + [ctypes.c_double] * 6 + [f64p, f64p, f64p, i64, f32p]
        lib.dpn_trilinear.restype = None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.dpn_lzw_decode.argtypes = [u8p, i64, u8p, i64]
        lib.dpn_lzw_decode.restype = i64
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.dpn_gather.argtypes = [f32p, i64, i64, i64p, i64p, i64, f32p]
        lib.dpn_gather.restype = None
        lib.dpn_pack_tokens.argtypes = [f32p, i64, i64, i64, f32p, f32p, f32p]
        lib.dpn_pack_tokens.restype = None
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _fp32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def trilinear(cube: np.ndarray, lon: np.ndarray, lat: np.ndarray, t: np.ndarray,
              lon0: float, dlon: float, lat0: float, dlat: float,
              t0: float = 0.0, dt: float = 6.0) -> np.ndarray:
    """[V, H, W, T] cube at N scattered points -> [N, V]."""
    lib = _load()
    cube = np.ascontiguousarray(cube, np.float32)
    V, H, W, T = cube.shape
    lon = np.ascontiguousarray(lon, np.float64)
    lat = np.ascontiguousarray(lat, np.float64)
    t = np.ascontiguousarray(t, np.float64)
    n = len(lon)
    if lib is None:  # numpy fallback
        from deepphysinet_tpu_torch.data.dataset import _np_trilinear

        lat_g = lat0 + np.arange(H) * dlat
        lon_g = lon0 + np.arange(W) * dlon
        th = t0 + np.arange(T) * dt
        cols = [_np_trilinear(cube[v], lat_g, lon_g, th, lat, lon, t) for v in range(V)]
        return np.stack(cols, axis=-1).astype(np.float32)
    out = np.empty((n, V), np.float32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.dpn_trilinear(_fp32(cube), V, H, W, T, lon0, dlon, lat0, dlat, t0, dt,
                      lon.ctypes.data_as(f64p), lat.ctypes.data_as(f64p), t.ctypes.data_as(f64p), n, _fp32(out))
    return out


def gather(img: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """``img[y, x]`` of a [H, W] raster at N integer points, each index clipped to the raster."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    xs = np.ascontiguousarray(xs, np.int64)
    ys = np.ascontiguousarray(ys, np.int64)
    if lib is None:
        return img[np.clip(ys, 0, img.shape[0] - 1), np.clip(xs, 0, img.shape[1] - 1)]
    out = np.empty(len(xs), np.float32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.dpn_gather(_fp32(img), img.shape[0], img.shape[1], xs.ctypes.data_as(i64p),
                   ys.ctypes.data_as(i64p), len(xs), _fp32(out))
    return out


def pack_tokens(raster: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """[H, W, C] raster -> normalized [C, H*W] token rows."""
    lib = _load()
    raster = np.ascontiguousarray(raster, np.float32)
    h, w, c = raster.shape
    mean = np.ascontiguousarray(np.broadcast_to(mean, (c,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (c,)), np.float32)
    if lib is None:
        return ((raster.reshape(-1, c).T - mean[:, None]) / std[:, None]).astype(np.float32)
    out = np.empty((c, h * w), np.float32)
    lib.dpn_pack_tokens(_fp32(raster), h, w, c, _fp32(mean), _fp32(std), _fp32(out))
    return out


def lzw_decode(data: bytes, expected_size: int) -> Optional[bytes]:
    """TIFF LZW decode of one segment through the C++ kernel; None: the caller takes its Python path.

    ``expected_size`` bounds the output buffer (the segment's byte size is known from the TIFF
    tags); decodes shorter than the bound are valid (writers may truncate the final segment)."""
    lib = _load()
    if lib is None:
        return None
    inp = np.frombuffer(data, np.uint8)
    out = np.empty(int(expected_size), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.dpn_lzw_decode(inp.ctypes.data_as(u8p), len(inp), out.ctypes.data_as(u8p), len(out))
    if n < 0:
        return None
    return out[:n].tobytes()
