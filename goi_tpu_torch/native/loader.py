"""Build and bind the native COLMAP parser (ctypes, no pybind11).

Counterpart of goi_tpu/native/loader.py. The port's own copy of the
parser, colmap_native.cpp beside this file, is compiled with g++ on
first use into `build/goi_tpu_torch/` at the root of the checkout (the
directory of the CUDA kernels' libraries), named by a hash of the
source; when it cannot be built or loaded, the readers fall back to the
pure-Python parsers of data/colmap.py. This is a host parser: nothing
here touches the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "colmap_native.cpp"
BUILD = Path(__file__).resolve().parents[2] / "build" / "goi_tpu_torch"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD / f"colmap_native_{digest}.so"


def _build() -> Optional[ctypes.CDLL]:
    so_path = _lib_path()
    if not so_path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, so_path)
        except (subprocess.SubprocessError, OSError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    lib.colmap_points3d_parse.restype = ctypes.c_longlong
    lib.colmap_points3d_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong]
    lib.colmap_images_parse.restype = ctypes.c_longlong
    lib.colmap_images_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build()
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def read_points3d_binary_native(path: str
                                ) -> Optional[Tuple[np.ndarray,
                                                    np.ndarray,
                                                    np.ndarray]]:
    """(xyz (N, 3) f64, rgb (N, 3) u8, errors (N,) f64) as
    data/colmap.py's read_points3d_binary, or None without the parser.
    xyz and errors pass through float32, as the JAX package's."""
    lib = _get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    n = lib.colmap_points3d_parse(data, len(data), None, None, None, 0)
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float32)
    got = lib.colmap_points3d_parse(data, len(data), _ptr(xyz), _ptr(rgb),
                                    _ptr(err), n)
    if got != n:
        return None
    return xyz.astype(np.float64), rgb, err.astype(np.float64)


def read_images_binary_native(path: str):
    """dict[id] -> ColmapImage without the 2D point payloads, which the
    pipeline never uses (cameras need only pose and name); None without
    the parser."""
    lib = _get_lib()
    if lib is None:
        return None
    from goi_tpu_torch.data.colmap import ColmapImage

    with open(path, "rb") as f:
        data = f.read()
    n = lib.colmap_images_parse(data, len(data), None, None, None, None,
                                None, None, 0)
    if n < 0:
        return None
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    iid = np.empty((n,), np.int32)
    cid = np.empty((n,), np.int32)
    noff = np.empty((n,), np.int64)
    nlen = np.empty((n,), np.int64)
    got = lib.colmap_images_parse(data, len(data), _ptr(qvec), _ptr(tvec),
                                  _ptr(iid), _ptr(cid), _ptr(noff),
                                  _ptr(nlen), n)
    if got != n:
        return None
    out = {}
    empty = np.zeros((0, 2))
    empty_ids = np.zeros((0,), np.int64)
    for i in range(n):
        name = data[noff[i]:noff[i] + nlen[i]].decode("utf-8")
        out[int(iid[i])] = ColmapImage(
            int(iid[i]), qvec[i], tvec[i], int(cid[i]), name,
            empty, empty_ids)
    return out
