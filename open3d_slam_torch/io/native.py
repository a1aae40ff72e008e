"""ctypes bindings for the native C++ IO runtime (native/).

Builds ``libo3dslam_io.so`` on first use via make (g++); all callers fall
back to the pure-NumPy paths if the toolchain or build is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libo3dslam_io.so")
_lock = threading.Lock()
_lib = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(["make", "-C", _NATIVE_DIR, "-s"],
                               check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(_LIB_PATH)
            lib.pcd_read.restype = ctypes.c_int64
            lib.pcd_read.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                     ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                     ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
            lib.pcd_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.pcd_write.restype = ctypes.c_int
            lib.pcd_write.argtypes = [ctypes.c_char_p] + \
                [ctypes.POINTER(ctypes.c_float)] * 3 + [ctypes.c_int64]
            lib.seq_open.restype = ctypes.c_void_p
            lib.seq_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.seq_num_scans.restype = ctypes.c_int64
            lib.seq_num_scans.argtypes = [ctypes.c_void_p]
            lib.seq_next.restype = ctypes.c_int64
            lib.seq_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                     ctypes.POINTER(ctypes.c_double)]
            lib.seq_free_scan.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.seq_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def read_pcd_native(path: str):
    """Binary PCD via C++; returns dict or None (fallback needed)."""
    lib = load()
    if lib is None:
        return None
    xyz_p = ctypes.POINTER(ctypes.c_float)()
    nrm_p = ctypes.POINTER(ctypes.c_float)()
    rgb_p = ctypes.POINTER(ctypes.c_float)()
    n = lib.pcd_read(path.encode(), ctypes.byref(xyz_p),
                     ctypes.byref(nrm_p), ctypes.byref(rgb_p))
    if n < 0:
        return None
    out = {}
    try:
        out["points"] = np.ctypeslib.as_array(xyz_p, shape=(n, 3)).copy()
        if nrm_p:
            out["normals"] = np.ctypeslib.as_array(nrm_p, shape=(n, 3)).copy()
        if rgb_p:
            out["colors"] = np.ctypeslib.as_array(rgb_p, shape=(n, 3)).copy()
    finally:
        if xyz_p:
            lib.pcd_free(xyz_p)
        if nrm_p:
            lib.pcd_free(nrm_p)
        if rgb_p:
            lib.pcd_free(rgb_p)
    return out


def write_pcd_native(path: str, points: np.ndarray,
                     normals: Optional[np.ndarray] = None,
                     colors: Optional[np.ndarray] = None) -> bool:
    lib = load()
    if lib is None:
        return False
    pts = np.ascontiguousarray(points, np.float32)
    n = pts.shape[0]

    def as_p(a):
        if a is None:
            return ctypes.POINTER(ctypes.c_float)()
        a = np.ascontiguousarray(a, np.float32)
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), a

    nrm = None if normals is None or not len(normals) else np.ascontiguousarray(normals, np.float32)
    col = None if colors is None or not len(colors) else np.ascontiguousarray(colors, np.float32)
    rc = lib.pcd_write(
        path.encode(),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nrm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) if nrm is not None else ctypes.POINTER(ctypes.c_float)(),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) if col is not None else ctypes.POINTER(ctypes.c_float)(),
        n)
    return rc == 0


class NativeSequenceReader:
    """Prefetching reader over a directory of .pcd scans (C++ thread)."""

    def __init__(self, folder: str, capacity: int = 4):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.seq_open(folder.encode(), capacity)
        if not self._h:
            raise FileNotFoundError(folder)

    def __len__(self):
        return int(self._lib.seq_num_scans(self._h))

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, float]:
        xyz_p = ctypes.POINTER(ctypes.c_float)()
        ts = ctypes.c_double()
        n = self._lib.seq_next(self._h, ctypes.byref(xyz_p), ctypes.byref(ts))
        if n <= 0:
            raise StopIteration
        try:
            pts = np.ctypeslib.as_array(xyz_p, shape=(n, 3)).copy()
        finally:
            self._lib.seq_free_scan(xyz_p)
        return pts, float(ts.value)

    def close(self):
        if self._h:
            self._lib.seq_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
