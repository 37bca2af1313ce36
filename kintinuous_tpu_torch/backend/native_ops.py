"""ctypes bindings for the native cloud ops (native/cloud_ops.cpp), the
port's own copy of kintinuous_tpu/backend/native_ops.py's loader.

The library is built from native/cloud_ops.cpp by `make -C native` at
first use when it is missing. The build and the load hold an exclusive
lock on native/.libcloud_ops.lock, so a process of this package never
loads the file while another of them is still writing it (parallel test
workers build at once). Without it (no compiler, a failed build) every
function returns None and the slice processor takes its numpy/scipy
path.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

NATIVE = Path(__file__).resolve().parents[2] / "native"


class _Loader:
    """Finds (building if needed) and loads the library once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tried = False
        self._lib = None

    def get(self):
        with self._lock:
            if not self._tried:
                self._tried = True
                self._lib = self._load()
            return self._lib

    @staticmethod
    def _load():
        path = NATIVE / "libcloud_ops.so"
        try:
            with open(NATIVE / ".libcloud_ops.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
                if not path.exists():
                    subprocess.run(["make", "-C", str(NATIVE), "libcloud_ops.so"],
                                   check=True, capture_output=True, timeout=120)
                lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            return None
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cloud_voxel_downsample.restype = I
        lib.cloud_voxel_downsample.argtypes = [P, P, P, I, F, P, P, P]
        lib.cloud_estimate_normals.restype = None
        lib.cloud_estimate_normals.argtypes = [P, I, I, F, P, P]
        return lib


_LOADER = _Loader()


def available() -> bool:
    return _LOADER.get() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


def voxel_downsample(points: np.ndarray, colors: Optional[np.ndarray],
                     weights: Optional[np.ndarray], leaf: float) -> Optional[Tuple]:
    """Mean point (and colour, weight) of each leaf-sized voxel cell;
    None without the library or points."""
    lib = _LOADER.get()
    if lib is None or len(points) == 0:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    cols = np.ascontiguousarray(colors, np.uint8) if colors is not None else None
    wgts = np.ascontiguousarray(weights, np.float32) if weights is not None else None
    out_p = np.empty((n, 3), np.float32)
    out_c = np.empty((n, 3), np.uint8) if cols is not None else None
    out_w = np.empty((n,), np.float32) if wgts is not None else None
    m = lib.cloud_voxel_downsample(_ptr(pts), _ptr(cols), _ptr(wgts), n,
                                   ctypes.c_float(leaf), _ptr(out_p), _ptr(out_c),
                                   _ptr(out_w))
    return (out_p[:m].copy(),
            out_c[:m].copy() if out_c is not None else None,
            out_w[:m].copy() if out_w is not None else None)


def estimate_normals(points: np.ndarray, k: int, cell: float,
                     viewpoint: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """k-nearest-neighbour PCA normals (neighbours searched in a grid of
    `cell`), flipped towards the viewpoint; None without the library."""
    lib = _LOADER.get()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    out = np.empty((n, 3), np.float32)
    if n == 0:
        return out
    vp = np.ascontiguousarray(viewpoint, np.float32) if viewpoint is not None else None
    lib.cloud_estimate_normals(_ptr(pts), n, k, ctypes.c_float(cell), _ptr(vp), _ptr(out))
    return out
