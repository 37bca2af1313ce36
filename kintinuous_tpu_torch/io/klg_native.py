"""ctypes wrapper for the native .klg decoder, native/klg_reader.cpp (the
port's copy of kintinuous_tpu/io/klg_native.py).

The library indexes the log once for random access and decodes whole
batches of frames (zlib depth, libjpeg colour) over a pool of threads.
It is built by `make -C native libklg_reader.so` at first use when it is
missing; the build and the load hold an exclusive lock on
native/.libklg_reader.lock, so no process of this package loads the file
while another is still writing it. Without it (no compiler, no jpeglib.h
or zlib.h) available() is False and the engine reads with
io/klg.KlgLogReader.

The library zero-fills a frame's colour when the frame carries no image,
and also when its JPEG does not decode; it zero-fills a depth buffer that
does not inflate. `has_colour()` tells the frames without an image apart,
from the frame headers read at open (`read_index`).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np

NATIVE = Path(__file__).resolve().parents[2] / "native"
_HEADER = struct.Struct("<i")
_FRAME_HEADER = struct.Struct("<qii")


class _Loader:
    """Finds (building if needed) and loads the library once a process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tried = False
        self._lib = None
        self.reason = ""

    def get(self):
        with self._lock:
            if not self._tried:
                self._tried = True
                self._lib = self._load()
            return self._lib

    def _load(self):
        path = NATIVE / "libklg_reader.so"
        try:
            with open(NATIVE / ".libklg_reader.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
                if not path.exists():
                    subprocess.run(["make", "-C", str(NATIVE), "libklg_reader.so"],
                                   check=True, capture_output=True, timeout=120)
                lib = _open(path)
        except subprocess.CalledProcessError as e:
            lines = (e.stdout + e.stderr).decode(errors="replace").splitlines()
            first = next((ln for ln in lines if "error" in ln), lines[-1] if lines else "")
            self.reason = f"make -C native libklg_reader.so failed: {first.strip()}"
            return None
        except (OSError, subprocess.SubprocessError) as e:
            self.reason = f"native/libklg_reader.so did not build or load: {e}"
            return None
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.klg_open.restype = P
        lib.klg_open.argtypes = [ctypes.c_char_p, I, I]
        lib.klg_num_frames.restype = I
        lib.klg_num_frames.argtypes = [P]
        lib.klg_timestamps.restype = None
        lib.klg_timestamps.argtypes = [P, P]
        lib.klg_decode_batch.restype = I
        lib.klg_decode_batch.argtypes = [P, I, I, P, P, P, I]
        lib.klg_close.restype = None
        lib.klg_close.argtypes = [P]
        return lib


def _open(path: Path, tries: int = 3) -> ctypes.CDLL:
    """ctypes.CDLL(path), tried again a second later while it fails: the
    JAX package's loader runs `make -C native` without this lock, and a
    file it is still writing does not load."""
    for i in range(tries):
        try:
            return ctypes.CDLL(str(path))
        except OSError:
            if i == tries - 1:
                raise
            time.sleep(1.0)


_LOADER = _Loader()


def available() -> bool:
    return _LOADER.get() is not None


def unavailable_reason() -> str:
    """Why available() is False ("" when it is True)."""
    _LOADER.get()
    return _LOADER.reason


def read_index(path: str) -> List[Tuple[int, int, int, int, int]]:
    """The index klg_open builds, read in Python by the same walk over the
    frame headers: (timestamp, depth offset, depth size, image offset,
    image size) a frame, image size 0 for a frame without colour."""
    index = []
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            return index
        (n,) = _HEADER.unpack(head)
        for _ in range(max(n, 0)):
            hdr = f.read(_FRAME_HEADER.size)
            if len(hdr) < _FRAME_HEADER.size:
                break
            ts, depth_size, img_size = _FRAME_HEADER.unpack(hdr)
            at = f.tell()
            index.append((ts, at, depth_size, at + depth_size, img_size))
            f.seek(depth_size + img_size, os.SEEK_CUR)
    return index


class NativeKlgReader:
    """Random-access batched .klg reader backed by the C++ decoder."""

    def __init__(self, path: str, width: int = 640, height: int = 480,
                 threads: int = os.cpu_count() or 4):
        lib = _LOADER.get()
        if lib is None:
            raise RuntimeError(f"native klg decoder unavailable: {_LOADER.reason}")
        self._lib = lib
        self.width = width
        self.height = height
        self.threads = threads
        self._h = lib.klg_open(path.encode(), width, height)
        if not self._h:
            raise FileNotFoundError(path)
        self.total_num_frames = lib.klg_num_frames(self._h)
        self._colour = np.array([fr[4] > 0 for fr in read_index(path)], bool)
        if len(self._colour) != self.total_num_frames:
            self.close()
            raise OSError(f"{path}: the frame headers changed while the log was opened")

    def timestamps(self) -> np.ndarray:
        out = np.zeros(self.total_num_frames, np.int64)
        self._lib.klg_timestamps(self._h, out.ctypes.data_as(ctypes.c_void_p))
        return out

    def has_colour(self) -> np.ndarray:
        """(total_num_frames,) bool: the frames that carry an image (the
        others' colour reads back as zeros)."""
        return self._colour.copy()

    def read_batch(self, start: int, count: int):
        """-> (depth (n,H,W) uint16, rgb (n,H,W,3) uint8, ts (n,) int64)."""
        count = max(0, min(count, self.total_num_frames - start))
        if count == 0:
            return (
                np.zeros((0, self.height, self.width), np.uint16),
                np.zeros((0, self.height, self.width, 3), np.uint8),
                np.zeros(0, np.int64),
            )
        depth = np.empty((count, self.height, self.width), np.uint16)
        rgb = np.empty((count, self.height, self.width, 3), np.uint8)
        ts = np.empty(count, np.int64)
        n = self._lib.klg_decode_batch(
            self._h, start, count,
            depth.ctypes.data_as(ctypes.c_void_p),
            rgb.ctypes.data_as(ctypes.c_void_p),
            ts.ctypes.data_as(ctypes.c_void_p),
            self.threads,
        )
        return depth[:n], rgb[:n], ts[:n]

    def close(self):
        if self._h:
            self._lib.klg_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
