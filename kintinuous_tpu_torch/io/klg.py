"""`.klg` RGB-D log reading and writing (the port's copy of
kintinuous_tpu/io/klg.py).

On-disk format:

    int32  numFrames
    repeated numFrames times:
        int64  timestamp (microseconds)
        int32  depthSize (compressed bytes)
        int32  imageSize (compressed bytes; 0 => no rgb frame)
        bytes  depth  -- zlib-compressed uint16 little-endian, H*W
        bytes  rgb    -- JPEG, H x W x 3

Depth is zlib, from the standard library. JPEG colour needs OpenCV
(`cv2`) or Pillow, imported only when a frame carries an image; a log
written without colour (imageSize 0) reads with neither, and its frames
have rgb None. A thread decodes ahead of the consumer.
"""

from __future__ import annotations

import io
import struct
import threading
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

_HEADER = struct.Struct("<i")
_FRAME_HEADER = struct.Struct("<qii")


@dataclass
class Frame:
    timestamp: int  # microseconds
    depth: np.ndarray  # (H, W) uint16, raw sensor units (mm)
    rgb: Optional[np.ndarray]  # (H, W, 3) uint8 RGB or None
    index: int


def jpeg_codec():
    """cv2 if it imports, else PIL's Image; raises if neither does."""
    try:
        import cv2

        return cv2
    except ImportError:
        pass
    try:
        from PIL import Image

        return Image
    except ImportError:
        raise RuntimeError(
            "this .klg log carries JPEG colour images: decoding or encoding "
            "them needs OpenCV (cv2) or Pillow, and neither is installed"
        ) from None


def codec_name() -> str:
    """"opencv" or "pillow": the decoder jpeg_codec() gives."""
    return "opencv" if jpeg_codec().__name__ == "cv2" else "pillow"


def _decode_rgb(buf: bytes, width: int, height: int) -> np.ndarray:
    """A JPEG as (height, width, 3) uint8 RGB; raises if it does not
    decode to that shape."""
    codec = jpeg_codec()
    if codec.__name__ == "cv2":
        bgr = codec.imdecode(np.frombuffer(buf, dtype=np.uint8), codec.IMREAD_COLOR)
        if bgr is None:
            raise ValueError("OpenCV cannot decode this JPEG")
        rgb = bgr[:, :, ::-1].copy()  # BGR -> RGB
    else:
        rgb = np.asarray(codec.open(io.BytesIO(buf)).convert("RGB"))
    if rgb.shape != (height, width, 3):
        raise ValueError(f"a JPEG of shape {rgb.shape}, not ({height}, {width}, 3)")
    return rgb


def _encode_rgb(rgb: np.ndarray, quality: int = 90) -> bytes:
    codec = jpeg_codec()
    if codec.__name__ == "cv2":
        ok, buf = codec.imencode(".jpg", rgb[:, :, ::-1],
                                 [codec.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise RuntimeError("JPEG encoding failed")
        return buf.tobytes()
    b = io.BytesIO()
    codec.fromarray(rgb).save(b, format="JPEG", quality=quality)
    return b.getvalue()


class KlgLogReader:
    """Sequential `.klg` reader with background decode prefetch; an
    iterator of Frames. `total_num_frames` comes from the header (capped
    by max_frames when that is positive)."""

    def __init__(self, path: str, width: int = 640, height: int = 480,
                 prefetch: int = 8, max_frames: int = -1):
        self.path = path
        self.width = width
        self.height = height
        self._f = open(path, "rb")
        (self.total_num_frames,) = _HEADER.unpack(self._f.read(_HEADER.size))
        if max_frames > 0:
            self.total_num_frames = min(self.total_num_frames, max_frames)
        self._prefetch = max(1, prefetch)
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._next_read = 0
        self._done = False
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._reader_loop, daemon=True)
        self._thread.start()

    def _read_one(self) -> Optional[Frame]:
        hdr = self._f.read(_FRAME_HEADER.size)
        if len(hdr) < _FRAME_HEADER.size:
            return None
        ts, depth_size, img_size = _FRAME_HEADER.unpack(hdr)
        depth_buf = self._f.read(depth_size)
        img_buf = self._f.read(img_size) if img_size > 0 else b""
        depth = np.frombuffer(zlib.decompress(depth_buf), dtype="<u2").reshape(
            self.height, self.width)
        rgb = _decode_rgb(img_buf, self.width, self.height) if img_buf else None
        frame = Frame(timestamp=ts, depth=depth, rgb=rgb, index=self._next_read)
        self._next_read += 1
        return frame

    def _reader_loop(self):
        while True:
            with self._cond:
                while len(self._queue) >= self._prefetch and not self._done:
                    self._cond.wait()
                if self._done:
                    return
            frame = None
            if self._next_read < self.total_num_frames:
                try:
                    frame = self._read_one()
                except (OSError, ValueError, zlib.error, RuntimeError) as e:
                    # a truncated or undecodable frame ends the log; the
                    # iterator re-raises what stopped it
                    self.error = e
            with self._cond:
                self._queue.append(frame)
                self._cond.notify_all()
                if frame is None:
                    return

    def __iter__(self) -> Iterator[Frame]:
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                frame = self._queue.popleft()
                self._cond.notify_all()
            if frame is None:
                if self.error is not None:
                    raise self.error
                return
            yield frame

    def close(self):
        with self._cond:
            self._done = True
            self._cond.notify_all()
        self._thread.join(timeout=10)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class KlgLogWriter:
    """Writes `.klg` logs; a frame given rgb None is written without an
    image (imageSize 0)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_HEADER.pack(0))
        self._count = 0

    def write(self, timestamp: int, depth: np.ndarray, rgb: Optional[np.ndarray]):
        if depth.dtype != np.uint16:
            raise ValueError(f"depth must be uint16, not {depth.dtype}")
        depth_buf = zlib.compress(depth.astype("<u2").tobytes())
        img_buf = _encode_rgb(rgb) if rgb is not None else b""
        self._f.write(_FRAME_HEADER.pack(int(timestamp), len(depth_buf), len(img_buf)))
        self._f.write(depth_buf)
        self._f.write(img_buf)
        self._count += 1

    def close(self):
        self._f.seek(0)
        self._f.write(_HEADER.pack(self._count))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
