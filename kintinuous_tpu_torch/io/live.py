"""Live RGB-D capture (port of kintinuous_tpu/io/live.py).

The reference's LiveLogReader polls a 10-deep ring that the OpenNI2
callbacks fill and always hands out the newest pair, dropping stale
ones (LiveLogReader.cpp:63-85). Here the sensor is a daemon on a UNIX
or TCP socket that streams frames in the `.klg` frame format:

    int64 timestamp_us, int32 depth_bytes, int32 rgb_bytes,
    zlib(uint16 depth[h*w]), jpeg(rgb)    (RawLogReader.cpp:52-64)

A listener thread decodes into a ring of RING_SIZE frames;
`grab_next()` blocks until a frame newer than the last one returned
exists and returns the newest. An error in the listener (a frame that
does not decode) is kept and raised from `grab_next`, rather than
ending the stream as if the sensor had stopped. Colour goes through
`io/klg._decode_rgb` and `_encode_rgb`, looked up at each call.

`SyntheticSensorServer` is a stand-in sensor: it renders the synthetic
scene along a trajectory (io/synth.py) and streams it at `fps`, with
`loop` starting the trajectory over at its end. Its pace and its
timestamps follow the count of frames sent, so a looping stream keeps
both.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import zlib
from typing import Iterator, Optional

import numpy as np

from kintinuous_tpu_torch.io import klg
from kintinuous_tpu_torch.io.klg import Frame

_FRAME_HDR = struct.Struct("<qii")
RING_SIZE = 10  # the reference's OpenNI2Interface ring depth


def _socket_for(address) -> socket.socket:
    """A TCP socket for "host:port", else a UNIX socket for a path."""
    if isinstance(address, str) and ":" in address:
        return socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    return socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)


def _sockaddr(address):
    if isinstance(address, str) and ":" in address:
        host, port = address.rsplit(":", 1)
        return host, int(port)
    return address


class LiveLogReader:
    """Streams live frames from a sensor daemon's socket; the same
    surface as KlgLogReader (`grab_next`, iteration, context manager)."""

    def __init__(self, address, width: int = 640, height: int = 480,
                 timeout_s: float = 10.0):
        self.width = width
        self.height = height
        self.timeout_s = timeout_s
        self.total_num_frames = -1  # unbounded, as the reference's
        self.error: Optional[BaseException] = None
        self._ring: list = []  # [(seq, Frame)]
        self._seq = 0
        self._last_returned = -1
        self._returned = 0
        self._have = threading.Condition(threading.Lock())
        self._stop = threading.Event()
        self._sock = _socket_for(address)
        self._sock.connect(_sockaddr(address))
        self._thread = threading.Thread(target=self._listen, daemon=True)
        self._thread.start()

    def _recv_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _read_frame(self) -> Optional[Frame]:
        hdr = self._recv_exact(_FRAME_HDR.size)
        if hdr is None:
            return None
        ts, dlen, clen = _FRAME_HDR.unpack(hdr)
        dbuf = self._recv_exact(dlen)
        cbuf = self._recv_exact(clen) if clen else b""
        if dbuf is None or cbuf is None:
            return None
        depth = np.frombuffer(zlib.decompress(dbuf), np.uint16).reshape(
            self.height, self.width)
        rgb = (klg._decode_rgb(cbuf, self.width, self.height) if cbuf
               else np.zeros((self.height, self.width, 3), np.uint8))
        return Frame(timestamp=ts, depth=depth, rgb=rgb, index=self._seq)

    def _listen(self):
        try:
            while not self._stop.is_set():
                fr = self._read_frame()
                if fr is None:
                    break
                with self._have:
                    self._ring.append((self._seq, fr))
                    self._seq += 1
                    del self._ring[:-RING_SIZE]
                    self._have.notify_all()
        except Exception as e:  # raised from grab_next on the consumer's thread
            self.error = e
        finally:
            with self._have:
                self._stop.set()
                self._have.notify_all()

    def grab_next(self) -> Optional[Frame]:
        """The newest frame not yet returned; blocks until one arrives.
        None when the stream ended or no frame came within timeout_s;
        raises what stopped the listener, if anything did."""
        deadline = time.monotonic() + self.timeout_s
        with self._have:
            while True:
                if self._ring and self._ring[-1][0] > self._last_returned:
                    seq, fr = self._ring[-1]
                    self._last_returned = seq
                    self._returned += 1
                    return fr
                if self._stop.is_set():
                    if self.error is not None:
                        raise self.error
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._have.wait(timeout=remaining)

    @property
    def frames_received(self) -> int:
        return self._seq

    @property
    def dropped_frames(self) -> int:
        """Frames received that were never returned and never will be:
        all but those returned and those newer than the last returned
        (the JAX reader counts only the frames past the last returned
        one that left the ring, so it misses those skipped before it)."""
        with self._have:
            unread = sum(1 for s, _ in self._ring if s > self._last_returned)
            return self._seq - self._returned - unread

    def __iter__(self) -> Iterator[Frame]:
        while True:
            fr = self.grab_next()
            if fr is None:
                return
            yield fr

    def close(self):
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class SyntheticSensorServer:
    """A stand-in camera daemon: renders the synthetic scene (default
    Scene.default()) at each pose of `poses` in its constructor, then
    serves one client at `fps`."""

    def __init__(self, address, cam, poses, fps: float = 30.0, scene=None,
                 loop: bool = False):
        from kintinuous_tpu_torch.io.synth import Scene, render_frame

        self.address = address
        self.cam = cam
        self.fps = fps
        self.loop = loop
        self.frames_sent = 0
        scene = scene or Scene.default()
        self.frames = []
        for T in poses:
            depth, rgb = render_frame(scene, cam, T)
            self.frames.append((np.asarray(depth, np.uint16), np.asarray(rgb, np.uint8)))
        self._srv = _socket_for(address)
        if isinstance(_sockaddr(address), tuple):
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(_sockaddr(address))
        self._srv.listen(1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            conn, _ = self._srv.accept()
        except OSError:
            return
        period = 1.0 / self.fps
        t0 = time.monotonic()
        try:
            n = 0
            while not self._stop.is_set():
                if n >= len(self.frames) and not self.loop:
                    break
                depth, rgb = self.frames[n % len(self.frames)]
                dbuf = zlib.compress(depth.tobytes(), 1)
                cbuf = klg._encode_rgb(rgb)
                ts = int(n * 1e6 / self.fps)
                conn.sendall(_FRAME_HDR.pack(ts, len(dbuf), len(cbuf)) + dbuf + cbuf)
                n += 1
                self.frames_sent = n
                delay = t0 + n * period - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
        except OSError:
            pass
        finally:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=3.0)
