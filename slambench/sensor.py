"""The sensor: a process of its own (standard library only, no card) that
streams a cell's pre-encoded frames in the `.klg` frame format

    int64 timestamp_us, int32 depth_bytes, int32 rgb_bytes, zlib depth, JPEG rgb

repeating the unique frames in order. It reads them from its standard
input (an 8-byte count, then per frame two 4-byte lengths and the
bytes) and writes one JSON line of what it did to its standard output
when it ends.

    --mode log:  a recorded `.klg` log, written into the named pipe at
                 --path as fast as the reader takes it: the int32 frame
                 count (--frames), then the frames, stamped i / 30 s.
    --mode live: a live sensor on the UNIX socket at --path: it prints
                 "listening", takes one client and sends frame n at its
                 due time t0 + n / --rate on CLOCK_MONOTONIC, stamped with
                 that due time in microseconds, on a schedule that never
                 waits for the client: a frame the socket has no room for
                 is dropped whole, as a camera drops the frames its host
                 does not read, and counted. How late each send began,
                 and the longest send, are reported. It ends after
                 --frames frames or when the client goes away.

SIGTERM ends either stream after the frame being sent.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import signal
import socket
import struct
import sys
import termios
import time

_FRAME = struct.Struct("<qii")
_COUNT = struct.Struct("<i")
_PIPE_BYTES = 1 << 20  # the largest pipe an unprivileged process may ask for
_SOCKET_BYTES = 8 << 20  # the live socket's send buffer, where the system allows it
_SEND_SLACK = 64 << 10  # room kept free beyond a frame's bytes (the kernel's overhead)


class _Stop:
    """Set by SIGTERM: the stream ends after the frame being sent."""

    requested = False

    @classmethod
    def install(cls):
        signal.signal(signal.SIGTERM, lambda *_: setattr(cls, "requested", True))


def read_frames(stream):
    (n,) = struct.unpack("<q", stream.read(8))
    frames = []
    for _ in range(n):
        dlen, clen = struct.unpack("<ii", stream.read(8))
        frames.append((stream.read(dlen), stream.read(clen)))
    return frames


def serve_log(path: str, frames, total: int) -> dict:
    written = 0
    t0 = time.monotonic()
    try:
        with open(path, "wb", buffering=0) as f:
            try:
                fcntl.fcntl(f.fileno(), fcntl.F_SETPIPE_SZ, _PIPE_BYTES)
            except OSError:
                pass  # a smaller pipe only means more context switches
            f.write(_COUNT.pack(total))
            for i in range(total):
                if _Stop.requested:
                    break
                d, c = frames[i % len(frames)]
                f.write(_FRAME.pack(int(i * 1e6 / 30.0), len(d), len(c)) + d + c)
                written += 1
    except (BrokenPipeError, ConnectionResetError):
        pass  # the reader closed the log: the run is over
    return {"mode": "log", "frames_written": written, "frames_declared": total,
            "seconds": time.monotonic() - t0}


def _percentile(xs, q):
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def _queued(conn) -> int:
    """Bytes the socket holds that the client has not read (SIOCOUTQ)."""
    buf = fcntl.ioctl(conn.fileno(), termios.TIOCOUTQ, b"\0\0\0\0")
    return struct.unpack("i", buf)[0]


def serve_live(path: str, frames, total: int, rate: float) -> dict:
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    print("listening", flush=True)
    conn, _ = srv.accept()
    # room for several frames in the socket, so that a stall of the
    # client drops no frame at once
    for opt in (getattr(socket, "SO_SNDBUFFORCE", None), socket.SO_SNDBUF):
        if opt is None:
            continue
        try:
            conn.setsockopt(socket.SOL_SOCKET, opt, _SOCKET_BYTES)
            break
        except OSError:
            continue
    sndbuf = conn.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF)
    period_ns = int(round(1e9 / rate))
    t0 = time.monotonic_ns() + 20_000_000
    late_ms, send_ms = [], []
    sent = dropped = 0
    try:
        for n in range(total):
            if _Stop.requested:
                break
            due = t0 + n * period_ns
            wait = due - time.monotonic_ns()
            if wait > 0:
                time.sleep(wait / 1e9)
            start = time.monotonic_ns()
            late_ms.append((start - due) / 1e6)
            d, c = frames[n % len(frames)]
            msg = _FRAME.pack(due // 1000, len(d), len(c)) + d + c
            # a frame goes out whole or not at all: with room for it the
            # send does not wait for the client
            if _queued(conn) + len(msg) + len(msg) // 4 + _SEND_SLACK > sndbuf:
                dropped += 1
                continue
            conn.sendall(msg)
            send_ms.append((time.monotonic_ns() - start) / 1e6)
            sent += 1
    except (BrokenPipeError, ConnectionResetError):
        pass  # the client went away: the run is over
    finally:
        conn.close()
        srv.close()
    return {"mode": "live", "t0_us": t0 // 1000, "period_us": period_ns / 1000.0,
            "send_buffer_bytes": sndbuf, "frames_sent": sent, "frames_dropped": dropped,
            "late_ms_p50": _percentile(late_ms, 0.5), "late_ms_p95": _percentile(late_ms, 0.95),
            "late_ms_max": max(late_ms or [0.0]), "send_ms_max": max(send_ms or [0.0]),
            "late_over_period": sum(1 for x in late_ms if x > period_ns / 1e6)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="slambench.sensor")
    p.add_argument("--mode", choices=("log", "live"), required=True)
    p.add_argument("--path", required=True)
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--rate", type=float, default=30.0)
    a = p.parse_args(argv)
    _Stop.install()
    frames = read_frames(sys.stdin.buffer)
    if a.mode == "log":
        out = serve_log(a.path, frames, a.frames)
    else:
        out = serve_live(a.path, frames, a.frames, a.rate)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
