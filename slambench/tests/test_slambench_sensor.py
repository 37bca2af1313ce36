"""The sensor process keeps its schedule when its consumer stalls: it drops
whole frames the socket has no room for, and never waits for the client."""

import json
import socket
import struct
import subprocess
import sys
import time

from slambench.spec import ROOT

FRAME = struct.Struct("<qii")


def _blob(frames):
    out = [len(frames).to_bytes(8, "little")]
    for d, c in frames:
        out += [len(d).to_bytes(4, "little"), len(c).to_bytes(4, "little"), d, c]
    return b"".join(out)


def _recv_exact(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def test_live_sensor_keeps_its_schedule_through_a_stall(tmp_path):
    rate, total = 50.0, 60
    # frames large enough that a stalled reader fills the socket's buffer
    # (8 MiB where the system allows it)
    frames = [(bytes([i]) * 1_000_000, bytes([i]) * 1000) for i in range(7)]
    path = str(tmp_path / "s.sock")
    p = subprocess.Popen([sys.executable, "-m", "slambench.sensor", "--mode", "live", "--path",
                          path, "--frames", str(total), "--rate", str(rate)],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=str(ROOT))
    p.stdin.write(_blob(frames))
    p.stdin.close()
    p.stdin = None  # communicate() must not flush it
    assert p.stdout.readline().strip() == b"listening"
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(path)
    time.sleep(0.6)  # the consumer stalls for 30 periods
    got = []
    while True:
        hdr = _recv_exact(c, FRAME.size)
        if hdr is None:
            break
        ts, dl, cl = FRAME.unpack(hdr)
        body = _recv_exact(c, dl + cl)
        got.append((ts, time.monotonic(), body[:1]))
    c.close()
    out, _ = p.communicate(timeout=30)
    stats = json.loads(out.decode().strip().splitlines()[-1])
    assert len(got) == stats["frames_sent"] > 0
    assert stats["frames_sent"] + stats["frames_dropped"] == total
    assert stats["frames_dropped"] > 0  # the stall filled the socket
    period_us = 1e6 / rate
    t0 = stats["t0_us"]
    due = []
    for ts, _, first in got:
        n = round((ts - t0) / period_us)
        assert abs(ts - (t0 + n * period_us)) <= 1, n  # stamped with its due time
        assert first == bytes([n % len(frames)])  # whole, and the frame due then
        due.append(n)
    assert due == sorted(set(due)) and due[-1] == total - 1
    # the schedule did not slow: the last frame left within a few periods
    # of its due time, however long the consumer stalled, and no send
    # waited for the client
    assert got[-1][1] - got[-1][0] / 1e6 < 5 * period_us / 1e6
    assert stats["late_ms_p95"] < period_us / 1e3
    assert stats["send_ms_max"] < period_us / 1e3


def test_log_mode_streams_the_declared_frames(tmp_path):
    frames = [(b"d" * 10, b"c" * 5), (b"D" * 20, b"")]
    path = tmp_path / "log.klg"
    p = subprocess.run([sys.executable, "-m", "slambench.sensor", "--mode", "log", "--path",
                        str(path), "--frames", "5"], input=_blob(frames),
                       capture_output=True, cwd=str(ROOT), timeout=30)
    assert p.returncode == 0
    data = path.read_bytes()
    (n,) = struct.unpack("<i", data[:4])
    assert n == 5
    at, seen = 4, []
    for i in range(5):
        ts, dl, cl = FRAME.unpack(data[at:at + 16])
        at += 16 + dl + cl
        seen.append((ts, dl, cl))
    assert at == len(data)
    assert [s[1] for s in seen] == [10, 20, 10, 20, 10]
    assert [s[0] for s in seen] == [int(i * 1e6 / 30.0) for i in range(5)]
