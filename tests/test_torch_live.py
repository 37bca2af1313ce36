"""Port vs JAX: live capture (io/live.py) — tests/test_live.py's four
tests on the port, the wire format read both ways round, a listener
error raised from grab_next, and the CLI's -live with --viz-port on the
CPU."""

import json
import socket
import struct
import threading
import time
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from kintinuous_tpu.io import live as jlive
from kintinuous_tpu_torch.config import tiny_test_config
from kintinuous_tpu_torch.io.live import LiveLogReader, SyntheticSensorServer
from kintinuous_tpu_torch.io.synth import orbit_trajectory

torch.set_num_threads(2)

CAM = tiny_test_config().camera


def _read(reader_cls, sock, n, slow_s=0.0):
    """Up to n frames from a sensor at `sock`, by timestamp."""
    got = {}
    with reader_cls(sock, width=CAM.width, height=CAM.height, timeout_s=5.0) as rdr:
        for fr in rdr:
            got[fr.timestamp] = fr
            if len(got) >= n:
                break
            time.sleep(slow_s)
    return got


def test_live_reader_receives_frames(tmp_path):
    sock = str(tmp_path / "sensor.sock")
    srv = SyntheticSensorServer(sock, CAM, orbit_trajectory(6), fps=120.0)
    try:
        frames = list(_read(LiveLogReader, sock, 3).values())
        assert len(frames) == 3
        for fr in frames:
            assert fr.depth.shape == (CAM.height, CAM.width) and fr.depth.dtype == np.uint16
            assert fr.rgb.shape == (CAM.height, CAM.width, 3)
            assert (fr.depth > 0).mean() > 0.5  # the scene is in view
        ts = [f.timestamp for f in frames]
        assert ts == sorted(set(ts))  # no replays
    finally:
        srv.close()


def test_live_reader_drops_stale_frames(tmp_path):
    """A slow consumer skips ahead to the newest frame."""
    sock = str(tmp_path / "sensor.sock")
    srv = SyntheticSensorServer(sock, CAM, orbit_trajectory(12), fps=240.0)
    try:
        with LiveLogReader(sock, width=CAM.width, height=CAM.height, timeout_s=5.0) as rdr:
            first = rdr.grab_next()
            time.sleep(0.2)  # the sensor runs ahead
            later = rdr.grab_next()
            assert rdr.dropped_frames > 0
        assert first is not None and later is not None
        assert later.timestamp - first.timestamp > 2 * int(1e6 / 240)
    finally:
        srv.close()


def test_live_stream_end_returns_none(tmp_path):
    sock = str(tmp_path / "sensor.sock")
    srv = SyntheticSensorServer(sock, CAM, orbit_trajectory(2), fps=500.0)
    try:
        with LiveLogReader(sock, width=CAM.width, height=CAM.height, timeout_s=5.0) as rdr:
            seen = list(rdr)
        assert 1 <= len(seen) <= 2
    finally:
        srv.close()


def test_engine_runs_from_live_source(tmp_path):
    """The engine on a looping sensor leaves after total_num_frames
    (MainController.cpp:80-89: Kintinuous without -l reads the sensor),
    and keeps the last frame it fed for the viewer."""
    from kintinuous_tpu_torch.runtime.engine import SlamEngine

    sock = str(tmp_path / "sensor.sock")
    srv = SyntheticSensorServer(sock, CAM, orbit_trajectory(8), fps=60.0, loop=True)
    try:
        cfg = tiny_test_config(live_source=sock, total_num_frames=6,
                               save_file=str(tmp_path / "live_out"))
        eng = SlamEngine(cfg, device="cpu")
        eng.run()
        assert len(eng.tracker.poses) == 6
        assert eng.last_frame[0].shape == (CAM.height, CAM.width)
    finally:
        srv.close()


@pytest.mark.parametrize("server", ["jax", "port"])
def test_wire_format_reads_both_ways(tmp_path, server):
    """Each package's sensor read by both packages' readers: frames with
    the same timestamp are equal, and equal to the other server's (the
    same render, the same zlib depth and JPEG colour)."""
    Server = SyntheticSensorServer if server == "port" else jlive.SyntheticSensorServer
    other = jlive.SyntheticSensorServer if server == "port" else SyntheticSensorServer
    poses = orbit_trajectory(6)
    reads = {}
    for name, Srv, Reader in (("port", Server, LiveLogReader),
                              ("jax", Server, jlive.LiveLogReader),
                              ("other", other, LiveLogReader)):
        sock = str(tmp_path / f"{name}.sock")
        srv = Srv(sock, CAM, poses, fps=20.0)
        try:
            reads[name] = _read(Reader, sock, len(poses))
        finally:
            srv.close()
    common = set(reads["port"]) & set(reads["jax"]) & set(reads["other"])
    assert len(common) >= 3, {k: sorted(v) for k, v in reads.items()}
    for ts in common:
        a, b, c = reads["port"][ts], reads["jax"][ts], reads["other"][ts]
        assert np.array_equal(a.depth, b.depth) and np.array_equal(a.rgb, b.rgb)
        assert np.array_equal(a.depth, c.depth) and np.array_equal(a.rgb, c.rgb)


def test_listener_error_is_raised_from_grab_next(tmp_path):
    """A frame whose depth does not inflate stops the listener; the
    reader raises that error instead of ending the stream quietly (the
    JAX reader's grab_next waits out its timeout and returns None)."""
    sock = str(tmp_path / "bad.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock)
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        bad = b"not zlib at all"
        conn.sendall(struct.pack("<qii", 0, len(bad), 0) + bad)
        time.sleep(1.0)
        conn.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        with LiveLogReader(sock, width=CAM.width, height=CAM.height, timeout_s=5.0) as rdr:
            with pytest.raises(zlib.error):
                rdr.grab_next()
    finally:
        th.join(timeout=5)
        srv.close()


def test_cli_live_with_the_viewer_on_the_cpu(tmp_path, capsys):
    """`cli -live <sock> --fast -fod -t 4 --viz-port 0 --device cpu` at
    64^3 and 80x60: the URL is printed, the viewer answers while the run
    goes on, and the run writes -n 8 poses."""
    from kintinuous_tpu_torch import cli
    from kintinuous_tpu_torch.io.tum import load_trajectory
    from kintinuous_tpu_torch.viz import server as vs

    sock = str(tmp_path / "sensor.sock")
    calib = tmp_path / "calib.txt"
    calib.write_text(f"{CAM.fx} {CAM.fy} {CAM.cx} {CAM.cy} {CAM.width} {CAM.height}\n")
    srv = SyntheticSensorServer(sock, CAM, orbit_trajectory(8), fps=30.0, loop=True)
    started = threading.Event()
    viewers = []
    init = vs.ViewerServer.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        viewers.append(self)
        started.set()

    answers = {}

    def poll():
        started.wait(60)
        port = viewers[0].port

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                return r.status, r.read()

        while json.loads(get("/state.json")[1])["frame"] < 1:  # the panes need a frame
            time.sleep(0.05)
        for path in ("/", "/state.json", "/pane/rgb.png", "/pane/model.png"):
            answers[path] = get(path)

    vs.ViewerServer.__init__ = spy
    client = threading.Thread(target=poll, daemon=True)
    client.start()
    try:
        rc = cli.main(["-live", sock, "-n", "8", "--fast", "-fod", "-t", "4", "--viz-port",
                       "0", "-o", str(tmp_path / "out"), "-c", str(calib), "-s", "3.0",
                       "--resolution", "64", "--device", "cpu"])
    finally:
        vs.ViewerServer.__init__ = init
        client.join(timeout=60)
        srv.close()
    assert rc == 0
    assert f"viewer: http://127.0.0.1:{viewers[0].port}/" in capsys.readouterr().out
    assert len(load_trajectory(str(tmp_path / "out.poses"))[0]) == 8
    assert all(code == 200 for code, _ in answers.values()) and len(answers) == 4
    assert b"<canvas" in answers["/"][1]
    assert json.loads(answers["/state.json"][1])["status"] in ("tracking", "finished")
    assert answers["/pane/model.png"][1][:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(OSError):  # the CLI closed its viewer
        urllib.request.urlopen(f"http://127.0.0.1:{viewers[0].port}/", timeout=2)


def test_ring_accounting_under_thread_switches(tmp_path):
    """The listener and the consumer share the ring: with the interpreter
    switching threads every microsecond and a sensor far faster than the
    consumer, every frame received is returned, dropped or still unread,
    and the timestamps returned strictly increase."""
    import sys

    sock = str(tmp_path / "sensor.sock")
    srv = SyntheticSensorServer(sock, CAM, orbit_trajectory(4), fps=2000.0, loop=True)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with LiveLogReader(sock, width=CAM.width, height=CAM.height, timeout_s=5.0) as rdr:
            stamps = []
            deadline = time.monotonic() + 1.5
            while time.monotonic() < deadline:
                stamps.append(rdr.grab_next().timestamp)
            with rdr._have:
                unread = sum(1 for s, _ in rdr._ring if s > rdr._last_returned)
                received = rdr.frames_received
            assert received == len(stamps) + rdr.dropped_frames + unread
        assert len(stamps) > 10 and all(b > a for a, b in zip(stamps, stamps[1:]))
    finally:
        sys.setswitchinterval(switch)
        srv.close()
