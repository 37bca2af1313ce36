"""The port's native batched .klg reader (io/klg_native) against the JAX
package's and against the port's KlgLogReader, the engine's batched path
with and without the native library, the loader's lock, and the JPEG
fixture that each codec's decode is held to.

tests/data/jpeg_160x120.klg holds 4 frames of io/synth's default scene on
a short orbit at 160x120, written by the port's KlgLogWriter with Pillow
at quality 90; tests/data/jpeg_160x120_libjpeg.npz holds the native
library's (libjpeg's) decode of its colour. `python
tests/test_torch_klg_native.py` writes both anew.

Every test that needs native/libklg_reader.so skips, saying why, where
the library cannot be built (no compiler, jpeglib.h or zlib.h).
"""

import pathlib
import shutil
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from kintinuous_tpu.io import klg_native as jkn
from kintinuous_tpu_torch.config import CameraIntrinsics
from kintinuous_tpu_torch.io import klg as pklg
from kintinuous_tpu_torch.io import klg_native as pkn
from kintinuous_tpu_torch.io import pcd as ppcd
from kintinuous_tpu_torch.io.synth import Scene, orbit_trajectory, render_frame
from kintinuous_tpu_torch.runtime.engine import SlamEngine
from kintinuous_tpu_torch.tracking.tracker import Tracker
from tests.test_torch_package import ROOT, port_cfg

torch.set_num_threads(2)

DATA = ROOT / "tests" / "data"
FIXTURE = DATA / "jpeg_160x120.klg"
FIXTURE_DECODE = DATA / "jpeg_160x120_libjpeg.npz"
FIXTURE_CAM = CameraIntrinsics().at_level(2)  # 160x120
CAM = CameraIntrinsics(fx=70.0, fy=70.0, cx=40.0, cy=30.0, width=80, height=60)


def fixture_frames():
    """The fixture's frames: (depth, rgb, timestamp) of 4 orbit poses."""
    poses = orbit_trajectory(4, radius=0.05, angle_deg=4.0)
    return [(*render_frame(Scene.default(), FIXTURE_CAM, T), int(i * 1e6 / 30))
            for i, T in enumerate(poses)]


def write_fixture():
    """Writes the fixture with Pillow (OpenCV hidden), then its native decode."""
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None  # `import cv2` raises ImportError: Pillow encodes
    try:
        with pklg.KlgLogWriter(str(FIXTURE)) as w:
            for depth, rgb, ts in fixture_frames():
                w.write(ts, depth, rgb)
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    with pkn.NativeKlgReader(str(FIXTURE), FIXTURE_CAM.width, FIXTURE_CAM.height) as r:
        _, rgb, _ = r.read_batch(0, r.total_num_frames)
    np.savez_compressed(FIXTURE_DECODE, rgb=rgb)


@pytest.fixture(scope="module")
def native():
    if not pkn.available():
        pytest.skip(f"native/libklg_reader.so cannot be built here: "
                    f"{pkn.unavailable_reason()}")
    assert jkn.available()  # the same library, built above under the lock


def frames_of(kind, n=7, cam=CAM):
    """n orbit frames; colour on every frame, none, or every other one."""
    poses = orbit_trajectory(n, radius=0.1, angle_deg=5.0)
    out = []
    for i, T in enumerate(poses):
        depth, rgb = render_frame(Scene.default(), cam, T)
        keep = kind == "colour" or (kind == "mixed" and i % 2 == 0)
        out.append((depth, rgb if keep else None, int(i * 1e6 / 30)))
    return out


def write_log(path, frames):
    with pklg.KlgLogWriter(str(path)) as w:
        for depth, rgb, ts in frames:
            w.write(ts, depth, rgb)
    return str(path)


def python_read(path, cam=CAM):
    with pklg.KlgLogReader(path, width=cam.width, height=cam.height) as r:
        return list(r)


@pytest.mark.parametrize("kind", ["colour", "none", "mixed"])
def test_native_reader_matches_jax_and_the_python_reader(native, tmp_path, kind):
    """The port's NativeKlgReader against JAX's on the same log: depth,
    colour and timestamps bit-equal; against KlgLogReader: depth
    bit-equal, colour within a mean of 2 levels (two JPEG decoders), and
    has_colour() where KlgLogReader gives rgb None."""
    frames = frames_of(kind)
    path = write_log(tmp_path / f"{kind}.klg", frames)
    index = pkn.read_index(path)
    assert [fr[0] for fr in index] == [f[2] for f in frames]
    with open(path, "rb") as f:
        data = f.read()
    for (_, at, n, _, _), (depth, _, _) in zip(index, frames):
        assert zlib.decompress(data[at:at + n]) == depth.astype("<u2").tobytes()
    with pkn.NativeKlgReader(path, CAM.width, CAM.height) as p, \
            jkn.NativeKlgReader(path, CAM.width, CAM.height) as j:
        assert p.total_num_frames == j.total_num_frames == len(frames)
        np.testing.assert_array_equal(p.timestamps(), j.timestamps())
        pd, pc, pts = p.read_batch(0, len(frames))
        jd, jc, jts = j.read_batch(0, len(frames))
        colour = p.has_colour()
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pts, jts)
    np.testing.assert_array_equal(pts, [f[2] for f in frames])
    ref = python_read(path)
    np.testing.assert_array_equal(colour, [f.rgb is not None for f in ref])
    np.testing.assert_array_equal(colour, [f[1] is not None for f in frames])
    for i, f in enumerate(ref):
        np.testing.assert_array_equal(pd[i], f.depth)
        if f.rgb is None:
            assert not pc[i].any(), "a frame without colour reads back as zeros"
        else:
            assert np.abs(pc[i].astype(int) - f.rgb.astype(int)).mean() < 2


def test_read_batch_at_every_start(native, tmp_path):
    """read_batch(start, 3) at every start gives frames start.. of the
    whole read, short at the end; a start at or past the end gives none."""
    frames = frames_of("mixed")
    path = write_log(tmp_path / "m.klg", frames)
    n = len(frames)
    with pkn.NativeKlgReader(path, CAM.width, CAM.height, threads=2) as r:
        d_all, c_all, t_all = r.read_batch(0, n)
        for start in range(n):
            d, c, t = r.read_batch(start, 3)
            k = min(3, n - start)
            assert len(d) == len(c) == len(t) == k
            np.testing.assert_array_equal(d, d_all[start:start + k])
            np.testing.assert_array_equal(c, c_all[start:start + k])
            np.testing.assert_array_equal(t, t_all[start:start + k])
        for start in (n, n + 5):
            d, c, t = r.read_batch(start, 3)
            assert d.shape == (0, CAM.height, CAM.width) and c.shape == (0, CAM.height,
                                                                        CAM.width, 3)
            assert t.shape == (0,)


def test_the_fixture_decodes_to_its_stored_decode(native):
    """The committed JPEG fixture: its depth is the port's render of the
    fixture's poses, its colour decodes (libjpeg) to the stored decode
    bit for bit and (OpenCV or Pillow) within a mean of 2 levels."""
    want = np.load(FIXTURE_DECODE)["rgb"]
    assert want.shape == (4, 120, 160, 3) and want.dtype == np.uint8
    frames = fixture_frames()
    with pkn.NativeKlgReader(str(FIXTURE), FIXTURE_CAM.width, FIXTURE_CAM.height) as r:
        assert r.has_colour().all()
        d, c, t = r.read_batch(0, 4)
    np.testing.assert_array_equal(c, want)
    np.testing.assert_array_equal(d, np.stack([f[0] for f in frames]))
    np.testing.assert_array_equal(t, [f[2] for f in frames])
    for i, f in enumerate(python_read(str(FIXTURE), FIXTURE_CAM)):
        np.testing.assert_array_equal(f.depth, frames[i][0])
        assert np.abs(f.rgb.astype(int) - want[i].astype(int)).mean() < 2
        # the encoder's loss (quality 90, 4:2:0 chroma on the scene's
        # sharp edges: a mean of 4.3 levels): near the rendered colour
        assert np.abs(f.rgb.astype(int) - frames[i][1].astype(int)).mean() < 8


def test_loader_builds_once_under_the_lock(tmp_path, monkeypatch):
    """Two threads ask a fresh loader at once, with no library on disk:
    `make` runs once and both get the library."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("native/libklg_reader.so cannot be built here: no make or g++")
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    for name in ("Makefile", "klg_reader.cpp"):
        shutil.copy(ROOT / "native" / name, native_dir / name)
    runs = []
    real_run = pkn.subprocess.run

    def counted_run(cmd, *a, **k):
        runs.append(cmd)
        return real_run(cmd, *a, **k)

    loader = pkn._Loader()
    monkeypatch.setattr(pkn, "NATIVE", native_dir)
    monkeypatch.setattr(pkn, "_LOADER", loader)
    monkeypatch.setattr(pkn.subprocess, "run", counted_run)
    got = []
    gate = threading.Barrier(2)

    def ask():
        gate.wait(timeout=30)
        got.append(pkn.available())

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    if not got[0]:
        pytest.skip(f"native/libklg_reader.so cannot be built here: {loader.reason}")
    assert got == [True, True]
    assert runs == [["make", "-C", str(native_dir), "libklg_reader.so"]]
    assert (native_dir / "libklg_reader.so").exists()
    assert (native_dir / ".libklg_reader.lock").exists()


def test_an_unbuildable_library_reports_why(tmp_path, monkeypatch):
    """Without a source to build, available() is False and
    unavailable_reason() names the failed make; NativeKlgReader raises it."""
    monkeypatch.setattr(pkn, "NATIVE", tmp_path)
    monkeypatch.setattr(pkn, "_LOADER", pkn._Loader())
    assert not pkn.available()
    assert "libklg_reader.so" in pkn.unavailable_reason()
    with pytest.raises(RuntimeError, match="native klg decoder unavailable"):
        pkn.NativeKlgReader(str(FIXTURE))


CODECS = {"opencv": ("PIL", "PIL.Image"), "pillow": ("cv2",)}


def only_codec(monkeypatch, name):
    """`name` ("opencv" or "pillow") made io/klg's codec by hiding the
    other; skips where `name` itself does not import."""
    for module in CODECS[name]:
        monkeypatch.setitem(sys.modules, module, None)
    try:
        got = pklg.codec_name()
    except RuntimeError:
        got = None
    if got != name:
        pytest.skip(f"{name} is not installed here")


def test_codec_order_and_the_error_that_names_both(monkeypatch):
    """OpenCV, then Pillow: with neither importable, decoding and
    encoding raise an error naming both, and a log's colour ends the read
    with it."""
    assert pklg.codec_name() in ("opencv", "pillow")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(RuntimeError, match=r"OpenCV \(cv2\) or Pillow"):
        pklg.jpeg_codec()
    with pytest.raises(RuntimeError, match=r"OpenCV \(cv2\) or Pillow"):
        pklg._encode_rgb(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match=r"OpenCV \(cv2\) or Pillow"):
        python_read(str(FIXTURE), FIXTURE_CAM)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_each_codec_decodes_the_fixture_within_two_levels(monkeypatch, codec):
    """KlgLogReader on each codec alone: the fixture's colour within a
    mean of 2 levels of the stored libjpeg decode, its depth the
    render's."""
    only_codec(monkeypatch, codec)
    want = np.load(FIXTURE_DECODE)["rgb"].astype(int)
    frames = fixture_frames()
    got = python_read(str(FIXTURE), FIXTURE_CAM)
    assert len(got) == 4
    for i, f in enumerate(got):
        assert f.rgb.dtype == np.uint8 and f.rgb.shape == (120, 160, 3)
        assert np.abs(f.rgb.astype(int) - want[i]).mean() < 2
        np.testing.assert_array_equal(f.depth, frames[i][0])


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_a_jpeg_of_the_wrong_size_or_no_jpeg_raises(monkeypatch, codec):
    """Each codec's decode is checked against the log's width and
    height; bytes that do not decode raise."""
    only_codec(monkeypatch, codec)
    buf = pklg._encode_rgb(np.zeros((60, 80, 3), np.uint8))
    assert pklg._decode_rgb(buf, 80, 60).shape == (60, 80, 3)
    with pytest.raises(ValueError, match=r"not \(30, 40, 3\)"):
        pklg._decode_rgb(buf, 40, 30)
    with pytest.raises((ValueError, OSError)):
        pklg._decode_rgb(b"not a jpeg", 80, 60)


# ------------------------------------------------------------ the engine
def engine_run(path, out, native_on, monkeypatch, **kw):
    """The port's batched engine on the CPU, with the native library or
    (klg_native.available patched to False) without it; returns the
    engine, its outputs and the colour handed to the tracker a frame, in
    frame order (the uploader thread uploads ahead of the frame loop)."""
    from kintinuous_tpu.config import tiny_test_config

    cfg = port_cfg(tiny_test_config(camera=CAM, log_file=path, static_mode=True,
                                    fast_mode=True, volume_resolution=64, voxel_shift=8,
                                    band_cap=512, save_file=str(out), **kw))
    handed = {}
    upload, per_frame = Tracker.upload_batch, Tracker.process_frame

    def spy_upload(self, frames):
        handed.update((f[2], f[1]) for f in frames)
        return upload(self, frames)

    def spy_frame(self, depth, rgb, ts, *a, **k):
        handed[ts] = rgb
        return per_frame(self, depth, rgb, ts, *a, **k)

    with monkeypatch.context() as m:
        if not native_on:
            m.setattr(pkn, "available", lambda: False)
        m.setattr(Tracker, "upload_batch", spy_upload)
        m.setattr(Tracker, "process_frame", spy_frame)
        engine = SlamEngine(cfg, device="cpu")
        if native_on:
            engine.run()
        else:
            with pytest.warns(RuntimeWarning, match="native .klg reader is unavailable"):
                engine.run()
    outs = engine.save()
    assert engine.reader == ("native" if native_on else "python")
    return engine, outs, [handed[ts] for ts in sorted(handed)]


def test_engine_depth_only_log_is_byte_equal_with_and_without_the_library(
        native, tmp_path, monkeypatch):
    path = write_log(tmp_path / "d.klg", frames_of("none", n=12))
    a, oa, ha = engine_run(path, tmp_path / "a", True, monkeypatch)
    b, ob, hb = engine_run(path, tmp_path / "b", False, monkeypatch)
    assert a.codec is None and b.codec is None
    assert len(ha) == len(hb) == 12 and all(c is None for c in ha + hb)
    for kind in ("poses", "cloud"):
        assert pathlib.Path(oa[kind]).read_bytes() == pathlib.Path(ob[kind]).read_bytes()


@pytest.mark.parametrize("flip", [False, True], ids=["rgb", "flip"])
def test_engine_jpeg_log_with_and_without_the_library(native, tmp_path, monkeypatch, flip):
    """A JPEG log (every other frame without colour): the same poses, the
    same map points, colours within a mean of 2 levels; the colour handed
    to the tracker is each reader's decode, channel-flipped under -f on
    both paths, and None on the frames without colour."""
    frames = frames_of("mixed", n=12)
    path = write_log(tmp_path / "j.klg", frames)
    a, oa, ha = engine_run(path, tmp_path / "a", True, monkeypatch, flip_colors=flip)
    b, ob, hb = engine_run(path, tmp_path / "b", False, monkeypatch, flip_colors=flip)
    assert a.codec == "libjpeg" and b.codec == pklg.codec_name()
    assert pathlib.Path(oa["poses"]).read_bytes() == pathlib.Path(ob["poses"]).read_bytes()
    pa, pb = ppcd.load_pcd(oa["cloud"]), ppcd.load_pcd(ob["cloud"])
    np.testing.assert_array_equal(pa["points"], pb["points"])
    assert np.abs(pa["colors"].astype(int) - pb["colors"].astype(int)).mean() < 2
    with pkn.NativeKlgReader(path, CAM.width, CAM.height) as r:
        _, native_rgb, _ = r.read_batch(0, 12)
    python_rgb = [f.rgb for f in python_read(path)]
    assert len(ha) == len(hb) == 12
    for i in range(12):
        if frames[i][1] is None:
            assert ha[i] is None and hb[i] is None
            continue
        want_a, want_b = native_rgb[i], python_rgb[i]
        if flip:
            want_a, want_b = want_a[..., ::-1], want_b[..., ::-1]
        np.testing.assert_array_equal(ha[i], want_a)
        np.testing.assert_array_equal(hb[i], want_b)


if __name__ == "__main__":
    write_fixture()
    print(f"wrote {FIXTURE} and {FIXTURE_DECODE}")
