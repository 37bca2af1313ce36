"""Port vs JAX: the web viewer (viz/server.py), its PNG encoder and Turbo
map (viz/png.py) and the headless exports (viz/headless.py).
tests/test_viewer.py's three tests run on the port's engine; the page,
cloud.bin and mesh.bin are byte-equal to the JAX server's on stub
engines holding the same slices and patches; the panes decode to the
JAX server's pixels."""

import json
import struct
import threading
import time
import urllib.request
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from kintinuous_tpu.viz import headless as jheadless
from kintinuous_tpu.viz import server as jserver
from kintinuous_tpu_torch.config import tiny_test_config
from kintinuous_tpu_torch.io.synth import Scene, orbit_trajectory, render_frame
from kintinuous_tpu_torch.runtime.engine import SlamEngine
from kintinuous_tpu_torch.viz import headless
from kintinuous_tpu_torch.viz.png import PNG_SIGNATURE, TURBO, encode_png
from kintinuous_tpu_torch.viz.server import _PAGE, ViewerServer

torch.set_num_threads(2)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _decode(png: bytes) -> np.ndarray:
    """A PNG's pixels as RGB, decoded by OpenCV."""
    bgr = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR)
    return bgr[:, :, ::-1]


# ------------------------------------------------ tests/test_viewer.py's
def test_viewer_endpoints(tmp_path):
    cfg = tiny_test_config(voxel_shift=4, save_file=str(tmp_path / "v"))
    eng = SlamEngine(cfg, device="cpu")
    viewer = ViewerServer(eng, port=0)
    try:
        # a sideways walk: a shift and slices
        for i, T in enumerate(orbit_trajectory(6, radius=0.4, angle_deg=0.0)):
            d, c = render_frame(Scene.default(), cfg.camera, T)
            eng.tracker.process_frame(d, c, i * 33333)
        eng.tracker.flush()
        while not eng.slice_q.empty():  # no worker threads here
            eng.slice_proc.process(eng.slice_q.get())

        page = _get(viewer.port, "/").decode()
        assert "<canvas" in page and "cloud.bin" in page
        st = json.loads(_get(viewer.port, "/state.json"))
        assert st["frame"] == 6 and len(st["traj"]) == 6
        assert st["status"] in ("tracking", "finished")
        assert len(st["frusta"]) >= 1 and len(st["frusta"][-1]) == 12
        assert "n_triangles" in st and "backend_lag_s" in st
        blob = _get(viewer.port, "/cloud.bin")
        (n,) = struct.unpack("<I", blob[:4])
        assert len(blob) == 4 + n * 12 + n * 3
        assert np.isfinite(np.frombuffer(blob[4:4 + 12 * n], np.float32)).all()

        assert _post(viewer.port, "/control", {"cmd": "pause"})["ok"]
        assert eng.paused.is_set()
        assert _post(viewer.port, "/control", {"cmd": "pause"})["ok"]
        assert not eng.paused.is_set()
        assert _post(viewer.port, "/control", {"cmd": "complete"})["ok"]
        assert eng.stop_requested.is_set()
        assert not _post(viewer.port, "/control", {"cmd": "bogus"})["ok"]
    finally:
        viewer.close()


def test_viewer_panes(tmp_path):
    cfg = tiny_test_config(save_file=str(tmp_path / "p"))
    eng = SlamEngine(cfg, device="cpu")
    viewer = ViewerServer(eng, port=0)
    try:
        d, c = render_frame(Scene.default(), cfg.camera, orbit_trajectory(1)[0])
        eng.tracker.process_frame(d, c, 0)
        eng.tracker.flush()
        eng.last_frame = (d, c)
        for name in ("rgb", "depth", "model", "model_depth"):
            assert _get(viewer.port, f"/pane/{name}.png")[:8] == PNG_SIGNATURE, name
    finally:
        viewer.close()


def test_viewer_mesh_endpoint(tmp_path):
    """mesh.bin serves the cell-welded incremental mesh."""
    from kintinuous_tpu_torch.backend.meshing import MeshPatch

    eng = SlamEngine(tiny_test_config(save_file=str(tmp_path / "m")), device="cpu")
    viewer = ViewerServer(eng, port=0)
    try:
        assert struct.unpack("<I", _get(viewer.port, "/mesh.bin")[:4])[0] == 0
        # two overlapping patches whose shared cells weld
        cells1 = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.int32)
        cells2 = np.array([[1, 0, 0], [0, 1, 0], [1, 1, 0]], np.int32)

        def mk(cells):
            return MeshPatch(vertices=cells.astype(np.float32) * 0.01,
                             colors=np.full((3, 3), 128, np.uint8),
                             faces=np.array([[0, 1, 2]], np.int32), cells=cells)

        eng.tracker.mesh_patches = [mk(cells1), mk(cells2)]
        assert json.loads(_get(viewer.port, "/state.json"))["n_triangles"] == 2
        blob = _get(viewer.port, "/mesh.bin")
        (nv,) = struct.unpack("<I", blob[:4])
        assert nv == 4  # 6 vertices weld to 4 cells
        off = 4 + 12 * nv + 3 * nv
        off += (4 - off % 4) % 4
        (nf,) = struct.unpack("<I", blob[off:off + 4])
        faces = np.frombuffer(blob[off + 4:off + 4 + 12 * nf], np.uint32).reshape(nf, 3)
        assert nf == 2 and faces.max() < nv
    finally:
        viewer.close()


# ------------------------------------------------ byte equality with JAX
def _stub_engine(seed: int, loops: bool, cells: bool):
    """An engine as far as cloud.bin and mesh.bin read one: processed
    slices of 200,000 points each (past MAX_VIEW_POINTS, so the
    decimation runs), band patches of 40,000 faces each (past
    MAX_VIEW_FACES), and with `loops` a deformation holding a pool."""
    rng = np.random.default_rng(seed)
    slices = []
    for _ in range(2):
        n = 200_000
        slices.append(SimpleNamespace(processed={
            "points": rng.standard_normal((n, 3)).astype(np.float32),
            "colors": rng.integers(0, 256, (n, 3), dtype=np.uint8)}))
    patches = []
    for k in range(2):
        nv = 30_000
        c = rng.integers(0, 40, (nv, 3)).astype(np.int32) if cells else None
        patches.append(SimpleNamespace(
            vertices=rng.standard_normal((nv, 3)).astype(np.float32),
            colors=rng.integers(0, 256, (nv, 3), dtype=np.uint8),
            faces=rng.integers(0, nv, (40_000, 3)).astype(np.int32), cells=c))
    pool = (rng.standard_normal((50_000, 3)).astype(np.float32),
            rng.integers(0, 256, (50_000, 3), dtype=np.uint8))
    deformation = SimpleNamespace(n_loops_accepted=1, mesh_patches=patches,
                                  pool_points=lambda: pool) if loops else None
    return SimpleNamespace(slice_proc=SimpleNamespace(processed=slices),
                           deformation=deformation,
                           tracker=SimpleNamespace(mesh_patches=[] if loops else patches))


@pytest.mark.parametrize("loops,cells", [(False, True), (False, False), (True, True)],
                         ids=["slices_welded", "slices_unwelded", "deformed"])
def test_cloud_mesh_and_page_bytes_equal_jax(loops, cells):
    eng = _stub_engine(0, loops, cells)
    a, b = jserver.ViewerServer(eng, port=0), ViewerServer(eng, port=0)
    try:
        assert b.cloud_bin() == a.cloud_bin()
        assert b.mesh_bin() == a.mesh_bin()
        n = struct.unpack("<I", b.cloud_bin()[:4])[0]
        assert n == (50_000 if loops else jserver.MAX_VIEW_POINTS)
        assert _get(b.port, "/") == _get(a.port, "/") == jserver._PAGE.encode()
        assert _PAGE == jserver._PAGE
    finally:
        a.close()
        b.close()


def _pane_engines():
    """JAX and port stub engines with the same last frame and prediction
    maps (the port's on its tensors)."""
    cam = tiny_test_config().camera
    d, c = render_frame(Scene.default(), cam, orbit_trajectory(1)[0])
    rng = np.random.default_rng(3)
    h, w = cam.height // 2, cam.width // 2
    vmap = rng.uniform(0.5, 7.0, (3, h, w)).astype(np.float32)
    n = rng.standard_normal((3, h, w)).astype(np.float32)
    nmap = n / np.linalg.norm(n, axis=0, keepdims=True)
    miss = rng.random((h, w)) < 0.2
    vmap[:, miss], nmap[:, miss] = np.nan, np.nan

    def eng(vm, nm):
        st = SimpleNamespace(pred_vmap=vm, pred_nmap=nm)
        return SimpleNamespace(last_frame=(d, c), tracker=SimpleNamespace(state=st))

    return (eng(vmap, nmap),
            eng(torch.from_numpy(vmap), torch.from_numpy(nmap)), (d, c))


def test_panes_decode_to_the_jax_panes():
    """rgb and depth: equal pixels; model and model_depth: equal on >=
    99.9 % of pixels, never more than 1 apart (measured: equal). Each
    pane is 8-bit RGB at its map's size."""
    je, pe, (d, c) = _pane_engines()
    a, b = jserver.ViewerServer(je, port=0), ViewerServer(pe, port=0)
    try:
        for name in ("rgb", "depth", "model", "model_depth"):
            pa, pb = a.pane_png(name), b.pane_png(name)
            assert pb[:8] == PNG_SIGNATURE and pb[12:16] == b"IHDR"
            w, h, depth, kind = struct.unpack(">IIBB", pb[16:26])
            assert (depth, kind) == (8, 2)
            xa, xb = _decode(pa).astype(int), _decode(pb).astype(int)
            assert xb.shape == (h, w, 3) == xa.shape
            if name in ("rgb", "depth"):
                assert (w, h) == (d.shape[1], d.shape[0])
                assert np.array_equal(xa, xb), name
            else:
                assert (xa != xb).any(axis=-1).mean() <= 1e-3, name
                assert np.abs(xa - xb).max() <= 1, name
        assert np.array_equal(_decode(b.pane_png("rgb")), c)
        assert b.pane_png("nonsense") is None
    finally:
        a.close()
        b.close()


def test_turbo_table_is_opencvs():
    ref = cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_TURBO)
    assert np.array_equal(TURBO, ref.reshape(256, 3)[:, ::-1])


def test_png_encoder_round_trips_through_opencv():
    img = np.random.default_rng(4).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    assert np.array_equal(_decode(encode_png(img)), img)
    with pytest.raises(ValueError):
        encode_png(img[..., 0])


def test_save_and_reset_wait_for_a_frame_boundary(tmp_path):
    """The frame loop holds engine.frame_lock for each frame: a save the
    viewer starts mid-frame writes nothing until the frame is done, and
    a reset likewise keeps the tracker until then."""
    cfg = tiny_test_config(save_file=str(tmp_path / "s"))
    eng = SlamEngine(cfg, device="cpu")
    d, c = render_frame(Scene.default(), cfg.camera, orbit_trajectory(1)[0])
    eng.tracker.process_frame(d, c, 0)
    eng.tracker.flush()
    viewer = ViewerServer(eng, port=0)
    try:
        pcd = tmp_path / "s.pcd"
        for cmd, done in (("save", pcd.exists),
                          ("reset", lambda t=eng.tracker: eng.tracker is not t)):
            with eng.frame_lock:  # a frame in flight
                assert _post(viewer.port, "/control", {"cmd": cmd})["ok"]
                time.sleep(0.3)
                assert not done(), cmd
            deadline = time.monotonic() + 30
            while not done() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert done(), cmd
    finally:
        viewer.close()


# ------------------------------------------------------------ headless
def test_headless_exports_match_jax(tmp_path):
    """save_model_views' PNGs decode to the JAX package's (written by
    cv2), the trajectory .ply is byte-equal, and stats_panel has the
    JAX keys and a fresh engine's values."""
    from kintinuous_tpu.config import tiny_test_config as jtiny
    from kintinuous_tpu.runtime.engine import SlamEngine as JEngine

    je, pe, _ = _pane_engines()
    pa = jheadless.save_model_views(str(tmp_path / "j"), je.tracker)
    pb = headless.save_model_views(str(tmp_path / "p"), pe.tracker)
    assert [p[len(str(tmp_path)) + 2:] for p in pa] == [p[len(str(tmp_path)) + 2:] for p in pb]
    for x, y in zip(pa, pb):
        xa, xb = cv2.imread(x)[:, :, ::-1].astype(int), _decode(open(y, "rb").read()).astype(int)
        assert (xa != xb).any(axis=-1).mean() <= 1e-3 and np.abs(xa - xb).max() <= 1
    poses = [np.eye(4) + 0.1 * k for k in range(5)]
    for mod, name in ((jheadless, "j.ply"), (headless, "p.ply")):
        mod.save_trajectory_ply(str(tmp_path / name), poses)
        mod.save_trajectory_ply(str(tmp_path / f"empty_{name}"), [])
    for stem in ("", "empty_"):
        assert (tmp_path / f"{stem}p.ply").read_bytes() == (tmp_path / f"{stem}j.ply").read_bytes()
    sa = jheadless.stats_panel(JEngine(jtiny(save_file=str(tmp_path / "js"))))
    sb = headless.stats_panel(SlamEngine(tiny_test_config(save_file=str(tmp_path / "ps")),
                                         device="cpu"))
    assert sb.keys() == sa.keys()
    assert {k: sb[k] for k in sb if k != "fps"} == {k: sa[k] for k in sa if k != "fps"}
