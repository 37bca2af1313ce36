"""Port vs JAX: the offline runtime. The engine (batched and per frame)
and the CLI on tests/test_engine.py's .klg orbit, the slice processor,
and the log, trajectory and point-cloud formats, which each package
must read as the other writes them."""

import json
import socket

import numpy as np
import pytest
import torch

from kintinuous_tpu.backend import slice_proc as jsp
from kintinuous_tpu.config import tiny_test_config
from kintinuous_tpu.eval.ate import absolute_trajectory_error
from kintinuous_tpu.io import klg as jklg
from kintinuous_tpu.io import pcd as jpcd
from kintinuous_tpu.io import synth as jsynth
from kintinuous_tpu.io import tum as jtum
from kintinuous_tpu.runtime.engine import SlamEngine as JEngine
from kintinuous_tpu.tracking.odometry import GroundTruthOdometry as JGT
from kintinuous_tpu_torch import cli
from kintinuous_tpu_torch.backend import native_ops
from kintinuous_tpu_torch.backend import slice_proc as psp
from kintinuous_tpu_torch.io import klg as pklg
from kintinuous_tpu_torch.io import pcd as ppcd
from kintinuous_tpu_torch.io import synth as psynth
from kintinuous_tpu_torch.io import tum as ptum
from kintinuous_tpu_torch.runtime import checkpoint as pck
from kintinuous_tpu_torch.runtime.engine import SlamEngine
from kintinuous_tpu_torch.runtime.pipeline import run_slam
from kintinuous_tpu_torch.runtime.stopwatch import Stopwatch
from kintinuous_tpu_torch.tracking.odometry import GroundTruthOdometry
from kintinuous_tpu_torch.tracking.tracker import CloudSlice
from tests.test_engine import CAM, seq  # noqa: F401  (the .klg orbit fixture)
from tests.test_torch_package import port_cam, port_cfg

torch.set_num_threads(2)


def engine_cfg(path, out, **kw):
    return tiny_test_config(camera=CAM, log_file=path, static_mode=True, fast_mode=True,
                            volume_resolution=64, voxel_shift=8, band_cap=512,
                            save_file=str(out), **kw)


def ate_of(gt, poses_path):
    stamps, gt_poses = jtum.load_trajectory(gt)
    est_s, est_p = jtum.load_trajectory(poses_path)
    return absolute_trajectory_error(stamps, gt_poses, est_s, est_p)


@pytest.fixture(scope="module")
def jax_engine_poses(seq, tmp_path_factory):  # noqa: F811
    """The JAX engine's .poses on the orbit (fast batched; the TPU
    kernels in interpret mode, as the port's tracker tests hold it)."""
    path, gt, _ = seq
    out = tmp_path_factory.mktemp("jax_engine") / "out"
    outs = JEngine(engine_cfg(path, out, pallas=True)).run().save()
    return jtum.load_trajectory(outs["poses"])


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "per_frame"])
def test_engine_tracks_the_orbit_and_follows_jax(seq, tmp_path, jax_engine_poses,  # noqa: F811
                                                 batched):
    """tests/test_engine.py:218-234 and :356-374 through the port: 12
    poses, ATE < 0.8 cm, a .pcd with points. Its poses agree with the
    JAX engine's to 1e-3 (the port's tracked orbit against the JAX
    tracker: the two ICPs sum in another order), and its TUM file holds
    them to the format's 1e-6."""
    path, gt, _ = seq
    cfg = port_cfg(engine_cfg(path, tmp_path / "out", offline_batched=batched))
    engine = SlamEngine(cfg, device="cpu").run()
    outs = engine.save()
    ate, n = ate_of(gt, outs["poses"])
    assert n == 12 and ate < 0.008, f"engine ATE {ate * 100:.2f} cm"
    assert len(ppcd.load_pcd(outs["cloud"])["points"]) > 100
    stamps, poses = ptum.load_trajectory(outs["poses"])
    np.testing.assert_allclose(stamps, jax_engine_poses[0], atol=1e-6)
    np.testing.assert_allclose(poses, jax_engine_poses[1], atol=1e-3)
    stats = engine.sw.stats()
    assert stats["SliceProcessor"]["count"] >= 1
    assert stats["processFrame"]["count"] == (5 if batched else 12)  # 1 + batch + 3 tail


def test_engine_checkpoint_round_trip(seq, tmp_path):  # noqa: F811
    path, _, _ = seq
    cfg = port_cfg(engine_cfg(path, tmp_path / "out", total_num_frames=6))
    a = SlamEngine(cfg, device="cpu").run()
    ck = str(tmp_path / "eng.npz")
    pck.save_engine_checkpoint(ck, a)
    b = SlamEngine(cfg, device="cpu")
    pck.load_engine_checkpoint(ck, b)
    assert torch.equal(b.tracker.state.vol.cw, a.tracker.state.vol.cw)
    assert torch.equal(b.tracker.state.logical.view(torch.int16),
                       a.tracker.state.logical.view(torch.int16))
    assert b._frames_done == a._frames_done == 6
    assert len(b.slice_proc.processed) == len(a.slice_proc.processed) >= 1
    np.testing.assert_array_equal(b.slice_proc.processed[-1].processed["points"],
                                  a.slice_proc.processed[-1].processed["points"])


def test_cli_fast_run_writes_the_poses(seq, tmp_path):  # noqa: F811
    """tests/test_engine.py:52-67 with --fast, on the CPU; --dump-tsdf
    writes the JAX CLI's npz and --profile-dir a chrome trace."""
    path, _, _ = seq
    calib = tmp_path / "calib.txt"
    calib.write_text("70 70 40 30 80 60\n")
    out = tmp_path / "cliout"
    rc = cli.main(["-l", path, "-c", str(calib), "-sm", "-n", "6", "-s", "3.0",
                   "--resolution", "64", "--fast", "-o", str(out), "--device", "cpu",
                   "--dump-tsdf", str(tmp_path / "tsdf.npz"),
                   "--profile-dir", str(tmp_path / "prof")])
    assert rc == 0
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    stamps, _ = ptum.load_trajectory(f"{out}.poses")
    assert len(stamps) == 6
    dump = np.load(tmp_path / "tsdf.npz")
    assert dump["tsdf"].shape == (512, 4, 128) and dump["cw"].dtype == np.uint32
    assert bool(dump["blocked"])


@pytest.mark.parametrize("flags,names", [
    (["-live", "tcp://localhost:1"], "-live"), (["--viz-port", "8000"], "--viz-port"),
    (["--devices", "2"], "--devices"), (["--num-processes", "2"], "--num-processes")],
    ids=["live", "viz", "devices", "num_processes"])
def test_cli_unported_flags_raise(flags, names):
    """What the port does not run yet raises, naming the flag."""
    with pytest.raises(NotImplementedError, match=names):
        cli.build_config(["-l", "seq.klg", "--fast", *flags])


@pytest.mark.parametrize("flag,field", [("-r", "rgbd_odometry"), ("-ri", "icp_plus_rgbd"),
                                        ("-ftf", "frame_to_frame_rgbd"), ("-m", "mesh")],
                         ids=["r", "ri", "ftf", "m"])
def test_cli_rgbd_and_mesh_flags_build_a_config(flag, field):
    """-r, -ri, -ftf and -m (without -od) are ported: the flag sets its
    field, as in the JAX package's CLI, and the engine accepts it."""
    from kintinuous_tpu import cli as jcli

    argv = ["-l", "seq.klg", "--fast", flag] + (["-ri"] if flag == "-ftf" else [])
    cfg = cli.build_config(argv)
    assert getattr(cfg, field) is True and getattr(jcli.build_config(argv), field) is True
    engine = SlamEngine(cfg.replace(camera=CAM, volume_resolution=32), device="cpu")
    assert (engine.tracker.state.rgbd is not None) == (flag != "-m")


def test_engine_without_a_card_raises_unless_cpu_is_asked(seq, monkeypatch, tmp_path):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_cfg(engine_cfg(seq[0], tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-l", seq[0], "--fast", "-o", str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_slam(cfg)
    assert SlamEngine(cfg, device="cpu").tracker.device.type == "cpu"


def test_run_slam_replays_ground_truth(seq, tmp_path):  # noqa: F811
    """The pipeline's per-frame loop with -p replay: the poses follow the
    ground truth to f32 composition (< 0.1 mm)."""
    path, gt, _ = seq
    cfg = port_cfg(engine_cfg(path, tmp_path / "o", trajectory_file=gt,
                              total_num_frames=6))
    res = run_slam(cfg, poses_path=str(tmp_path / "p.poses"), device="cpu")
    assert res.n_frames == 6 and len(res.poses) == 6 and res.fps > 0
    assert res.slices[-1].dimension == "FINAL"
    ate, n = ate_of(gt, str(tmp_path / "p.poses"))
    assert n == 6 and ate < 1e-4


def slice_of(seed, n=4000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * pts[:, 0] ** 2 + 0.01 * rng.standard_normal(n)  # a curved sheet
    pose = np.eye(4)
    pose[:3, 3] = [0.1, -0.2, 1.5]
    return dict(points=pts, colors=rng.integers(0, 255, (n, 3), dtype=np.uint8),
                weights=rng.integers(0, 20, n).astype(np.float32), pose=pose,
                dimension="XPlus", timestamp_us=5, frame_index=1)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_slice_processor_matches_jax(native, monkeypatch):
    """Same slice through both packages' SliceProcessor: the same points,
    colours and normals (within 1e-5), on the native library's path and
    on the numpy/scipy path."""
    from kintinuous_tpu.backend import native_ops as jnative
    from kintinuous_tpu.tracking.tracker import CloudSlice as JSlice

    if not native:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(native_ops, "voxel_downsample", lambda *a, **k: None)
    elif not (native_ops.available() and jnative.available()):
        pytest.skip("the native cloud library did not build here")
    cfg = tiny_test_config(camera=CAM, volume_resolution=64)
    a = jsp.SliceProcessor(cfg).process(JSlice(**slice_of(0)))
    b = psp.SliceProcessor(port_cfg(cfg)).process(CloudSlice(**slice_of(0)))
    assert len(b.processed["points"]) > 100
    for k in ("points", "normals", "weights"):
        np.testing.assert_allclose(b.processed[k], a.processed[k], atol=1e-5)
    np.testing.assert_array_equal(b.processed["colors"], a.processed["colors"])


def test_slice_processor_save_deoverlaps_like_jax(tmp_path):
    cfg = tiny_test_config(camera=CAM, volume_resolution=64)
    ja, pb = jsp.SliceProcessor(cfg), psp.SliceProcessor(port_cfg(cfg))
    from kintinuous_tpu.tracking.tracker import CloudSlice as JSlice

    for seed in (1, 2):
        ja.process(JSlice(**slice_of(seed)))
        pb.process(CloudSlice(**slice_of(seed)))
    na = ja.save(str(tmp_path / "a.pcd"), deoverlap=True)
    nb = pb.save(str(tmp_path / "b.pcd"), deoverlap=True)
    assert na == nb > 0
    a, b = jpcd.load_pcd(str(tmp_path / "a.pcd")), ppcd.load_pcd(str(tmp_path / "b.pcd"))
    np.testing.assert_allclose(b["points"], a["points"], atol=1e-6)
    np.testing.assert_array_equal(b["colors"], a["colors"])
    np.testing.assert_allclose(pb.local_payload(), ja.local_payload(), atol=1e-5)


def test_logs_trajectories_and_clouds_cross_between_the_packages(tmp_path):
    """Each package reads what the other writes: .klg (with and without
    colour), TUM trajectories and .pcd clouds; generate_klg renders the
    same depth in both."""
    poses = jsynth.orbit_trajectory(3, radius=0.1, angle_deg=5.0)
    jsynth.generate_klg(str(tmp_path / "j.klg"), CAM, poses, depth_noise_mm=2.0,
                        gt_path=str(tmp_path / "j.gt"))
    psynth.generate_klg(str(tmp_path / "p.klg"), port_cam(CAM), poses,
                        depth_noise_mm=2.0, gt_path=str(tmp_path / "p.gt"))
    psynth.generate_klg(str(tmp_path / "pc.klg"), port_cam(CAM), poses, color=True)
    with jklg.KlgLogReader(str(tmp_path / "p.klg"), 80, 60) as r:
        from_port = list(r)
    with pklg.KlgLogReader(str(tmp_path / "j.klg"), 80, 60) as r:
        from_jax = list(r)
    with pklg.KlgLogReader(str(tmp_path / "pc.klg"), 80, 60) as r:
        coloured = list(r)
    assert len(from_port) == len(from_jax) == 3
    for a, b, c in zip(from_port, from_jax, coloured):
        assert a.timestamp == b.timestamp and a.rgb is None and b.rgb is not None
        np.testing.assert_array_equal(a.depth, b.depth)
        assert c.rgb.shape == (60, 80, 3)
    np.testing.assert_allclose(jtum.load_trajectory(str(tmp_path / "p.gt"))[1],
                               ptum.load_trajectory(str(tmp_path / "j.gt"))[1])
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (50, 3), dtype=np.uint8)
    ppcd.save_pcd(str(tmp_path / "c.pcd"), pts, cols, -pts)
    back = jpcd.load_pcd(str(tmp_path / "c.pcd"))
    np.testing.assert_array_equal(back["points"], pts)
    np.testing.assert_array_equal(back["colors"], cols)
    np.testing.assert_array_equal(back["normals"], -pts)


def test_ground_truth_odometry_matches_jax():
    poses = np.array(jsynth.orbit_trajectory(6, radius=0.1, angle_deg=5.0))
    stamps = np.arange(6) / 30.0
    a, b = JGT(stamps, poses), GroundTruthOdometry(stamps, poses)
    for ts in [0, 33333, 66667, 90000_000, 100000, 133333]:
        np.testing.assert_array_equal(b.delta(ts), a.delta(ts))
        assert b.has_pose(ts) == a.has_pose(ts)


def test_stopwatch_udp_and_stats():
    sw = Stopwatch(send_interval_s=0.0)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
        sock.settimeout(2.0)
        sw.port = sock.getsockname()[1]
        with sw.span("unit_test_span"):
            pass
        payload = json.loads(sock.recvfrom(65536)[0].decode())
        assert "unit_test_span" in payload["timings"]
        sw.gauge("lag.x", 3.0)
        assert sw.stats()["unit_test_span"]["count"] == 1
        assert sw.max_gauge() == 3.0
    finally:
        sock.close()
        sw.close()
