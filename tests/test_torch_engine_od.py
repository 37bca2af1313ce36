"""The engine with online deformation (-od), the JAX package's against
the port's, on a 160x128 lap `.klg` with colour.

Both replay the same drifted trajectory through -p (GroundTruthOdometry),
so both trackers place the same frames; the JAX side runs with
pallas=False (the port's plain fusion matches its integrate_fast,
tests/test_torch_integrate.py), both detectors are patched to the
same OpenCV ORB output, and the port's dense loop refinement, a stage
the JAX package lacks, is off (place_recognition.LOOP_REFINE_ITERS
empty). The port side runs through its CLI:
`-l lap.klg -p drift.txt --fast -dc -od -m -lt 0 --device cpu`, which
writes `.poses`, `_opt.pcd` and `_opt.ply`. They must agree on:
- the loops accepted (the same keyframe pairs);
- the optimised `.poses` within 2e-4 m (translation). The pose graph of
  each grows while the place-recognition worker runs, so the nodes a
  loop is optimised with depend on thread timing; measured in four
  runs: 2.3e-5 to 2.9e-5 m, and two JAX runs 1.7e-5 m apart. A planted
  fault, the port's loop constraints moved 5 mm, opens it to 5.3e-3 m;
- the `_opt.pcd` point count, exactly (equal in the four runs and under
  the fault). Its points are not compared: which slices a loop deforms
  and which arrive after it, re-based, also follows thread timing, and
  two JAX runs of this log put their points up to 0.38 m apart (mean
  13 mm to the nearest; the port against JAX: up to 0.34 m, mean 14 mm).
An -od engine checkpoint saved by either package loads into the other
with its pose graph, deformation graph, keyframe ring and vocabulary
intact."""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

import kintinuous_tpu.backend.place_recognition as JPR
import kintinuous_tpu.runtime.checkpoint as jck
import kintinuous_tpu_torch.backend.place_recognition as PR
import kintinuous_tpu_torch.runtime.checkpoint as pck
from kintinuous_tpu.config import CameraIntrinsics as JCam
from kintinuous_tpu.config import tiny_test_config as jtiny
from kintinuous_tpu.runtime.engine import SlamEngine as JEngine
from kintinuous_tpu_torch import cli
from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error
from kintinuous_tpu_torch.io.pcd import load_pcd
from kintinuous_tpu_torch.io.ply import load_ply
from kintinuous_tpu_torch.io.synth import generate_klg, lap_scene, lap_trajectory
from kintinuous_tpu_torch.io.tum import load_trajectory, save_trajectory
from kintinuous_tpu_torch.runtime.engine import SlamEngine
from tests.test_torch_package import port_cfg

torch.set_num_threads(2)

CAM_KW = dict(fx=90.0, fy=90.0, cx=80.0, cy=64.0, width=160, height=128)
POSE_TOL_M = 2e-4


def cv_orb(gray, n_features=500):
    g = gray.cpu().numpy() if isinstance(gray, torch.Tensor) else gray
    kps, desc = cv2.ORB_create(nfeatures=n_features, fastThreshold=12).detectAndCompute(g, None)
    if desc is None:
        return np.zeros((0, 2), np.float32), np.zeros((0, 32), np.uint8)
    return np.array([k.pt for k in kps], np.float32), desc


def drifted(poses, yaw_deg=0.12, slide_m=0.002):
    """The lap as a drifting tracker would report it: each step's motion
    followed by a small yaw and a sideways slide."""
    c, s = np.cos(np.deg2rad(yaw_deg)), np.sin(np.deg2rad(yaw_deg))
    err = np.eye(4)
    err[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    err[0, 3] = slide_m
    out = [poses[0]]
    for a, b in zip(poses[:-1], poses[1:]):
        out.append(out[-1] @ np.linalg.inv(a) @ b @ err)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("od")
    log, gt, drift = str(d / "lap.klg"), str(d / "lap.gt"), str(d / "drift.txt")
    poses = lap_trajectory(length=2.0, depth=1.6, step=0.1, turn_frames=10, warmup_frames=4,
                           revisit_frac=0.25)
    generate_klg(log, cli.CameraIntrinsics(**CAM_KW), poses,
                 scene=lap_scene(length=2.0, depth=1.6), depth_noise_mm=3.0, gt_path=gt,
                 color=True)
    save_trajectory(drift, [i / 30.0 for i in range(len(poses))], drifted(poses))
    (d / "calib.txt").write_text("90 90 80 64 160 128\n")
    jcfg = jtiny(
        camera=JCam(**CAM_KW), volume_size=4.0, volume_resolution=64, fast_mode=True,
        voxel_shift=8, pyramid_levels=4, icp_iterations=(0, 10, 5, 0), bilateral_radius=2,
        extraction_capacity=300_000, band_cap=2048, pallas=False, dynamic_cube=True,
        log_file=log, trajectory_file=drift, online_deformation=True, loop_throttle_s=0.0,
        loop_min_matches=20, place_rec_motion_thresh=0.3, mesh=True, color_angle_weight=False,
        save_file=str(d / "jax"))
    mp = pytest.MonkeyPatch()
    mp.setattr(PR, "detect_orb", cv_orb)
    mp.setattr(JPR, "detect_orb", cv_orb)
    mp.setattr(PR, "LOOP_REFINE_ITERS", ())
    try:
        jeng = JEngine(jcfg).run()
        jout = jeng.save()
        # the port: its CLI, with the test-scale fields the flags do not
        # reach set as the JAX configuration has them
        argv = ["-l", log, "-p", drift, "--fast", "-dc", "-od", "-m", "-lt", "0",
                "--device", "cpu", "-o", str(d / "port"), "-c", str(d / "calib.txt"),
                "-s", "4", "--resolution", "64", "-t", "8", "-d"]
        scale = {k: getattr(jcfg, k) for k in (
            "pyramid_levels", "icp_iterations", "icp_fast_iterations", "bilateral_radius",
            "extraction_capacity", "band_cap", "pallas", "loop_min_matches",
            "place_rec_motion_thresh")}
        config = cli._config
        mp.setattr(cli, "_config", lambda a: config(a).replace(**scale))
        seen = {}
        save = SlamEngine.save

        def keep(self, *a, **k):
            seen["engine"] = self
            return save(self, *a, **k)

        mp.setattr(SlamEngine, "save", keep)
        assert cli.main(argv) == 0
        pcfg = cli.build_config(argv)
    finally:
        mp.undo()
    return dict(d=d, gt=gt, jcfg=jcfg, jeng=jeng, jout=jout, peng=seen["engine"],
                pcfg=pcfg, argv=argv)


def test_the_cli_flags_give_the_jax_configuration(runs):
    want = dataclasses.asdict(port_cfg(runs["jcfg"]))
    got = dataclasses.asdict(runs["peng"].cfg)
    for k in ("save_file",):
        want.pop(k), got.pop(k)
    assert got == want


def test_od_cli_writes_poses_opt_pcd_and_opt_ply(runs):
    d, eng = runs["d"], runs["peng"]
    assert eng.deformation.n_loops_accepted >= 1
    stamps, _ = load_trajectory(str(d / "port.poses"))
    assert len(stamps) == len(eng.tracker.poses)
    assert len(load_pcd(str(d / "port_opt.pcd"))["points"]) > 1000
    mesh = load_ply(str(d / "port_opt.ply"))
    assert len(mesh["faces"]) > 100 and len(mesh["vertices"]) > 100
    assert not (d / "port.pcd").exists() and not (d / "port.ply").exists()


def test_the_same_loops_as_jax(runs):
    jl = [(e["kf_t1"], e["kf_t2"]) for e in runs["jeng"].deformation.loop_log if e["accepted"]]
    pl = [(e["kf_t1"], e["kf_t2"]) for e in runs["peng"].deformation.loop_log if e["accepted"]]
    assert pl == jl and len(pl) >= 1
    assert runs["peng"].place_rec.gate_stats["keyframes"] == \
        runs["jeng"].place_rec.gate_stats["keyframes"]


def test_optimised_poses_and_map_follow_jax(runs):
    d = runs["d"]
    ps, pp = load_trajectory(str(d / "port.poses"))
    js, jp = load_trajectory(runs["jout"]["poses"])
    np.testing.assert_array_equal(ps, js)
    assert np.abs(pp[:, :3, 3] - jp[:, :3, 3]).max() < POSE_TOL_M
    n_p = len(load_pcd(str(d / "port_opt.pcd"))["points"])
    n_j = len(load_pcd(runs["jout"]["cloud"])["points"])
    assert n_p == n_j
    # the correction pays: the deformed trajectory is closer to the truth
    gs, gp = load_trajectory(runs["gt"])
    tr = runs["peng"].tracker
    pre, _ = absolute_trajectory_error(gs, gp, np.array(tr.stamps_us) / 1e6, np.array(tr.poses))
    post, _ = absolute_trajectory_error(gs, gp, ps, pp)
    assert post < pre


def _same_backend(a, b):
    """Pose graph, deformation graph, keyframe ring and vocabulary equal."""
    ga, gb = a.deformation.graph, b.deformation.graph
    assert ga.times == gb.times and ga._fi == gb._fi and ga._fj == gb._fj
    np.testing.assert_array_equal(np.array(ga.poses), np.array(gb.poses))
    np.testing.assert_array_equal(np.array(ga._fZ), np.array(gb._fZ))
    assert ga._fw == gb._fw and ga._floop == gb._floop
    da, db = a.deformation.dgraph, b.deformation.dgraph
    np.testing.assert_array_equal(np.array(da.g), np.array(db.g))
    np.testing.assert_array_equal(da.A, db.A)
    np.testing.assert_array_equal(da.t, db.t)
    assert da.times == db.times
    ma, mb = a.deformation, b.deformation
    assert (ma.n_loops_accepted, ma.n_loops_rejected, ma._last_time) == \
        (mb.n_loops_accepted, mb.n_loops_rejected, mb._last_time)
    assert sorted(ma._raw_pose) == sorted(mb._raw_pose)
    assert len(ma.slices) == len(mb.slices) and len(ma.mesh_patches) == len(mb.mesh_patches)
    for x, y in zip(ma.slices, mb.slices):
        np.testing.assert_array_equal(x.processed["points"], y.processed["points"])
    pa, pb = a.place_rec, b.place_rec
    np.testing.assert_array_equal(pa.vocab.centroids, pb.vocab.centroids)
    assert (pa._next_kf_id, pa._last_loop_time_us) == (pb._next_kf_id, pb._last_loop_time_us)
    assert len(pa.keyframes) == len(pb.keyframes) > 0
    for x, y in zip(pa.keyframes, pb.keyframes):
        assert (x.kf_id, x.timestamp_us, x.depth_z, x.rgb_jpg) == \
            (y.kf_id, y.timestamp_us, y.depth_z, y.rgb_jpg)
        np.testing.assert_array_equal(x.descriptors, y.descriptors)
        np.testing.assert_array_equal(x.points3d, y.points3d)
    np.testing.assert_array_equal(a._last_kf_pose, b._last_kf_pose)


def test_a_jax_od_checkpoint_loads_in_the_port(runs):
    ck = str(runs["d"] / "jax_ck.npz")
    jck.save_engine_checkpoint(ck, runs["jeng"])
    fresh = SlamEngine(port_cfg(runs["jcfg"]), device="cpu")
    pck.load_engine_checkpoint(ck, fresh)
    _same_backend(fresh, runs["jeng"])
    assert any(kf.rgb_jpg for kf in fresh.place_rec.keyframes)  # JAX keeps JPEG colour
    kf = next(kf for kf in fresh.place_rec.keyframes if kf.rgb_jpg)
    assert kf.rgb.shape == (128, 160, 3)


def test_the_ports_od_checkpoint_loads_in_jax_and_in_the_port(runs):
    ck = str(runs["d"] / "port_ck.npz")
    pck.save_engine_checkpoint(ck, runs["peng"])
    back = JEngine(runs["jcfg"])
    jck.load_engine_checkpoint(ck, back)
    _same_backend(back, runs["peng"])
    again = SlamEngine(runs["peng"].cfg, device="cpu")
    pck.load_engine_checkpoint(ck, again)
    _same_backend(again, runs["peng"])
    assert again._frames_done == runs["peng"]._frames_done
