"""The port's own engine with online deformation, its own ORB
included, on the JAX gauntlet's lap (tests/test_gauntlet.py:103-162):
a rectangular lap around lap_scene's island with a partial second lap,
6 mm depth noise, ICP odometry, the gauntlet's configuration, on the
CPU. At least one loop is accepted and the deformed trajectory's ATE is
at most 0.4 x the tracker's (JAX's test asks 0.7 with OpenCV's ORB; the
port measured 1.03 cm -> 0.26 cm, a ratio of 0.25, with its dense loop
refinement, and 0.78 cm, a ratio of 0.75, without it). The tracker
runs the port's default fast step, the raycast kernel's plain version:
the JAX gauntlet's pallas=False selects the gather raycast, whose
tracker drifts less on this lap (0.59 cm -> 0.31 cm, a ratio of 0.53)."""

import numpy as np
import pytest
import torch

from kintinuous_tpu_torch.config import CameraIntrinsics, tiny_test_config
from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error
from kintinuous_tpu_torch.io.pcd import load_pcd
from kintinuous_tpu_torch.io.synth import generate_klg, lap_scene, lap_trajectory
from kintinuous_tpu_torch.io.tum import load_trajectory
from kintinuous_tpu_torch.runtime.engine import SlamEngine

torch.set_num_threads(2)

CAM = CameraIntrinsics(fx=90.0, fy=90.0, cx=80.0, cy=64.0, width=160, height=128)
ATE_RATIO = 0.4


@pytest.fixture(scope="module")
def lap_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("lap")
    log, gt = str(d / "lap.klg"), str(d / "lap.gt")
    poses = lap_trajectory(length=2.4, depth=1.8, step=0.06, turn_frames=18, warmup_frames=8)
    generate_klg(log, CAM, poses, scene=lap_scene(length=2.4, depth=1.8), depth_noise_mm=6.0,
                 gt_path=gt, color=True)
    cfg = tiny_test_config(
        camera=CAM, volume_size=4.0, volume_resolution=128, fast_mode=True, voxel_shift=8,
        pyramid_levels=4, icp_iterations=(0, 10, 5, 0), bilateral_radius=2,
        extraction_capacity=300_000, band_cap=2048, dynamic_cube=True,
        log_file=log, online_deformation=True, loop_throttle_s=0.0,
        place_rec_motion_thresh=0.15, loop_min_matches=20, save_file=str(d / "lap"))
    engine = SlamEngine(cfg, device="cpu").run()
    return engine, engine.save(), gt, len(poses)


def test_lap_tracks_and_shifts(lap_run):
    engine, _, _, n = lap_run
    tr = engine.tracker
    assert len(tr.poses) == n
    assert min(tr.stats["icp_count"][2:]) > 300, "ICP lost the lap"
    assert int((np.array(tr.shift_log) != 0).any(axis=1).sum()) >= 10


def test_loop_closure_pays_with_the_ports_own_orb(lap_run):
    engine, outs, gt, _ = lap_run
    md, pr = engine.deformation, engine.place_rec
    assert md.n_loops_accepted >= 1, f"no loop accepted: {pr.gate_stats}"
    assert pr.gate_stats["accepted"] == md.n_loops_accepted + md.n_loops_rejected
    gs, gp = load_trajectory(gt)
    tr = engine.tracker
    pre, _ = absolute_trajectory_error(gs, gp, np.array(tr.stamps_us) / 1e6, np.array(tr.poses))
    es, ep = load_trajectory(outs["poses"])
    post, _ = absolute_trajectory_error(gs, gp, es, ep)
    assert post <= ATE_RATIO * pre, f"loop closure did not pay: {pre * 100:.2f} -> {post * 100:.2f} cm"
    assert outs["cloud"].endswith("_opt.pcd")
    assert len(load_pcd(outs["cloud"])["points"]) > 10_000


def test_backend_stages_ran(lap_run):
    engine = lap_run[0]
    stats = engine.sw.stats()
    assert stats["PlaceRecognition"]["count"] == engine.place_rec.gate_stats["keyframes"]
    assert stats["Deformation"]["count"] >= engine.deformation.n_loops_accepted
    assert engine.backend_lag_ms >= 0.0
    assert all(kf.rgb_jpg == b"" for kf in engine.place_rec.keyframes)
