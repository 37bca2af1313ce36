"""The port's MapDeformation (backend/deform_runner.py, torch on the
CPU) against the JAX package's on the scenarios of
tests/test_deform_runner.py, fed the same poses, slices, mesh patches
and loops: the same accept/reject decisions, pose-graph poses within
atol 1e-4, chi2 values within 1e-3 relative (plus 1e-4), and the saved
trajectory, cloud and mesh. The pooled slice points and mesh vertices
agree within 1e-2 m: the deformation graph's 10 GN iterations of 60
float32 CG steps leave its weakly constrained directions (the node
affines) where rounding puts them, in either package (on the first
scenario the float32 solve sits 1.7 cm from the float64 one at the
vertices). Measured gaps between the packages over these scenarios:
slice points 4.9 mm, mesh vertices 8.6 mm, slice poses 2.9e-6 m, graph
poses 2.9e-6 m. A planted fault, the deformation's loop-inlier targets
moved 1.5 cm, opens the point and vertex gaps to 1.7 and 1.9 cm."""

import numpy as np
import pytest
import torch

from kintinuous_tpu.backend.deform_runner import MapDeformation as JMap
from kintinuous_tpu.backend.meshing import MeshPatch as JPatch
from kintinuous_tpu.backend.place_recognition import LoopConstraint as JLoop
from kintinuous_tpu.config import tiny_test_config as jtiny
from kintinuous_tpu.tracking.tracker import CloudSlice as JSlice
from kintinuous_tpu_torch.backend.deform_runner import MapDeformation
from kintinuous_tpu_torch.backend.meshing import MeshPatch
from kintinuous_tpu_torch.backend.place_recognition import LoopConstraint
from kintinuous_tpu_torch.config import tiny_test_config
from kintinuous_tpu_torch.geometry import se3
from kintinuous_tpu_torch.io.pcd import load_pcd
from kintinuous_tpu_torch.io.ply import load_ply
from kintinuous_tpu_torch.tracking.tracker import CloudSlice

torch.set_num_threads(2)

POSE_ATOL = 1e-4
POINT_ATOL = 1e-2


def exp(xi):
    return se3.exp_se3(torch.tensor(xi, dtype=torch.float32)).numpy().astype(np.float64)


def drifting_square(n_side=10, step=0.3, drift_deg=1.0):
    """A square loop with yaw drift; ends where it started."""
    gt, est = [np.eye(4)], [np.eye(4)]
    yaw_step = np.deg2rad(90.0) / n_side
    step_gt = exp([0, 0, 0, step, 0, 0])
    for _ in range(4):
        for k in range(n_side):
            turn = exp([0, yaw_step if k == n_side - 1 else 0, 0, 0, 0, 0])
            gt.append(gt[-1] @ step_gt @ turn)
            est.append(est[-1] @ step_gt @ turn @ exp([0, np.deg2rad(drift_deg), 0, 0, 0, 0]))
    return gt, est


def slices(cls, points, ts, pose=None):
    n = len(points)
    proc = {"points": points.astype(np.float32), "colors": np.full((n, 3), 128, np.uint8),
            "normals": np.tile(np.float32([0, 0, 1]), (n, 1)),
            "weights": np.full(n, 10.0)}
    return cls(points=points.astype(np.float32), colors=proc["colors"].copy(),
               weights=proc["weights"].copy(), dimension="XPlus",
               pose=np.eye(4) if pose is None else np.asarray(pose, np.float64),
               timestamp_us=int(ts), frame_index=0, processed={k: v.copy() for k, v in proc.items()})


def patch(cls, T, ts, rng):
    v = (T[:3, 3][None, :] + rng.uniform(-0.2, 0.2, (12, 3))).astype(np.float32)
    return cls(vertices=v, colors=np.full((12, 3), 90, np.uint8),
               faces=np.arange(12, dtype=np.int32).reshape(4, 3), timestamp_us=int(ts))


def feed(cfg_kw, drift_deg=1.0, with_mesh=True, seed=0):
    """Both runners fed the drifting square, a slice and a mesh patch a pose."""
    port = MapDeformation(tiny_test_config(**cfg_kw), device="cpu")
    jax = JMap(jtiny(**cfg_kw))
    gt, est = drifting_square(drift_deg=drift_deg)
    times = [int(k * 1e6 / 3) for k in range(len(gt))]
    rng = np.random.default_rng(seed)
    for T, ts in zip(est, times):
        pts = T[:3, 3][None, :] + rng.uniform(-0.1, 0.1, (30, 3))
        pseed = int(rng.integers(1 << 30))
        for md, sl, mp in ((port, CloudSlice, MeshPatch), (jax, JSlice, JPatch)):
            md.add_frame_pose(ts, T)
            md.add_slice(slices(sl, pts, ts))
            if with_mesh:
                md.add_mesh_patch(patch(mp, T, ts, np.random.default_rng(pseed)))
    return port, jax, gt, est, times


def loop(cls, gt, times, i, j, seed=0, err=None):
    rng = np.random.default_rng(seed)
    T = np.linalg.inv(gt[i]) @ gt[j]
    if err is not None:
        T = err
    inl1 = rng.uniform(-0.5, 0.5, (50, 3))
    inl2 = (inl1 - T[:3, 3]) @ T[:3, :3]
    return cls(time1=times[i], time2=times[j], T_1_2=T, inliers1=inl1, inliers2=inl2,
               icp_score=0.001)


def same_state(port, jax):
    assert port.n_loops_accepted == jax.n_loops_accepted
    assert port.n_loops_rejected == jax.n_loops_rejected
    assert port.graph.times == jax.graph.times
    np.testing.assert_allclose(np.array(port.graph.poses), np.array(jax.graph.poses),
                               atol=POSE_ATOL)
    assert len(port.loop_log) == len(jax.loop_log)
    for a, b in zip(port.loop_log, jax.loop_log):
        assert a["accepted"] == b["accepted"]
        assert (a["t1"], a["t2"], a["kf_t1"], a["kf_t2"], a["n_nodes"]) == \
            (b["t1"], b["t2"], b["kf_t1"], b["kf_t2"], b["n_nodes"])
        for k in ("chi2", "chi2_before", "chi2_delta"):
            assert a[k] == pytest.approx(b[k], rel=1e-3, abs=1e-4), k
        assert a["max_node_delta_m"] == pytest.approx(b["max_node_delta_m"], abs=POSE_ATOL)
    for a, b in zip(port.slices, jax.slices):
        np.testing.assert_allclose(a.processed["points"], b.processed["points"],
                                   atol=POINT_ATOL)
        np.testing.assert_allclose(a.pose, b.pose, atol=POSE_ATOL)
    for a, b in zip(port.mesh_patches, jax.mesh_patches):
        np.testing.assert_allclose(a.vertices, b.vertices, atol=POINT_ATOL)
    np.testing.assert_allclose(np.array(port.dgraph.g), np.array(jax.dgraph.g), atol=POSE_ATOL)


def test_loop_closure_deforms_map_like_jax():
    port, jax, gt, est, times = feed(dict(isam_thresh=100.0, dense_sampling_rate=0.5))
    before = np.linalg.norm(port.graph.poses[-1][:3, 3] - gt[-1][:3, 3])
    assert before > 0.2
    assert port.add_loop(loop(LoopConstraint, gt, times, 0, -1))
    assert jax.add_loop(loop(JLoop, gt, times, 0, -1))
    same_state(port, jax)
    assert np.linalg.norm(port.graph.poses[-1][:3, 3] - gt[-1][:3, 3]) < before * 0.5
    last = port.slices[-1]
    assert np.linalg.norm(last.processed["points"].mean(axis=0) - last.pose[:3, 3]) < 0.4


def test_late_slice_and_patch_rebased_like_jax():
    port, jax, gt, est, times = feed(dict(isam_thresh=100.0, dense_sampling_rate=0.5), seed=1)
    port.add_loop(loop(LoopConstraint, gt, times, 0, -1, seed=1))
    jax.add_loop(loop(JLoop, gt, times, 0, -1, seed=1))
    raw_next = est[-1] @ exp([0, 0, 0, 0.3, 0, 0])
    ts_next = times[-1] + int(1e6 / 3)
    pts = raw_next[:3, 3][None, :] + np.random.default_rng(5).uniform(-0.1, 0.1, (30, 3))
    for md, sl, mp in ((port, CloudSlice, MeshPatch), (jax, JSlice, JPatch)):
        md.add_frame_pose(ts_next, raw_next)
        md.add_slice(slices(sl, pts, ts_next, pose=raw_next))
        md.add_mesh_patch(patch(mp, raw_next, ts_next, np.random.default_rng(6)))
    same_state(port, jax)
    corrected = port.graph.poses[port.graph.node_id(ts_next)]
    assert np.linalg.norm(raw_next[:3, 3] - corrected[:3, 3]) > 0.2
    late = port.slices[-1]
    assert np.linalg.norm(late.processed["points"].mean(axis=0) - corrected[:3, 3]) < 0.15
    np.testing.assert_allclose(late.pose[:3, 3], corrected[:3, 3], atol=0.1)


@pytest.mark.parametrize("fast_loops", [False, True])
def test_bad_loop_rejected_and_rolled_back_like_jax(fast_loops):
    port, jax, gt, est, times = feed(dict(isam_thresh=0.5, fast_loops=fast_loops,
                                          dense_sampling_rate=0.5), drift_deg=0.0,
                                     with_mesh=False)
    before = [p.copy() for p in port.graph.poses]
    bad = np.eye(4)
    bad[:3, 3] = [5.0, 5.0, 0.0]
    for md, cls in ((port, LoopConstraint), (jax, JLoop)):
        c = cls(time1=times[0], time2=times[-1], T_1_2=bad, inliers1=np.zeros((0, 3)),
                inliers2=np.zeros((0, 3)), icp_score=0.001)
        assert not md.add_loop(c)
    same_state(port, jax)
    assert port.n_loops_rejected == 1
    for b, a in zip(before, port.graph.poses):
        np.testing.assert_allclose(a, b, atol=0.05)
    if fast_loops:  # poses closer than dense_sampling_rate are skipped
        assert len(port.graph.poses) < len(times)


def test_two_loops_then_saves(tmp_path):
    """Two accepted loops, then the optimised trajectory, the deformed
    cloud and the deformed mesh, as the JAX runner writes them."""
    port, jax, gt, est, times = feed(dict(isam_thresh=100.0, dense_sampling_rate=0.5), seed=2)
    for i, j in ((0, -1), (5, 35)):
        assert port.add_loop(loop(LoopConstraint, gt, times, i, j, seed=3))
        assert jax.add_loop(loop(JLoop, gt, times, i, j, seed=3))
    same_state(port, jax)
    ts_p, poses_p = port.optimised_trajectory()
    ts_j, poses_j = jax.optimised_trajectory()
    np.testing.assert_array_equal(ts_p, ts_j)
    np.testing.assert_allclose(np.array(poses_p), np.array(poses_j), atol=POSE_ATOL)
    assert port.save_cloud(str(tmp_path / "p_opt.pcd")) == jax.save_cloud(
        str(tmp_path / "j_opt.pcd")) == 30 * len(times)
    a, b = load_pcd(str(tmp_path / "p_opt.pcd")), load_pcd(str(tmp_path / "j_opt.pcd"))
    np.testing.assert_allclose(a["points"], b["points"], atol=POINT_ATOL)
    port.save_mesh(str(tmp_path / "p_opt.ply"))
    jax.save_mesh(str(tmp_path / "j_opt.ply"))
    ma, mb = load_ply(str(tmp_path / "p_opt.ply")), load_ply(str(tmp_path / "j_opt.ply"))
    np.testing.assert_allclose(ma["vertices"], mb["vertices"], atol=POINT_ATOL)
    np.testing.assert_array_equal(ma["faces"], mb["faces"])
    pts, cols = port.pool_points()
    assert pts.shape == (30 * len(times), 3) and cols.dtype == np.uint8
    assert MapDeformation(tiny_test_config(), device="cpu").save_cloud(
        str(tmp_path / "e.pcd")) == 0


def test_the_runner_refuses_several_processes():
    """The runner solves in one process (the engine refuses -od with
    several): inside an initialised gloo group (here of one process),
    num_processes=2 still builds the one-process PoseGraph. The
    distributed pose graph's solve in that group equals PoseGraph's."""
    import socket

    import torch.distributed as dist

    from kintinuous_tpu_torch.backend.pose_graph import PoseGraph
    from kintinuous_tpu_torch.parallel.multihost import DistributedPoseGraph

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        md = MapDeformation(tiny_test_config(num_processes=2, process_id=0,
                                             coordinator=f"127.0.0.1:{port}"), device="cpu")
        assert type(md.graph) is PoseGraph
        dist_graph, ref = DistributedPoseGraph(device="cpu"), PoseGraph(device="cpu")
        for g in (dist_graph, ref):
            g.add_node(0, np.eye(4))
            step = np.eye(4)
            step[:3, 3] = [0.1, 0.0, 0.0]
            g.add_odometry(0, 1, step)
            g.add_odometry(1, 2, step)
            g.add_loop(2, 0, np.linalg.inv(step @ step @ step))
        assert abs(dist_graph.optimise(5) - ref.optimise(5)) <= 1e-6
        np.testing.assert_allclose(np.array(dist_graph.poses), np.array(ref.poses), atol=1e-6)
    finally:
        dist.destroy_process_group()


def test_three_threads_calling_in_keep_the_runner_consistent():
    """The frame loop (add_frame_pose), the slice worker (add_slice,
    add_mesh_patch) and the place-recognition worker (add_loop) call in
    at once, with a short switch interval: no pose, slice or patch is
    lost, and every node has its raw pose."""
    import sys
    import threading

    md = MapDeformation(tiny_test_config(isam_thresh=100.0, dense_sampling_rate=0.5),
                        device="cpu")
    gt, est = drifting_square()
    times = [int(k * 1e6 / 3) for k in range(len(gt))]
    rng = np.random.default_rng(8)
    pts = [T[:3, 3][None, :] + rng.uniform(-0.1, 0.1, (10, 3)) for T in est]
    loops = [loop(LoopConstraint, gt, times, i, j, seed=i) for i, j in ((0, 20), (3, 35), (0, -1))]
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # the test fails on it below
            errors.append(e)

    def frames():
        for T, ts in zip(est, times):
            md.add_frame_pose(ts, T)

    def pool():
        for p, T, ts in zip(pts, est, times):
            md.add_slice(slices(CloudSlice, p, ts))
            md.add_mesh_patch(patch(MeshPatch, T, ts, rng))

    def closures():
        for c in loops:
            md.add_loop(c)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(f,)) for f in (frames, pool, closures)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(md.slices) == len(md.mesh_patches) == len(times)
    assert md.graph.times == times and sorted(md._raw_pose) == times
    assert len(md.loop_log) == md.n_loops_accepted + md.n_loops_rejected
