"""Port vs JAX, the dense path end to end (a run without --fast): the
dense Tracker step (kintinuous_tpu/tracking/tracker.py:make_step against
kintinuous_tpu_torch/tracking/tracker.py:make_step) on tracked and
ground-truth runs, a JAX state carried across, fused ICP+RGB-D, band
meshes, a JAX checkpoint resumed in the port, and the CLI without
--fast. R=64, a 160x120 camera, frames rendered from seeded scenes."""

import jax
import numpy as np
import pytest
import torch

from kintinuous_tpu.config import CameraIntrinsics, tiny_test_config
from kintinuous_tpu.io.synth import Scene, orbit_trajectory, render_frame, straight_trajectory
from kintinuous_tpu.tracking.tracker import Tracker as JTracker
from kintinuous_tpu_torch.ops.tsdf import VolumeState
from kintinuous_tpu_torch.tracking.tracker import Tracker as PTracker
from kintinuous_tpu_torch.tracking.tracker import state_from_numpy, state_to_numpy
from tests.test_fast_tracker import ate_of
from tests.test_torch_package import port_cfg

torch.set_num_threads(2)

CAM = CameraIntrinsics(fx=140.0, fy=140.0, cx=80.0, cy=60.0, width=160, height=120)


def dense_cfg(**kw):
    return tiny_test_config(camera=CAM, **kw)


def feed(tr, poses, use_gt, start=0):
    """Frames start.. of the default scene along poses into tracker tr
    (either package's), ground-truth deltas when use_gt."""
    for i in range(start, len(poses)):
        d, rgb = render_frame(Scene.default(), CAM, poses[i])
        delta = None
        if use_gt:
            delta = (np.eye(4) if i == 0 else np.linalg.inv(poses[i - 1]) @ poses[i])
            delta = delta.astype(np.float32)
        tr.process_frame(d, rgb, int(i * 1e6 / 30), ext_delta=delta)
    tr.flush()
    return tr


def both(cfg, poses, use_gt):
    return (feed(JTracker(cfg), poses, use_gt),
            feed(PTracker(port_cfg(cfg), device="cpu"), poses, use_gt))


def test_static_orbit_matches():
    """-sm ICP on an orbit: both under 3 cm ATE (tests/test_tracker.py's
    bound) with plentiful inliers, poses within 1e-3 (the two ICPs sum
    their systems in another order, fed back through the volume)."""
    poses = orbit_trajectory(12, radius=0.12, angle_deg=6.0)
    a, b = both(dense_cfg(static_mode=True), poses, use_gt=False)
    assert ate_of(a, poses) < 0.03 and ate_of(b, poses) < 0.03
    assert min(b.stats["icp_count"][2:]) > 500
    np.testing.assert_allclose(np.array(b.poses), np.array(a.poses), atol=1e-3)
    assert isinstance(b.state.vol, VolumeState) and b.state.vol.tsdf.shape == (64,) * 3


@pytest.mark.parametrize("walk", [(0.55, 0, 0), (0, 0, -0.9), (0.6, 0, -0.6)],
                         ids=["x", "back_z", "diagonal_xz"])
def test_gt_walk_matches(walk):
    """Ground-truth walks that shift the dense volume: the same shifts
    (the diagonal walk shifts x and z on the same frames), poses within
    2e-3, and the slices that leave the volume and the FINAL one with
    the same point counts within 1 %."""
    poses = straight_trajectory(12, distance=1.0, axis=0)
    for T in poses:
        T[:3, 3] = T[0, 3] * np.array(walk)
    a, b = both(dense_cfg(), poses, use_gt=True)
    sa, sb = np.array(a.shift_log), np.array(b.shift_log)
    np.testing.assert_array_equal(sb, sa)
    assert ((sa != 0).sum(axis=1) == np.count_nonzero(walk)).any(), "no shift fired"
    np.testing.assert_array_equal(b.state.vol.wrap.numpy(), np.asarray(a.state.vol.wrap))
    np.testing.assert_allclose(np.array(b.poses), np.array(a.poses), atol=2e-3)
    a.finalise()
    b.finalise()
    na = [(s.dimension, len(s.points)) for s in a.slices]
    nb = [(s.dimension, len(s.points)) for s in b.slices]
    assert [d for d, _ in na] == [d for d, _ in nb] and nb[-1][0] == "FINAL"
    for (_, x), (_, y) in zip(na, nb):
        assert abs(x - y) <= 0.01 * max(x, y)
    assert sum(n for _, n in nb) > 500


def test_one_step_from_a_carried_jax_state():
    """A JAX dense tracker's state after a shifting ground-truth walk
    (wrap non-zero), carried into the port with state_from_numpy: the
    volume arrives bit for bit, state_to_numpy gives it back, and one
    tracked (ICP) step in each lands on the same pose within 1e-4."""
    poses = straight_trajectory(7, distance=0.45, axis=0)
    cfg = dense_cfg()
    a = feed(JTracker(cfg), poses[:6], use_gt=True)
    st = jax.device_get(a.state)
    assert np.asarray(st.vol.wrap).any(), "the walk did not shift"
    b = PTracker(port_cfg(cfg), device="cpu")
    b.state = state_from_numpy(st, "cpu")
    b._frame_idx = 6
    assert torch.equal(b.state.vol.tsdf, torch.from_numpy(np.array(st.vol.tsdf)))
    back = state_to_numpy(b.state)
    np.testing.assert_array_equal(back.vol.cw, np.asarray(st.vol.cw))
    assert back.vol.cw.dtype == np.uint32 and b.state.logical is None
    feed(a, poses, use_gt=False, start=6)
    feed(b, poses, use_gt=False, start=6)
    np.testing.assert_allclose(b.poses[-1], a.poses[-1], atol=1e-4)


def test_fused_rgbd_step_matches():
    """-ri, fused ICP+RGB-D at full resolution: three frames, the last
    two tracked; poses within 1e-3 and the RGB inlier counts within 1 %."""
    poses = orbit_trajectory(3, radius=0.06, angle_deg=3.0)
    a, b = both(dense_cfg(static_mode=True, icp_plus_rgbd=True), poses, use_gt=False)
    assert b.state.rgbd is not None and len(b.state.rgbd[0]) == 3
    np.testing.assert_allclose(np.array(b.poses), np.array(a.poses), atol=1e-3)
    ca, cb = np.array(a.stats["icp_count"][1:]), np.array(b.stats["icp_count"][1:])
    assert (cb > 0).all() and (np.abs(ca - cb) <= 0.01 * ca).all()


def test_band_mesh_step_matches():
    """-m on a walk that shifts: the band patches of both packages hold
    the same cells, their vertices within 1e-4 and face counts within 1 %."""
    poses = straight_trajectory(8, distance=-0.7, axis=2)
    cfg = dense_cfg(mesh=True, mesh_vertex_capacity=60_000, mesh_face_capacity=120_000)
    a, b = both(cfg, poses, use_gt=True)
    pa, pb = a.mesh_patches, b.mesh_patches
    assert len(pa) == len(pb) >= 1
    for x, y in zip(pa, pb):
        kx, ky = {tuple(c) for c in x.cells}, {tuple(c) for c in y.cells}
        assert len(kx ^ ky) <= 0.01 * len(ky)
        assert abs(len(x.faces) - len(y.faces)) <= 0.01 * len(y.faces)
        vx = dict(zip(map(tuple, x.cells), x.vertices))
        vy = dict(zip(map(tuple, y.cells), y.vertices))
        assert max(np.abs(vx[c] - vy[c]).max() for c in kx & ky) <= 1e-4


def test_jax_dense_checkpoint_resumes_in_the_port(tmp_path):
    """A dense checkpoint saved by the JAX package after a shifting walk
    loads into a port tracker; both continue with ICP to the same pose
    within 1e-4."""
    from kintinuous_tpu.runtime.checkpoint import save_checkpoint
    from kintinuous_tpu_torch.runtime.checkpoint import load_checkpoint

    poses = straight_trajectory(7, distance=0.45, axis=0)
    cfg = dense_cfg()
    a = feed(JTracker(cfg), poses[:6], use_gt=True)
    path = str(tmp_path / "dense.npz")
    save_checkpoint(path, a)
    b = load_checkpoint(path, PTracker(port_cfg(cfg), device="cpu"))
    np.testing.assert_array_equal(b.state.vol.wrap.numpy(), np.asarray(a.state.vol.wrap))
    assert len(b.poses) == 6 and b._frame_idx == 6
    feed(a, poses, use_gt=False, start=6)
    feed(b, poses, use_gt=False, start=6)
    np.testing.assert_allclose(b.poses[-1], a.poses[-1], atol=1e-4)
    np.testing.assert_array_equal(np.array(b.shift_log), np.array(a.shift_log))


def test_cli_without_fast_writes_the_map_and_poses(tmp_path):
    """`cli -l log.klg -o out` with no --fast: the dense path, frame by
    frame, writes the .pcd (points of weight 1 and up: six frames fuse
    no voxel eight times, the default cull) and the .poses (one a frame,
    near the ground truth)."""
    from kintinuous_tpu_torch import cli
    from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error
    from kintinuous_tpu_torch.io import synth as psynth
    from kintinuous_tpu_torch.io.pcd import load_pcd
    from kintinuous_tpu_torch.io.tum import load_trajectory

    poses = psynth.straight_trajectory(6, distance=0.3, axis=0)
    log, gt = str(tmp_path / "seq.klg"), str(tmp_path / "seq.gt")
    pcam = port_cfg(dense_cfg()).camera
    psynth.generate_klg(log, pcam, poses, gt_path=gt)
    calib = tmp_path / "calib.txt"
    calib.write_text(f"{CAM.fx} {CAM.fy} {CAM.cx} {CAM.cy} {CAM.width} {CAM.height}\n")
    out = tmp_path / "map"
    assert cli.main(["-l", log, "-c", str(calib), "-s", "3.0", "--resolution", "64",
                     "-t", "4", "-cw", "1", "-o", str(out), "--device", "cpu"]) == 0
    est_s, est_p = load_trajectory(f"{out}.poses")
    ate, n = absolute_trajectory_error(*load_trajectory(gt), est_s, est_p)
    assert len(est_s) == 6 and n == 6 and ate < 0.03
    assert len(load_pcd(f"{out}.pcd")["points"]) > 500
