"""Port vs JAX, the sharded fast step: the port's ShardedTracker on a
SlabMesh of 4 CPU slabs against the JAX package's ShardedTracker on 4 of
the conftest's virtual CPU devices (pallas=False: integrate_fast, which
the port's K1/K2 plain versions hold to), and against the port's own
single-device Tracker, at tests/test_fast_multichip.py's tolerances."""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

from kintinuous_tpu.io.synth import Scene, orbit_trajectory, render_frame, straight_trajectory
from kintinuous_tpu.parallel.tracker import ShardedTracker as JShardedTracker
from kintinuous_tpu_torch.ops.blocked import as_dense
from kintinuous_tpu_torch.parallel.mesh import SlabMesh
from kintinuous_tpu_torch.parallel.tracker import ShardedTracker
from kintinuous_tpu_torch.tracking.tracker import Tracker
from tests.test_fast_multichip import _sorted_rows, fast_cfg
from tests.test_torch_package import port_cfg

torch.set_num_threads(2)

ORBIT = orbit_trajectory(6, radius=0.05, angle_deg=3.0)
WALK = straight_trajectory(25, distance=1.0, axis=0)


def slabs(n=4):
    return SlabMesh(["cpu"] * n)


def jax_mesh():
    return Mesh(np.array(jax.devices()[:4]), axis_names=("z",))


def feed(trackers, poses, use_gt):
    scene = Scene.default()
    cam = trackers[0].cfg.camera
    last = None
    for i, T in enumerate(poses):
        d, rgb = render_frame(scene, cam, T)
        delta = None
        if use_gt:
            delta = (np.linalg.inv(last) @ T if last is not None else np.eye(4)).astype(np.float32)
        for tr in trackers:
            tr.process_frame(d, rgb, int(i * 1e6 / 30), ext_delta=delta)
        last = T
    for tr in trackers:
        tr.flush()
    return trackers


def logical_tsdf(tr):
    v = as_dense(tr.state.vol)
    w = v.wrap.numpy()
    return np.roll(v.tsdf.numpy(), shift=(-w[2], -w[1], -w[0]), axis=(0, 1, 2))


def jax_logical_tsdf(tr, R):
    from kintinuous_tpu.parallel.fast_sharded import blocked_slab_to_dense

    t = np.asarray(blocked_slab_to_dense(jax.device_get(tr.state.vol.tsdf), R // 8))
    w = np.asarray(tr.state.vol.wrap)
    return np.roll(t, shift=(-w[2], -w[1], -w[0]), axis=(0, 1, 2))


@pytest.fixture(scope="module")
def orbit_runs():
    cfg = fast_cfg()
    pcfg = port_cfg(cfg)
    single, sharded = feed([Tracker(pcfg, device="cpu"), ShardedTracker(pcfg, mesh=slabs())],
                           ORBIT, use_gt=False)
    (jax_sharded,) = feed([JShardedTracker(cfg, mesh=jax_mesh())], ORBIT, use_gt=False)
    return cfg, single, sharded, jax_sharded


def test_orbit_matches_jax_sharded_and_single(orbit_runs):
    """ICP on every frame after the first: poses within 5e-4 m of the JAX
    sharded tracker's and of the port's single tracker's; the logical
    volume within 1e-3 of the single tracker's everywhere, and of the
    JAX sharded tracker's on all but 1e-5 of the voxels (poses from two
    implementations differ in their last digits, which moves a voxel
    that projects onto a pixel boundary to the next pixel: measured, 1
    voxel in 2.1 M); the inliers agree within 1 %."""
    cfg, single, sharded, jax_sharded = orbit_runs
    np.testing.assert_allclose(np.array(sharded.poses), np.array(jax_sharded.poses), atol=5e-4)
    np.testing.assert_allclose(np.array(sharded.poses), np.array(single.poses), atol=5e-4)
    port = logical_tsdf(sharded)
    np.testing.assert_allclose(port, logical_tsdf(single), atol=1e-3)
    off = np.abs(port - jax_logical_tsdf(jax_sharded, cfg.volume_resolution)) > 1e-3
    assert off.mean() <= 1e-5, off.sum()
    assert min(sharded.stats["icp_count"][1:]) > 500
    np.testing.assert_allclose(sharded.stats["icp_count"][1:],
                               jax_sharded.stats["icp_count"][1:], rtol=0.01)


def test_shift_extraction_matches_jax_sharded():
    """A ground-truth walk across shift thresholds: the same shifts, the
    same slices (count equal, points within 1e-4 m) and the same FINAL
    slice as the JAX sharded tracker and the port's single tracker."""
    cfg = fast_cfg()
    pcfg = port_cfg(cfg)
    single, sharded = feed([Tracker(pcfg, device="cpu"), ShardedTracker(pcfg, mesh=slabs())],
                           WALK, use_gt=True)
    (jax_sharded,) = feed([JShardedTracker(cfg, mesh=jax_mesh())], WALK, use_gt=True)
    for ref in (jax_sharded, single):
        np.testing.assert_allclose(np.array(sharded.poses), np.array(ref.poses), atol=1e-5)
        np.testing.assert_array_equal(np.array(sharded.shift_log), np.array(ref.shift_log))
        assert [s.dimension for s in sharded.slices] == [s.dimension for s in ref.slices]
        for a, b in zip(ref.slices, sharded.slices):
            assert len(a.points) == len(b.points), (a.dimension, len(a.points), len(b.points))
            np.testing.assert_allclose(_sorted_rows(a.points), _sorted_rows(b.points), atol=1e-4)
    assert any(s.dimension == "XPlus" for s in sharded.slices), "no shift fired"
    fb = sharded.finalise()
    for ref in (jax_sharded, single):
        fa = ref.finalise()
        assert len(fa.points) == len(fb.points)
        np.testing.assert_allclose(_sorted_rows(fa.points), _sorted_rows(fb.points), atol=1e-4)


def test_backward_walk_band_matches_jax_single_chip():
    """A ground-truth walk along -x, whose bands leave through the
    volume's + edge: the port's sharded extraction gives the JAX single
    tracker's slices and FINAL slice (its band slab ends at logical
    R - 1, where the sharded step's box would wrap to plane 0; the port
    follows the single tracker there, ROADMAP section 3)."""
    from kintinuous_tpu.tracking.tracker import Tracker as JTracker

    cfg = fast_cfg()
    walk = straight_trajectory(25, distance=-1.0, axis=0)
    (sharded,) = feed([ShardedTracker(port_cfg(cfg), mesh=slabs())], walk, use_gt=True)
    (single,) = feed([JTracker(cfg)], walk, use_gt=True)
    assert [s.dimension for s in sharded.slices] == [s.dimension for s in single.slices]
    assert any(s.dimension == "XMinus" for s in sharded.slices), "no shift fired"
    for a, b in zip(single.slices, sharded.slices):
        assert len(a.points) == len(b.points)
        np.testing.assert_allclose(_sorted_rows(a.points), _sorted_rows(b.points), atol=1e-4)
    fa, fb = single.finalise(), sharded.finalise()
    assert len(fa.points) == len(fb.points)
    np.testing.assert_allclose(_sorted_rows(fa.points), _sorted_rows(fb.points), atol=1e-4)


def test_fused_rgbd_matches_jax_sharded():
    """Fused ICP + RGB-D (-ri) with the pixel rows sharded: poses within
    5e-4 m of the JAX sharded tracker's and of the port's single
    tracker's; a fallback share on every frame."""
    cfg = fast_cfg(icp_plus_rgbd=True)
    pcfg = port_cfg(cfg)
    single, sharded = feed([Tracker(pcfg, device="cpu"), ShardedTracker(pcfg, mesh=slabs())],
                           ORBIT, use_gt=False)
    (jax_sharded,) = feed([JShardedTracker(cfg, mesh=jax_mesh())], ORBIT, use_gt=False)
    assert len(sharded.stats["raycast_fallback"]) == len(ORBIT)
    np.testing.assert_allclose(np.array(sharded.poses), np.array(jax_sharded.poses), atol=5e-4)
    np.testing.assert_allclose(np.array(sharded.poses), np.array(single.poses), atol=5e-4)


def test_batched_matches_per_frame():
    """The batched path (the per-frame step in a loop, consumed a batch
    late) gives the per-frame path's poses, shifts and slices, two shifts
    in one batch included."""
    pcfg = port_cfg(fast_cfg())
    poses = straight_trajectory(17, distance=0.8, axis=0)
    frames = [render_frame(Scene.default(), pcfg.camera, T) for T in poses]
    ts = [int(i * 1e6 / 30) for i in range(len(poses))]
    pf = ShardedTracker(pcfg, mesh=slabs())
    for i in range(len(poses)):
        pf.process_frame(frames[i][0], frames[i][1], ts[i])
    pf.flush()
    bt = ShardedTracker(pcfg, mesh=slabs())
    bt.process_frames([(frames[i][0], frames[i][1], ts[i]) for i in range(len(poses))])
    np.testing.assert_allclose(np.array(bt.poses), np.array(pf.poses), atol=1e-6)
    np.testing.assert_array_equal(np.array(bt.shift_log), np.array(pf.shift_log))
    assert sum(1 for s in pf.shift_log if s[0] > 0) >= 2, "fewer than two x-shifts"
    assert [s.dimension for s in bt.slices] == [s.dimension for s in pf.slices]
    assert [s.timestamp_us for s in bt.slices] == [s.timestamp_us for s in pf.slices]
    for a, b in zip(pf.slices, bt.slices):
        np.testing.assert_array_equal(a.points, b.points)
