"""Port vs JAX, the sharded dense step (no --fast): the port's
ShardedTracker on a SlabMesh of 8 CPU slabs against the JAX package's
ShardedTracker on the conftest's 8 virtual CPU devices and against the
port's single-device dense Tracker, the counterparts of
tests/test_multichip.py at its configuration and tolerances."""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

from kintinuous_tpu.io.synth import Scene, orbit_trajectory, render_frame, straight_trajectory
from kintinuous_tpu.parallel.tracker import ShardedTracker as JShardedTracker
from kintinuous_tpu_torch.ops.blocked import as_dense
from kintinuous_tpu_torch.parallel.mesh import SlabMesh
from kintinuous_tpu_torch.parallel.sharded import make_sharded_state, make_sharded_step
from kintinuous_tpu_torch.parallel.tracker import ShardedTracker
from kintinuous_tpu_torch.tracking.tracker import Tracker
from tests.test_multichip import CFG, _sorted_rows
from tests.test_torch_fast_sharded import feed
from tests.test_torch_package import port_cfg

torch.set_num_threads(2)

PCFG = port_cfg(CFG)
WALK = straight_trajectory(25, distance=1.0, axis=0)


def slabs():
    return SlabMesh(["cpu"] * 8)


def jax_mesh():
    return Mesh(np.array(jax.devices()[:8]), axis_names=("z",))


def test_sharded_matches_single_chip():
    """Three orbit frames (odometry after the first): the pose within
    5e-4 m and the volume within 1e-4 of the single-device tracker's."""
    poses = orbit_trajectory(3, radius=0.05, angle_deg=3.0)
    single, sharded = feed([Tracker(PCFG, device="cpu"), ShardedTracker(PCFG, mesh=slabs())],
                           poses, use_gt=False)
    np.testing.assert_allclose(sharded.poses[-1], single.poses[-1], atol=5e-4)
    np.testing.assert_allclose(as_dense(sharded.state.vol).tsdf.numpy(),
                               single.state.vol.tsdf.numpy(), atol=1e-4)
    assert min(sharded.stats["icp_count"][1:]) > 100


def test_slab_raycast_matches_allgather():
    """The slab-local raycast (halos, pmin, psum) gives the all-gather
    baseline's predictions on the same volume and pose."""
    mesh = slabs()
    eye = torch.eye(4)
    frames = [render_frame(Scene.default(), CFG.camera, T)
              for T in orbit_trajectory(2, radius=0.05, angle_deg=3.0)]
    results = []
    for slab_raycast in (True, False):
        state = make_sharded_state(PCFG, mesh)
        ext = make_sharded_step(PCFG, mesh, use_odometry=False, slab_raycast=slab_raycast)
        odo = make_sharded_step(PCFG, mesh, use_odometry=True, slab_raycast=slab_raycast)
        for i, (d, c) in enumerate(frames):
            state, out = (ext if i == 0 else odo)(
                state, torch.from_numpy(d.astype(np.float32)),
                torch.from_numpy(c.astype(np.float32)), eye)
        results.append((state.pred_vmap.numpy(), state.pred_nmap.numpy(),
                        out.pose_global.numpy()))
    (va, na, pa), (vb, nb, pb) = results
    np.testing.assert_allclose(pa, pb, atol=1e-5)
    hits_a, hits_b = np.isfinite(va).all(axis=0), np.isfinite(vb).all(axis=0)
    assert (hits_a == hits_b).mean() > 0.995 and hits_a.sum() > 500
    both = hits_a & hits_b
    np.testing.assert_allclose(va[:, both], vb[:, both], atol=1e-4)
    np.testing.assert_allclose(na[:, both], nb[:, both], atol=1e-3)


def test_shift_extraction_matches_jax_sharded():
    """A ground-truth walk along +x across shift thresholds: the same
    poses (1e-5), shifts and slices (count equal, points within 1e-5 m)
    and the same FINAL slice as the JAX sharded tracker and the port's
    single tracker: no map lost to the slabs."""
    single, sharded = feed([Tracker(PCFG, device="cpu"), ShardedTracker(PCFG, mesh=slabs())],
                           WALK, use_gt=True)
    (jax_sharded,) = feed([JShardedTracker(CFG, mesh=jax_mesh())], WALK, use_gt=True)
    assert any(s.dimension == "XPlus" for s in sharded.slices), "no shift fired"
    fb = sharded.finalise()
    for ref in (jax_sharded, single):
        np.testing.assert_allclose(np.array(sharded.poses), np.array(ref.poses), atol=1e-5)
        np.testing.assert_array_equal(np.array(sharded.shift_log), np.array(ref.shift_log))
        assert [s.dimension for s in sharded.slices[:-1]] == [s.dimension for s in ref.slices]
        for a, b in zip(ref.slices, sharded.slices):
            assert len(a.points) == len(b.points), (a.dimension, len(a.points), len(b.points))
            np.testing.assert_allclose(_sorted_rows(a.points), _sorted_rows(b.points), atol=1e-5)
        fa = ref.finalise()
        assert len(fa.points) == len(fb.points)
        np.testing.assert_allclose(_sorted_rows(fa.points), _sorted_rows(fb.points), atol=1e-5)


def test_sharded_dense_rgbd_matches_jax_sharded():
    """Fused ICP + RGB-D on the dense sharded path: the JAX sharded step
    phases its iterations its own way (nearest taps, then two bilinear),
    which the port's sharded step follows: poses within 5e-4 m of the
    JAX sharded tracker's, and within test_multichip's 5e-3 m of the
    single-device fused tracker's."""
    cfg = CFG.replace(icp_plus_rgbd=True)
    pcfg = port_cfg(cfg)
    poses = orbit_trajectory(4, radius=0.05, angle_deg=3.0)
    single, sharded = feed([Tracker(pcfg, device="cpu"), ShardedTracker(pcfg, mesh=slabs())],
                           poses, use_gt=False)
    (jax_sharded,) = feed([JShardedTracker(cfg, mesh=jax_mesh())], poses, use_gt=False)
    assert sharded.stats["icp_count"][-1] > 100.0
    np.testing.assert_allclose(np.array(sharded.poses), np.array(jax_sharded.poses), atol=5e-4)
    np.testing.assert_allclose(sharded.poses[-1], single.poses[-1], atol=5e-3)


@pytest.mark.parametrize("against", ["single", "jax_sharded"])
def test_dense_sharded_incremental_mesh(against):
    """Meshing on (-m -od): the band mesh patches the sharded dense step
    emits on the shifts equal the single-device tracker's and the JAX
    sharded tracker's (vertices within 1e-5 m, cells equal)."""
    cfg = CFG.replace(mesh=True, online_deformation=True, mesh_vertex_capacity=60_000,
                      mesh_face_capacity=120_000)
    pcfg = port_cfg(cfg)
    ref = (Tracker(pcfg, device="cpu") if against == "single"
           else JShardedTracker(cfg, mesh=jax_mesh()))
    ref, sharded = feed([ref, ShardedTracker(pcfg, mesh=slabs())], WALK, use_gt=True)
    assert len(ref.mesh_patches) >= 1, "no mesh patch fired"
    assert len(sharded.mesh_patches) == len(ref.mesh_patches)
    for a, b in zip(ref.mesh_patches, sharded.mesh_patches):
        assert len(a.vertices) == len(b.vertices) and len(a.faces) == len(b.faces)
        np.testing.assert_allclose(_sorted_rows(a.vertices), _sorted_rows(b.vertices),
                                   atol=1e-5)
        np.testing.assert_array_equal(_sorted_rows(np.asarray(a.cells, np.float64)),
                                      _sorted_rows(np.asarray(b.cells, np.float64)))


def test_rgbd_icp_odometry_reduce_matches_one_block():
    """ops/rgbd.rgbd_icp_odometry with the sharded hook (the JAX
    package's axis_name): the current maps and intensity in 4 pixel-row
    blocks, the sigma statistics and both systems summed over them,
    gives the one-block result: the same inliers and sigma, T within
    1e-5."""
    from kintinuous_tpu_torch.ops import preprocess as pp
    from kintinuous_tpu_torch.ops.rgbd import build_rgbd_pyramid, rgbd_icp_odometry
    from kintinuous_tpu_torch.parallel.sharded import row_blocks
    from kintinuous_tpu_torch.tracking.odometry import build_map_pyramid

    cam = PCFG.camera
    poses = orbit_trajectory(2, radius=0.05, angle_deg=3.0)
    pyr, rgbd = [], []
    for T in poses:
        d, c = render_frame(Scene.default(), CFG.camera, T)
        dm = pp.depth_to_metres(torch.from_numpy(d.astype(np.float32)), PCFG.max_depth)
        inten = pp.rgb_to_intensity(torch.from_numpy(c.astype(np.float32)))
        pyr.append(build_map_pyramid(cam, dm, 2))
        rgbd.append(build_rgbd_pyramid(inten, dm, 2))
    mesh = SlabMesh(["cpu"] * 4)
    sharded_pyr = tuple((row_blocks(mesh, v, 1), row_blocks(mesh, n, 1)) for v, n in pyr[1])
    sharded_rgbd = rgbd[1]._replace(
        intensity=tuple(row_blocks(mesh, i, 0) for i in rgbd[1].intensity))
    whole = rgbd_icp_odometry(cam, pyr[1], rgbd[1], rgbd[0], pyr[0], (4, 3))
    split = rgbd_icp_odometry(cam, sharded_pyr, sharded_rgbd, rgbd[0], pyr[0], (4, 3),
                              reduce=mesh.psum_home)
    assert float(whole[1]) > 100
    assert float(split[1]) == float(whole[1])
    np.testing.assert_allclose(float(split[2]), float(whole[2]), rtol=1e-5)
    np.testing.assert_allclose(split[0].numpy(), whole[0].numpy(), atol=1e-5)
