"""Port vs JAX: incremental meshing (-m without -od). Surface nets on a
fused volume (the whole volume, and a clamped band box of a slab), the
cell weld, the band patches of a ground-truth walk, and checkpoints
that hold patches (the CLI's -m is in tests/test_torch_cli_modes.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kintinuous_tpu.backend import meshing as jmesh
from kintinuous_tpu.config import CameraIntrinsics, tiny_test_config
from kintinuous_tpu.io.synth import Scene, render_frame, straight_trajectory
from kintinuous_tpu.ops.blocked import blocked_to_dense as jdense
from kintinuous_tpu.ops.surface_nets import extract_mesh as jextract
from kintinuous_tpu.ops.tsdf import VolumeState as JVS
from kintinuous_tpu.runtime import checkpoint as jck
from kintinuous_tpu.tracking.tracker import Tracker as JTracker
from kintinuous_tpu_torch.backend import meshing as pmesh
from kintinuous_tpu_torch.ops.blocked import blocked_to_dense as pdense
from kintinuous_tpu_torch.ops.surface_nets import extract_mesh as pextract
from kintinuous_tpu_torch.ops.tsdf import VolumeState as PVS
from kintinuous_tpu_torch.runtime import checkpoint as pck
from kintinuous_tpu_torch.tracking.tracker import Tracker as PTracker
from tests.test_incremental_mesh import CAM, cfg_incr
from tests.test_torch_package import port_cfg, port_vol

torch.set_num_threads(2)

CAM80 = CameraIntrinsics(fx=70.0, fy=70.0, cx=40.0, cy=30.0, width=80, height=60)


def gt_feed(tracker, poses, frames):
    last = None
    for i, T in enumerate(poses):
        delta = (np.linalg.inv(last) @ T if last is not None else np.eye(4)).astype(np.float32)
        tracker.process_frame(frames[i][0], frames[i][1], int(i * 1e6 / 30), ext_delta=delta)
        last = T
    tracker.flush()
    return tracker


@pytest.fixture(scope="module")
def fused64():
    """A JAX fast tracker's R=64 volume after six ground-truth frames of
    a walk along x, as a dense VolumeState in both packages."""
    cfg = tiny_test_config(camera=CAM80, fast_mode=True, voxel_shift=8,
                           volume_resolution=64, band_cap=512, static_mode=True)
    poses = straight_trajectory(6, distance=0.2, axis=0)
    tr = gt_feed(JTracker(cfg), poses,
                 [render_frame(Scene.default(), CAM80, T) for T in poses])
    v = tr.state.vol
    jv = JVS(tsdf=jdense(v.tsdf), cw=jdense(v.cw), wrap=v.wrap, origin=v.origin)
    pv = port_vol(v)
    pv = PVS(tsdf=pdense(pv.tsdf), cw=pdense(pv.cw), wrap=pv.wrap, origin=pv.origin)
    return cfg, jv, pv


def assert_same_mesh(j, p, vert_atol):
    """Equal counts and cell sets; vertices within vert_atol and colours
    equal, matched by cell; faces equal as triples of cell keys."""
    nv, nf = int(j.n_vertices), int(j.n_faces)
    assert (int(p.n_vertices), int(p.n_faces)) == (nv, nf) and nv > 100 and nf > 100
    jk = jmesh._cell_keys(np.asarray(j.cells[:nv]))
    pk = pmesh._cell_keys(p.cells[:nv].numpy())
    oj, op = np.argsort(jk), np.argsort(pk)
    np.testing.assert_array_equal(pk[op], jk[oj])
    np.testing.assert_allclose(p.vertices[:nv].numpy()[op], np.asarray(j.vertices[:nv])[oj],
                               atol=vert_atol)
    np.testing.assert_array_equal(p.colors[:nv].numpy()[op], np.asarray(j.colors[:nv])[oj])

    def tri_keys(keys, faces):
        t = keys[faces]
        return t[np.lexsort(t.T[::-1])]

    np.testing.assert_array_equal(tri_keys(pk, p.faces[:nf].numpy()),
                                  tri_keys(jk, np.asarray(j.faces[:nf])))


@pytest.mark.parametrize("box", ["whole_volume", "clamped_band"])
def test_extract_mesh_matches_jax(fused64, box):
    """The same fused volume through both extractors: the whole volume
    (wrapping at its far faces, as the JAX package does) and a band box
    of a z-leading slab with clamped edges and a coordinate offset, as
    the tracker meshes a shift. Vertices within 1e-5."""
    cfg, jv, pv = fused64
    R = cfg.volume_resolution
    if box == "whole_volume":
        args = ((0, 0, 0), (R, R, R), cfg.voxel_size, 60_000, 120_000)
        j = jextract(jv, jnp.zeros(3, jnp.int32), *args[1:])
        p = pextract(pv, *args)
    else:
        # the z planes 40..63 as a slab, meshed over its planes 5..23: the
        # box's + edge is the slab's last plane, edge-padded
        z0 = 40
        jslab = jv._replace(tsdf=jv.tsdf[z0:], cw=jv.cw[z0:])
        pslab = pv._replace(tsdf=pv.tsdf[z0:], cw=pv.cw[z0:])
        j = jextract(jslab, jnp.array([0, 0, 5], jnp.int32), (R, R, 19), cfg.voxel_size,
                     20_000, 40_000, clamp_edges=True,
                     coord_offset=jnp.array([0, 0, z0], jnp.int32))
        p = pextract(pslab, (0, 0, 5), (R, R, 19), cfg.voxel_size, 20_000, 40_000,
                     clamp_edges=True, coord_offset=(0, 0, z0))
    assert_same_mesh(j, p, 1e-5)


def test_extract_mesh_drops_past_capacity(fused64):
    """Past capacity the first vertices and faces are kept, in order, and
    the counts are the capacities, as the JAX package's dropping scatter."""
    cfg, jv, pv = fused64
    R = cfg.volume_resolution
    j = jextract(jv, jnp.zeros(3, jnp.int32), (R, R, R), cfg.voxel_size, 500, 900)
    p = pextract(pv, (0, 0, 0), (R, R, R), cfg.voxel_size, 500, 900)
    assert (int(p.n_vertices), int(p.n_faces)) == (int(j.n_vertices), int(j.n_faces)) \
        == (500, 900)
    np.testing.assert_array_equal(p.cells.numpy(), np.asarray(j.cells))
    np.testing.assert_array_equal(p.faces.numpy(), np.asarray(j.faces))
    np.testing.assert_allclose(p.vertices.numpy(), np.asarray(j.vertices), atol=1e-5)


def walk_cfg():
    # the JAX package's non-Pallas fusion, to which the port's fusion is
    # bit-equal on the CPU (tests/test_torch_integrate.py)
    return cfg_incr(online_deformation=False, pallas=False)


@pytest.fixture(scope="module")
def walks():
    """tests/test_incremental_mesh.py's 25-frame walk (1 m along x, GT
    replay) through both trackers with meshing, finalised."""
    poses = straight_trajectory(25, distance=1.0, axis=0)
    frames = [render_frame(Scene.default(), CAM, T) for T in poses]
    a = gt_feed(JTracker(walk_cfg()), poses, frames)
    b = gt_feed(PTracker(port_cfg(walk_cfg()), device="cpu"), poses, frames)
    for t in (a, b):
        t.finalise()
    return a, b


def test_walk_band_patches_match_jax(walks):
    """The same patches (band patches and the FINAL one): equal cell sets
    and face counts, vertices within 1e-4 (test_incremental_mesh.py:294's
    tolerance between two trackers)."""
    a, b = walks
    assert np.array_equal(np.array(a.shift_log), np.array(b.shift_log))
    assert len(b.mesh_patches) == len(a.mesh_patches) >= 3
    for pa, pb in zip(a.mesh_patches, b.mesh_patches):
        assert pb.timestamp_us == pa.timestamp_us
        assert len(pb.faces) == len(pa.faces) and len(pb.vertices) == len(pa.vertices)
        oa = np.lexsort(pa.cells.T[::-1])
        ob = np.lexsort(pb.cells.T[::-1])
        np.testing.assert_array_equal(pb.cells[ob], pa.cells[oa])
        np.testing.assert_allclose(pb.vertices[ob], pa.vertices[oa], atol=1e-4)
        assert np.isfinite(pb.vertices).all() and pb.faces.max() < len(pb.vertices)


def test_weld_patches_matches_jax(walks):
    """The weld of the same patches is the same mesh in both packages,
    and welding the port's own patches gives the JAX package's faces."""
    a, b = walks
    same = [pmesh.MeshPatch(**vars(p)) for p in a.mesh_patches]
    want = jmesh.weld_patches(a.mesh_patches)
    for x, y in zip(pmesh.weld_patches(same), want):
        np.testing.assert_array_equal(x, y)
    v, c, f = pmesh.weld_patches(b.mesh_patches)
    assert f.shape == want[2].shape and len(v) == len(want[0])
    np.testing.assert_allclose(v, want[0], atol=1e-4)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_with_patches_crosses(walks, tmp_path, direction):
    """A tracker checkpoint that holds mesh patches: the other package
    restores every patch (vertices, colours, faces, cells, timestamps)
    exactly, in the JAX package's npz layout."""
    a, b = walks
    path = str(tmp_path / "mesh.npz")
    if direction == "port_to_jax":
        pck.save_checkpoint(path, b)
        src, dst = b, jck.load_checkpoint(path, JTracker(walk_cfg()))
    else:
        jck.save_checkpoint(path, a)
        src, dst = a, pck.load_checkpoint(path, PTracker(port_cfg(walk_cfg()), device="cpu"))
    assert len(dst.mesh_patches) == len(src.mesh_patches) >= 3
    for p, q in zip(src.mesh_patches, dst.mesh_patches):
        for f in ("vertices", "colors", "faces", "cells"):
            np.testing.assert_array_equal(np.asarray(getattr(q, f)), np.asarray(getattr(p, f)))
        assert q.timestamp_us == p.timestamp_us
    assert len(dst.slices) == len(src.slices)
