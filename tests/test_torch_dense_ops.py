"""Port vs JAX, the dense path's ops: integrate, clear_band, trilinear
sampling and its gradient, and the raycast (kintinuous_tpu/ops/tsdf.py,
kintinuous_tpu/ops/raycast.py against kintinuous_tpu_torch/ops/tsdf.py,
kintinuous_tpu_torch/ops/raycast.py), on the same inputs made from
seeds with numpy, at R=64 with a 160x120 camera."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kintinuous_tpu.config import CameraIntrinsics, tiny_test_config
from kintinuous_tpu.io.synth import Scene, orbit_trajectory, render_frame
from kintinuous_tpu.ops import raycast as jrc
from kintinuous_tpu.ops import tsdf as jts
from kintinuous_tpu_torch.ops import raycast as prc
from kintinuous_tpu_torch.ops import tsdf as pts
from tests.test_torch_package import port_cam, tt

torch.set_num_threads(2)

CAM = CameraIntrinsics(fx=140.0, fy=140.0, cx=80.0, cy=60.0, width=160, height=120)
CFG = tiny_test_config(camera=CAM)


def centred(T):
    """A synth pose (camera at the world origin) moved to the volume's
    centre, the tracker's starting place."""
    T = np.array(T, np.float32)
    T[:3, 3] += CFG.volume_size / 2.0
    return T


def frames(n):
    """n views of the default scene along a small orbit: (depth metres,
    rgb f32, colour weight in [0,2] quantised on a 1/127.5 grid, pose)."""
    rng = np.random.default_rng(3)
    out = []
    for T in orbit_trajectory(max(n, 2), radius=0.08, angle_deg=5.0)[:n]:
        d_mm, rgb = render_frame(Scene.default(), CAM, T)
        cw = rng.integers(0, 256, d_mm.shape).astype(np.float32) / 127.5
        out.append((d_mm.astype(np.float32) / 1000.0, rgb.astype(np.float32), cw,
                    centred(T)))
    return out


def port_volume(v):
    return pts.VolumeState(tsdf=tt(v.tsdf, np.float32),
                           cw=torch.from_numpy(np.array(v.cw, np.uint32).view(np.int32)),
                           wrap=tt(v.wrap, np.int32), origin=tt(v.origin, np.float32))


def jax_volume(wrap):
    v = jts.make_volume(CFG.volume_resolution)
    return v._replace(wrap=jnp.asarray(wrap, jnp.int32))


def fuse_both(n, wrap):
    jv = jax_volume(wrap)
    pv = port_volume(jv)
    for d, rgb, cw, T in frames(n):
        jv = jts.integrate(jv, CAM, jnp.asarray(d), jnp.asarray(rgb), jnp.asarray(cw),
                           jnp.asarray(T), CFG.voxel_size, CFG.trunc_dist)
        pts.integrate(pv, port_cam(CAM), tt(d), tt(rgb), tt(cw), tt(T),
                      CFG.voxel_size, CFG.trunc_dist)
    return jax.device_get(jv), pv


@pytest.mark.parametrize("n,wrap", [(1, (0, 0, 0)), (3, (5, 60, 17))],
                         ids=["one_frame", "three_frames_wrapped"])
def test_integrate_matches(n, wrap):
    """tsdf within 2e-5, weight bytes equal, colour bytes within 1: the
    tolerances of the JAX package between its own integrate paths
    (tests/test_fast_path.py:72-91)."""
    jv, pv = fuse_both(n, wrap)
    jcw = np.asarray(jv.cw, np.uint32)
    pcw = pv.cw.numpy().view(np.uint32)
    assert (jcw >> 24).sum() > 1000, "nothing was fused"
    np.testing.assert_allclose(pv.tsdf.numpy(), np.asarray(jv.tsdf), atol=2e-5)
    np.testing.assert_array_equal(pcw >> 24, jcw >> 24)
    for s in (0, 8, 16):
        a = ((pcw >> s) & 0xFF).astype(np.int64)
        b = ((jcw >> s) & 0xFF).astype(np.int64)
        assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("axis,lo,hi,wrap", [
    (0, 3, 11, (0, 0, 0)), (1, 60, 4, (0, 7, 0)), (2, 20, 20, (0, 0, 9)),
    (2, 50, 70, (3, 5, 33))], ids=["x", "y_wrapped_band", "z_empty", "z_wrapped"])
def test_clear_band_matches(axis, lo, hi, wrap):
    """Exact, bit for bit (the cleared tsdf keeps its sign, as tsdf * 0)."""
    rng = np.random.default_rng(axis + lo)
    R = 32
    t = rng.standard_normal((R, R, R)).astype(np.float32)
    cw = rng.integers(0, 2 ** 32, (R, R, R), dtype=np.uint64).astype(np.uint32)
    jv = jts.VolumeState(tsdf=jnp.asarray(t), cw=jnp.asarray(cw),
                         wrap=jnp.asarray(wrap, jnp.int32), origin=jnp.zeros(3))
    out = jax.device_get(jts.clear_band(jv, axis, lo, hi))
    pv = port_volume(jv)
    pts.clear_band(pv, axis, lo, hi)
    np.testing.assert_array_equal(pv.tsdf.numpy().view(np.int32),
                                  np.asarray(out.tsdf).view(np.int32))
    np.testing.assert_array_equal(pv.cw.numpy().view(np.uint32), np.asarray(out.cw))


def test_trilinear_sample_and_gradient_match():
    """Value, corners and gradient within 1e-6 at random positions, some
    past the volume's edges (they wrap)."""
    rng = np.random.default_rng(11)
    R = 16
    vol = rng.standard_normal((R, R, R)).astype(np.float32)
    wrap = np.array([3, 0, 14], np.int32)
    pos = rng.uniform(-3.0, R + 3.0, (500, 3)).astype(np.float32)
    jv, jc, jf = jts.trilinear_sample(jnp.asarray(vol), jnp.asarray(wrap), jnp.asarray(pos))
    jg = jts.trilinear_gradient(jc, jf)
    pv, pc, pf = pts.trilinear_sample(tt(vol), tt(wrap), tt(pos))
    pg = pts.trilinear_gradient(pc, pf)
    for a, b in ((pv, jv), (pc, jc), (pf, jf), (pg, jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("wrap", [(0, 0, 0), (5, 60, 17)], ids=["plain", "wrapped"])
def test_raycast_matches(wrap):
    """On a volume fused by the JAX package from three views, the view of
    a fourth pose: hit masks differ on at most 0.1 % of pixels; where
    both hit, depth and vmap within 1e-4 m, normals within 1e-3, colour
    and weight equal."""
    jv = jax_volume(wrap)
    views = frames(4)
    for d, rgb, cw, T in views[:3]:
        jv = jts.integrate(jv, CAM, jnp.asarray(d), jnp.asarray(rgb), jnp.asarray(cw),
                           jnp.asarray(T), CFG.voxel_size, CFG.trunc_dist)
    T = views[3][3]
    a = jax.device_get(jrc.raycast(jv, CAM, jnp.asarray(T), CFG.voxel_size,
                                   CFG.volume_size, CFG.trunc_dist))
    b = prc.raycast(port_volume(jv), port_cam(CAM), tt(T), CFG.voxel_size,
                    CFG.volume_size, CFG.trunc_dist)
    ha, hb = np.asarray(a.depth) > 0, b.depth.numpy() > 0
    assert ha.mean() > 0.5, "few hits"
    assert (ha != hb).mean() <= 1e-3
    both = ha & hb
    np.testing.assert_allclose(b.depth.numpy()[both], np.asarray(a.depth)[both], atol=1e-4)
    np.testing.assert_allclose(b.vmap.numpy()[:, both], np.asarray(a.vmap)[:, both],
                               atol=1e-4)
    np.testing.assert_allclose(b.nmap.numpy()[:, both], np.asarray(a.nmap)[:, both],
                               atol=1e-3)
    np.testing.assert_array_equal(b.weight.numpy()[both], np.asarray(a.weight)[both])
    np.testing.assert_array_equal(b.color.numpy()[:, both], np.asarray(a.color)[:, both])
    assert np.isnan(b.vmap.numpy()[:, ~hb]).all()
