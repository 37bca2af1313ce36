"""Port vs JAX: the public helpers the port carried last (odometry's
covariance, ate_files, transform_maps, the image samplers, the blocked
gather and keep mask, MeshCollector.n_triangles, Stopwatch.get). The
same numpy inputs, made from a seed, go through both packages."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kintinuous_tpu.config import CameraIntrinsics as JCam
from kintinuous_tpu.eval import ate as jate
from kintinuous_tpu.geometry import camera as jcamera
from kintinuous_tpu.io.synth import Scene, orbit_trajectory, render_frame
from kintinuous_tpu.io.tum import save_trajectory
from kintinuous_tpu.ops import blocked as jblocked
from kintinuous_tpu.ops import maps as jmaps
from kintinuous_tpu.ops import preprocess as jpp
from kintinuous_tpu.tracking import odometry as jodo
from kintinuous_tpu_torch.backend.meshing import MeshCollector, MeshPatch
from kintinuous_tpu_torch.eval import ate as pate
from kintinuous_tpu_torch.geometry import camera as pcamera
from kintinuous_tpu_torch.geometry import se3 as pse3
from kintinuous_tpu_torch.ops import blocked as pblocked
from kintinuous_tpu_torch.ops import maps as pmaps
from kintinuous_tpu_torch.ops import preprocess as ppp
from kintinuous_tpu_torch.runtime.stopwatch import Stopwatch
from kintinuous_tpu_torch.tracking import odometry as podo
from tests.test_torch_package import port_cam, tt

torch.set_num_threads(2)

CAM = JCam(fx=70.0, fy=70.0, cx=40.0, cy=30.0, width=80, height=60)


def maps_of(scene, T=np.eye(4)):
    """A rendered view's depth in metres and its vertex and normal maps,
    through each package."""
    d, _ = render_frame(scene, CAM, T)
    jd = jpp.depth_to_metres(jnp.asarray(d, jnp.float32), 6.0)
    jv = jmaps.create_vmap(CAM, jd)
    pd = ppp.depth_to_metres(tt(d, np.float32), 6.0)
    pv = pmaps.create_vmap(port_cam(CAM), pd)
    return (jv, jmaps.create_nmap(jv)), (pv, pmaps.create_nmap(pv))


@pytest.mark.parametrize("scene", ["rich", "wall"])
def test_icp_covariance_matches_jax(scene):
    """tests/test_icp.py:98-125 through both packages: the 6x6 within
    1e-4 of JAX's relative to its largest entry, symmetric and positive
    definite; the bare room's fronto-parallel wall leaves directions
    loose, a trace above 10x the rich scene's. Off the identity (a small
    motion of the current frame) too."""
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.01, -0.005, 0.008]
    covs = {}
    for name, sc in (("rich", Scene.default()), ("wall", Scene())):
        (jv, jn), (pv, pn) = maps_of(sc)
        j = np.asarray(jodo.icp_covariance(CAM, jnp.asarray(T), jv, jn, jv, jn))
        p = podo.icp_covariance(port_cam(CAM), tt(T), pv, pn, pv, pn).numpy()
        covs[name] = p
        if name == scene:
            assert p.shape == (6, 6)
            assert np.abs(p - j).max() <= 1e-4 * np.abs(j).max()
            np.testing.assert_allclose(p, p.T, atol=1e-6 * np.abs(p).max())
            assert np.all(np.linalg.eigvalsh(p.astype(np.float64)) > 0)
    assert np.trace(covs["wall"]) > 10.0 * np.trace(covs["rich"])


def test_transform_maps_round_trip_and_matches_jax():
    """tests/test_preprocess.py:120 through the port (the round trip to
    1e-4 as there), and against JAX's transform at 1e-6 m."""
    (jv, jn), (pv, pn) = maps_of(Scene.default(), orbit_trajectory(3)[1])
    xi = np.array([0.1, -0.2, 0.3, 0.5, 0.1, -0.4], np.float32)
    T = pse3.exp_se3(torch.from_numpy(xi))
    v2, n2 = pmaps.transform_maps(pv, pn, T)
    jv2, jn2 = jmaps.transform_maps(jv, jn, jnp.asarray(T.numpy()))
    for got, want in ((v2, jv2), (n2, jn2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    v3, n3 = pmaps.transform_maps(v2, n2, pse3.inverse(T))
    np.testing.assert_allclose(v3.numpy(), pv.numpy(), atol=1e-4)
    mask = np.isfinite(pn.numpy())
    np.testing.assert_allclose(n3.numpy()[mask], pn.numpy()[mask], atol=1e-4)


@pytest.mark.parametrize("shape", [(), (2,)], ids=["image", "batched"])
def test_samplers_match_jax(shape):
    """bilinear_sample at 1e-6 (with project's valid mask: NaN outside)
    and nearest_sample exactly, at coordinates inside, outside and on the
    image's edge and half-pixels, for an image and a stack of two."""
    rng = np.random.default_rng(7)
    img = rng.uniform(-2.0, 5.0, shape + (30, 40)).astype(np.float32)
    uv = rng.uniform(-5.0, 45.0, (5, 7, 2)).astype(np.float32)
    uv[0, :, 0] = np.arange(7) * 6.5  # half-pixels (round half to even)
    uv[1, :3] = [[0.0, 0.0], [39.0, 29.0], [39.5, 29.5]]
    valid = (uv[..., 0] >= 0) & (uv[..., 0] <= 39) & (uv[..., 1] >= 0) & (uv[..., 1] <= 29)
    got = pcamera.bilinear_sample(tt(img), tt(uv), tt(valid)).numpy()
    want = np.asarray(jcamera.bilinear_sample(jnp.asarray(img), jnp.asarray(uv),
                                              jnp.asarray(valid)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6, equal_nan=True)
    plain = pcamera.bilinear_sample(tt(img), tt(uv)).numpy()
    assert np.isfinite(plain).all()
    np.testing.assert_allclose(plain, np.asarray(jcamera.bilinear_sample(
        jnp.asarray(img), jnp.asarray(uv))), atol=1e-6)
    np.testing.assert_array_equal(
        pcamera.nearest_sample(tt(img), tt(uv)).numpy(),
        np.asarray(jcamera.nearest_sample(jnp.asarray(img), jnp.asarray(uv))))


def test_gather_voxels_and_axis_keep_mask_match_jax():
    """The blocked gather at random voxels (any index shape) and the
    per-axis keep mask, both exact, on a 32^3 volume."""
    rng = np.random.default_rng(3)
    R = 32
    arr = rng.standard_normal((R // 8) ** 3 * 512).astype(np.float32).reshape(-1, 4, 128)
    pz, py, px = (rng.integers(0, R, (6, 5)).astype(np.int32) for _ in range(3))
    got = pblocked.gather_voxels(tt(arr), R, tt(pz), tt(py), tt(px)).numpy()
    want = np.asarray(jblocked.gather_voxels(jnp.asarray(arr), R, jnp.asarray(pz),
                                             jnp.asarray(py), jnp.asarray(px)))
    np.testing.assert_array_equal(got, want)
    dense = np.asarray(pblocked.blocked_to_dense(tt(arr)))
    np.testing.assert_array_equal(got, dense[pz, py, px])
    keeps = [rng.random(R) < 0.7 for _ in range(3)]
    got = pblocked.axis_keep_mask(*(torch.from_numpy(k) for k in keeps)).numpy()
    want = np.asarray(jblocked.axis_keep_mask(*(jnp.asarray(k) for k in keeps)))
    assert got.shape == (64, 4, 128) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    kx, ky, kz = keeps
    np.testing.assert_array_equal(
        np.asarray(pblocked.blocked_to_dense(torch.from_numpy(got))),
        kz[:, None, None] & ky[None, :, None] & kx[None, None, :])


@pytest.mark.parametrize("offset", [False, True], ids=["same", "offset"])
def test_ate_files_matches_jax(tmp_path, offset):
    """tests/test_backend.py:162-175 through both packages, on the same
    two files: a rigid offset aligns away; a noisy estimate gives JAX's
    RMSE and pair count."""
    poses = orbit_trajectory(10)
    stamps = [i / 30.0 for i in range(10)]
    gt, est = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    save_trajectory(gt, stamps, poses)
    rng = np.random.default_rng(5)
    moved = []
    for T in poses:
        T = T.copy()
        T[:3, 3] += rng.normal(0.0, 0.003, 3)
        if offset:
            off = np.eye(4)
            off[:3, 3] = [0.5, -0.2, 0.1]
            T = off @ T
        moved.append(T)
    save_trajectory(est, stamps, moved)
    got = pate.ate_files(est, gt)
    assert got == jate.ate_files(est, gt)
    assert got[1] == 10 and 0 < got[0] < 0.01
    assert pate.ate_files(gt, gt) == (0.0, 10) or pate.ate_files(gt, gt)[0] < 1e-9


def test_mesh_collector_counts_triangles():
    col = MeshCollector()
    assert col.n_triangles == 0
    for nf in (3, 0, 5):
        col.add(MeshPatch(vertices=np.zeros((4, 3), np.float32),
                          colors=np.zeros((4, 3), np.uint8),
                          faces=np.zeros((nf, 3), np.int32)))
    assert col.n_triangles == 8


def test_stopwatch_get_is_one_process_wide_instance():
    """Stopwatch.get() gives every thread the same instance, made once;
    an engine's own Stopwatch stays apart from it."""
    seen = []
    gate = threading.Barrier(4)

    def ask():
        gate.wait(timeout=10)
        seen.append(Stopwatch.get())

    threads = [threading.Thread(target=ask) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(seen) == 4 and all(s is seen[0] for s in seen)
    assert Stopwatch.get() is seen[0] and Stopwatch() is not seen[0]
    with seen[0].span("helpers.test"):
        pass
    assert seen[0].stats()["helpers.test"]["count"] >= 1
