"""Port vs JAX: fused ICP+RGB-D odometry (the reference's config B and
the -r/-ri/-ftf flags). The preprocess additions, the photometric
system, the coarse-to-fine odometry with its jump guard, the fast
tracker with icp_plus_rgbd, and a step from a carried JAX state (the
CLI with -ri is in tests/test_torch_cli_modes.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kintinuous_tpu.config import CameraIntrinsics, tiny_test_config
from kintinuous_tpu.geometry import se3 as jse3
from kintinuous_tpu.io.synth import Scene, orbit_trajectory, render_frame
from kintinuous_tpu.ops import preprocess as jpp
from kintinuous_tpu.ops import rgbd as jrgbd
from kintinuous_tpu_torch.ops import preprocess as ppp
from kintinuous_tpu_torch.ops import rgbd as prgbd
from kintinuous_tpu_torch.tracking import odometry as podo
from kintinuous_tpu_torch.tracking.tracker import Tracker as PTracker
from kintinuous_tpu_torch.tracking.tracker import state_from_numpy
from tests.test_fast_tracker import ate_of
from tests.test_rgbd import CAM, ITERS, LEVELS, frame_data
from tests.test_torch_package import port_cam, port_cfg, tt

torch.set_num_threads(2)

PCAM = port_cam(CAM)


def port_frame_data(T_wc):
    """tests/test_rgbd.frame_data through the port."""
    depth_mm, rgb = render_frame(Scene.default(), CAM, T_wc)
    depth = ppp.depth_to_metres(tt(depth_mm, np.float32))
    intensity = ppp.rgb_to_intensity(tt(rgb))
    return (podo.build_map_pyramid(PCAM, depth, LEVELS),
            prgbd.build_rgbd_pyramid(intensity, depth, LEVELS))


@pytest.mark.parametrize("op", ["pyr_down_gauss", "rgb_to_intensity", "sobel_gradients"])
def test_preprocess_additions_match(op):
    rng = np.random.default_rng(3)
    if op == "rgb_to_intensity":
        x = render_frame(Scene.default(), CAM, np.eye(4))[1]
    else:
        x = (rng.random((61, 83)) * 255).astype(np.float32)
    want = getattr(jpp, op)(jnp.asarray(x))
    got = getattr(ppp, op)(tt(x))
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bilinear", [True, False], ids=["bilinear", "nearest"])
def test_rgb_system_matches(bilinear):
    """A, b and the inlier count of one photometric build on
    tests/test_rgbd.py's 160x120 camera, at a perturbed pose: rtol 1e-4
    (float32 sums over ~19,000 pixels in another order)."""
    xi = np.array([0.01, -0.005, 0.008, 0.01, -0.01, 0.015], np.float32)
    T_b = np.array(jse3.exp_se3(jnp.asarray(xi)))
    maps_a, rgbd_a = frame_data(np.eye(4))
    maps_b, rgbd_b = frame_data(T_b)
    pmaps_b, prgbd_b = port_frame_data(T_b)
    _, prgbd_a = port_frame_data(np.eye(4))
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.004, -0.003, 0.002]
    for level in range(LEVELS):
        want = jrgbd.rgb_system(
            CAM.at_level(level), jnp.asarray(T), maps_b[level][0],
            rgbd_b.intensity[level],
            jrgbd.pack_prev_texture(*(f[level] for f in rgbd_a)),
            rgbd_a.intensity[level].shape, jrgbd.MIN_GRAD2[level], bilinear=bilinear)
        got = prgbd.rgb_system(
            PCAM.at_level(level), tt(T), pmaps_b[level][0], prgbd_b.intensity[level],
            prgbd.pack_prev_texture(*(f[level] for f in prgbd_a)),
            tuple(prgbd_a.intensity[level].shape), prgbd.MIN_GRAD2[level],
            bilinear=bilinear)
        assert float(got.count) == float(want.count) > 50
        scale = float(np.abs(np.asarray(want.A)).max())
        np.testing.assert_allclose(got.A.numpy(), np.asarray(want.A), rtol=1e-4,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(np.asarray(want.b)).max()))
        np.testing.assert_allclose(float(got.residual), float(want.residual), rtol=1e-4)


@pytest.mark.parametrize("use_icp,reassoc", [(False, 1), (True, 1), (True, 3)],
                         ids=["rgbd_only", "rgbd_icp", "rgbd_icp_reassoc3"])
def test_rgbd_icp_odometry_matches_and_recovers(use_icp, reassoc):
    """tests/test_rgbd.py's recovery through both packages: deltas within
    1e-4 of each other, and the port meets that test's own criteria
    (trans/rot error < 6e-3 without ICP, < 4e-3 with, > 200 inliers)."""
    xi = ([0.015, 0.01, -0.01, 0.02, 0.01, -0.015] if use_icp
          else [0.01, -0.005, 0.008, 0.01, -0.01, 0.015])
    tol = 0.004 if use_icp else 0.006
    T_b = np.array(jse3.exp_se3(jnp.asarray(xi, jnp.float32)))
    maps_a, rgbd_a = frame_data(np.eye(4))
    maps_b, rgbd_b = frame_data(T_b)
    pmaps_a, prgbd_a = port_frame_data(np.eye(4))
    pmaps_b, prgbd_b = port_frame_data(T_b)
    want, wcnt, _ = jax.jit(lambda: jrgbd.rgbd_icp_odometry(
        CAM, maps_b, rgbd_b, rgbd_a, maps_a if use_icp else None, ITERS,
        reassoc_every=reassoc))()
    got, cnt, _ = prgbd.rgbd_icp_odometry(
        PCAM, pmaps_b, prgbd_b, prgbd_a, pmaps_a if use_icp else None, ITERS,
        reassoc_every=reassoc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert abs(float(cnt) - float(wcnt)) <= 0.01 * float(wcnt)
    err = np.array(jse3.log_se3(jnp.asarray(np.linalg.inv(T_b) @ got.numpy(),
                                            jnp.float32)))
    assert float(cnt) > 200
    assert np.linalg.norm(err[3:]) < tol and np.linalg.norm(err[:3]) < tol, err


def test_jump_guard_matches():
    """A view far from the previous one: both packages keep the result
    under 0.3 m (converged small or rejected to the start), equal within
    1e-4; a forced tiny guard rejects to exactly the warm start."""
    T_far = np.eye(4)
    T_far[:3, 3] = [0.0, 0.0, -1.5]
    c, s = np.cos(2.6), np.sin(2.6)
    T_far[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    maps_b, rgbd_b = frame_data(T_far)
    _, rgbd_a = frame_data(np.eye(4))
    pmaps_b, prgbd_b = port_frame_data(T_far)
    _, prgbd_a = port_frame_data(np.eye(4))
    want, _, _ = jrgbd.rgbd_icp_odometry(CAM, maps_b, rgbd_b, rgbd_a, None, ITERS)
    got, _, _ = prgbd.rgbd_icp_odometry(PCAM, pmaps_b, prgbd_b, prgbd_a, None, ITERS)
    assert np.linalg.norm(got.numpy()[:3, 3]) < 0.3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    T0 = torch.eye(4)
    T0[0, 3] = 0.01
    held, _, _ = prgbd.rgbd_icp_odometry(PCAM, pmaps_b, prgbd_b, prgbd_a, None, ITERS,
                                         jump_reject_m=1e-9, T_init=T0)
    assert torch.equal(held, T0)


def orbit_cfg(**kw):
    """tests/test_rgbd.py:69-88's configuration, in fast mode."""
    cam = CameraIntrinsics(fx=70.0, fy=70.0, cx=40.0, cy=30.0, width=80, height=60)
    return tiny_test_config(static_mode=True, icp_plus_rgbd=True, camera=cam,
                            fast_mode=True, **kw)


def feed(tr, poses, i0=0, i1=None):
    cam = tr.cfg.camera
    for i in range(i0, len(poses) if i1 is None else i1):
        d, rgb = render_frame(Scene.default(), cam, poses[i])
        tr.process_frame(d, rgb, int(i * 1e6 / 30))
    tr.flush()
    return tr


@pytest.fixture(scope="module")
def jax_orbit():
    """The JAX fast tracker with icp_plus_rgbd on the orbit (the TPU
    kernels in interpret mode, as the port follows them), and its state
    after 6 frames."""
    from kintinuous_tpu.tracking.tracker import Tracker as JTracker

    poses = orbit_trajectory(12, radius=0.1, angle_deg=5.0)
    a = feed(JTracker(orbit_cfg(pallas=True)), poses, 0, 6)
    st6 = jax.device_get(a.state)
    return poses, feed(a, poses, 6), st6


def test_fast_tracker_icp_plus_rgbd_follows_jax(jax_orbit):
    """The config B tracker on tests/test_rgbd.py's orbit: poses within
    1e-3 of the JAX tracker's (the two sum their Gauss-Newton systems in
    another order, and that feeds back through the fused volume), the
    same RGB inlier counts within 1 %, ATE < 3 cm (that test's bound)."""
    poses, a, _ = jax_orbit
    b = feed(PTracker(port_cfg(orbit_cfg()), device="cpu"), poses)
    np.testing.assert_allclose(np.array(b.poses), np.array(a.poses), atol=1e-3)
    ca, cb = np.array(a.stats["icp_count"]), np.array(b.stats["icp_count"])
    assert (cb[1:] > 200).all() and (np.abs(ca - cb) <= 0.01 * np.maximum(ca, 1)).all()
    assert ate_of(b, poses) < 0.03


def test_one_rgbd_step_from_a_carried_jax_state(jax_orbit):
    """The JAX tracker's state after 6 frames, its RGB-D pyramid
    included, carried into the port; one fused step from it follows the
    JAX tracker's seventh pose within 1e-4, and state_to_numpy gives the
    pyramid back."""
    from kintinuous_tpu_torch.tracking.tracker import state_to_numpy

    poses, a, st = jax_orbit
    b = PTracker(port_cfg(orbit_cfg()), device="cpu")
    b.state = state_from_numpy(st, "cpu")
    b._frame_idx = 6
    back = state_to_numpy(b.state).rgbd
    assert len(back.intensity) == len(st.rgbd.intensity) >= 2
    for x, y in zip(jax.tree_util.tree_leaves(st.rgbd), jax.tree_util.tree_leaves(
            tuple(back))):
        assert np.array_equal(np.asarray(x), y)
    feed(b, poses, 6, 7)
    np.testing.assert_allclose(b.poses[-1], a.poses[6], atol=1e-4)
