"""Port vs JAX: the warm-started raycast of the bf16 mirror and its post
step (normals, colour, measurement fallback). On the CPU the raycast
wrapper runs its plain version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kintinuous_tpu.ops import preprocess as jpp
from kintinuous_tpu.ops.pallas_raycast import _warm_start, build_logical_bf16, raycast_pallas
from kintinuous_tpu_torch.ops.cuda_raycast import (
    ray_setup, raycast_cuda, raycast_params, tile_raycast)
from tests.test_pallas_raycast import _fused_volume
from tests.test_torch_package import port_cam, port_vol, tt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fused():
    cfg, vol, pose, depth_m = _fused_volume()
    depth_half = np.asarray(jpp.pyr_down_depth(depth_m, sigma=0.09))
    mirror = build_logical_bf16(vol, cfg.volume_resolution, interpret=True)
    return cfg, vol, np.asarray(pose), depth_half, mirror


def test_warm_start_is_the_jax_fast_steps(fused):
    """The fast step warms each ray from the measured depth alone (the
    JAX package's _warm_start without a previous prediction): the ray
    lengths agree within an f32 rounding of z * lam (1e-6 relative)."""
    cfg, _, pose, depth_half, _ = fused
    cam = cfg.camera.at_level(1)
    h, w = cam.height, cam.width
    warm_z = np.asarray(_warm_start(cam, jnp.asarray(pose), None, jnp.asarray(depth_half),
                                    h, w))
    u = (np.arange(w, dtype=np.float32)[None, :] - np.float32(cam.cx)) / np.float32(cam.fx)
    v = (np.arange(h, dtype=np.float32)[:, None] - np.float32(cam.cy)) / np.float32(cam.fy)
    lam = np.sqrt(u * u + v * v + np.float32(1.0))
    ref = np.where(warm_z < 1e9, warm_z * lam, 0.0)
    _, _, t_warm = ray_setup(port_cam(cam), tt(pose), tt(depth_half))
    assert (ref > 0).mean() > 0.5
    assert np.array_equal(t_warm.numpy() > 0, ref > 0)
    np.testing.assert_allclose(t_warm.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("newton,window", [
    pytest.param(1, 5, id="1"), pytest.param(2, 5, id="2"), pytest.param(3, 5, id="3"),
    pytest.param(1, 4, id="window4"), pytest.param(2, 7, id="window7")])
def test_raycast_matches_the_tile_kernel(fused, newton, window):
    """tests/test_pallas_raycast.py's criteria, both ways round: each
    path finds >= 90 % of the other's hits; where both hit, median depth
    difference < 2e-3 m and p95 < one voxel; median normal dot > 0.99.
    The port has no tile regions, so no pixel misses one: its fallback
    fraction is at most the TPU kernel's. At the tracker's window of 5
    with 1-3 Newton steps, and at windows of 4 (even: the march starts
    two steps before the warm start, as the TPU kernel's) and 7."""
    cfg, vol, pose, depth_half, mirror = fused
    cam_half = cfg.camera.at_level(1)
    a = raycast_pallas(vol, cam_half, jnp.asarray(pose), None, jnp.asarray(depth_half),
                       cfg.voxel_size, cfg.volume_size, cfg.trunc_dist,
                       window=window, newton=newton, interpret=True)
    pm = torch.from_numpy(np.asarray(mirror).view(np.int16).copy()).view(torch.bfloat16)
    b = raycast_cuda(port_vol(vol), port_cam(cam_half), tt(pose), tt(depth_half),
                     cfg.voxel_size, cfg.volume_size, cfg.trunc_dist, mirror=pm,
                     window=window, newton=newton)
    da, db = np.asarray(a.depth), b.depth.numpy()
    ha, hb = da > 0, db > 0
    both = ha & hb
    assert both.sum() >= 0.9 * ha.sum() and both.sum() >= 0.9 * hb.sum()
    dd = np.abs(da[both] - db[both])
    assert np.median(dd) < 2e-3, np.median(dd)
    assert np.quantile(dd, 0.95) < cfg.voxel_size, np.quantile(dd, 0.95)
    na = np.moveaxis(np.asarray(a.nmap), 0, -1)[both]
    nb = np.moveaxis(b.nmap.numpy(), 0, -1)[both]
    dots = np.sum(na * nb, axis=-1)
    assert np.median(dots[np.isfinite(dots)]) > 0.99
    fa, fb = float(np.asarray(a.fallback_frac)), float(b.fallback_frac)
    assert 0.0 <= fb <= fa + 1e-7, (fb, fa)
    # colour and weight come from the same cw voxels where both hit
    wa, wb = np.asarray(a.weight)[both], b.weight.numpy()[both]
    assert (wa == wb).mean() > 0.95


def test_raycast_fallback_pixels_use_the_measurement(fused):
    cfg, vol, pose, depth_half, mirror = fused
    pm = torch.from_numpy(np.asarray(mirror).view(np.int16).copy()).view(torch.bfloat16)
    b = raycast_cuda(port_vol(vol), port_cam(cfg.camera.at_level(1)), tt(pose),
                     tt(depth_half), cfg.voxel_size, cfg.volume_size, cfg.trunc_dist,
                     mirror=pm)
    measured = depth_half > 0
    assert (b.depth.numpy()[measured] > 0).mean() > 0.95
    assert np.isfinite(b.vmap.numpy()[:, measured]).mean() > 0.95
    assert 0.0 <= float(b.fallback_frac) < 0.05


def test_tile_raycast_finds_a_plane():
    """An analytic mirror: a plane at z = 1.01 m in front of a camera at
    (0.8, 0.8, 0.3), tsdf = clip((1.01 - z)/trunc, -1, 1). The march and
    one Newton step land on it from warm starts up to 4 cm off (the
    plane sits off the tap grid: a tap that reads exactly 0 is no
    crossing, in the TPU kernel as here)."""
    from kintinuous_tpu_torch.config import CameraIntrinsics

    R, vsz, trunc = 64, 0.025, 0.06
    z = (torch.arange(R, dtype=torch.float32) + 0.5) * vsz
    mirror = torch.clamp((1.01 - z) / trunc, -1, 1)[:, None, None].expand(R, R, R)
    mirror = mirror.to(torch.bfloat16).contiguous()
    cam = CameraIntrinsics(fx=40.0, fy=40.0, cx=16.0, cy=12.0, width=32, height=24)
    T = torch.eye(4)
    T[:3, 3] = torch.tensor([0.8, 0.8, 0.3])
    u = torch.arange(32.0)[None, :]
    v = torch.arange(24.0)[:, None]
    lam = torch.sqrt(((u - 16) / 40) ** 2 + ((v - 12) / 40) ** 2 + 1)
    for off in (0.0, 0.04, -0.04):
        t_warm = ((0.7 + off) * lam).contiguous()
        t_hit, found, gx, gy, gz = tile_raycast(mirror, t_warm, raycast_params(T), cam,
                                                vsz, trunc, window=5, newton=1)
        assert bool((found > 0.5).all())
        np.testing.assert_allclose((t_hit / lam).numpy(), 0.71, atol=2e-3)
        assert float(gz.max()) < 0 and float(gx.abs().max()) < 1e-6


def _plane_mirror():
    """test_tile_raycast_finds_a_plane's scene: (mirror, t_warm, params,
    cam, voxel size, trunc), the warm starts 4 cm off the plane."""
    from kintinuous_tpu_torch.config import CameraIntrinsics

    R, vsz, trunc = 64, 0.025, 0.06
    z = (torch.arange(R, dtype=torch.float32) + 0.5) * vsz
    mirror = torch.clamp((1.01 - z) / trunc, -1, 1)[:, None, None].expand(R, R, R)
    cam = CameraIntrinsics(fx=40.0, fy=40.0, cx=16.0, cy=12.0, width=32, height=24)
    T = torch.eye(4)
    T[:3, 3] = torch.tensor([0.8, 0.8, 0.3])
    u = torch.arange(32.0)[None, :]
    v = torch.arange(24.0)[:, None]
    lam = torch.sqrt(((u - 16) / 40) ** 2 + ((v - 12) / 40) ** 2 + 1)
    t_warm = torch.where(u < 28, 0.74 * lam, 0.0).contiguous()  # 4 columns unwarmed
    return (mirror.to(torch.bfloat16).contiguous(), t_warm, raycast_params(T), cam,
            vsz, trunc)


@pytest.mark.parametrize("pair", [(5, 1), (5, 0), (5, 2), (3, 1)])
def test_tile_raycast_on_the_cpu_is_its_plain_version(pair):
    """On CPU tensors the wrapper returns its plain version's five (h,w)
    f32 maps unchanged, for any (window, newton) pair the card takes."""
    from kintinuous_tpu_torch.ops.cuda_raycast import tile_raycast_plain

    args = (*_plane_mirror(), *pair)
    got, want = tile_raycast(*args), tile_raycast_plain(*args)
    assert len(got) == 5
    for a, b in zip(got, want):
        assert a.shape == (24, 32) and a.dtype == torch.float32
        assert torch.equal(a, b)
    assert bool((got[1][:, :28] > 0.5).all()) and not bool(got[1][:, 28:].any())


def test_the_compiled_raycast_pairs_are_the_sources_and_the_trackers():
    """RAYCAST_PAIRS names exactly the pairs csrc/raycast.cu unrolls, and
    the tracker's (5, raycast_newton_iters) is one of them; the C entry
    refuses only window < 1 or newton < 0 (every other pair runs the
    run-time instantiation), and the wrapper raises ValueError for
    those pairs alone, before it reaches a kernel."""
    import re

    from kintinuous_tpu_torch.config import KintinuousConfig
    from kintinuous_tpu_torch.ops import kernels
    from kintinuous_tpu_torch.ops.cuda_raycast import RAYCAST_PAIRS

    src = (kernels.CSRC / "raycast.cu").read_text()
    compiled = {(int(a), int(b)) for a, b in
                re.findall(r"run = &launch<(\d+), (\d+)>", src)}
    assert compiled == set(RAYCAST_PAIRS)
    assert (5, KintinuousConfig().raycast_newton_iters) in compiled
    entry = src[src.index('extern "C" int kt_tile_raycast'):]
    refusals = re.findall(r"if \((.*?)\) return \(int\)cudaErrorInvalidValue", entry)
    assert refusals == ["window < 1 || newton < 0"]
    assert "tile_raycast_loop_kernel<<<" in entry
    for bad in ((0, 1), (5, -1)):
        with pytest.raises(ValueError, match="window >= 1 and newton >= 0"):
            tile_raycast(*_plane_mirror(), *bad)
