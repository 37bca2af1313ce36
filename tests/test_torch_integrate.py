"""Port vs JAX: block-classified fusion. On the CPU the band-fusion and
free-carve wrappers run their plain versions, which hold the exact
per-voxel formula of the JAX package's integrate_fast."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kintinuous_tpu.config import CameraIntrinsics, KintinuousConfig
from kintinuous_tpu.io.synth import Scene, orbit_trajectory, render_frame
from kintinuous_tpu.ops import maps as jmaps
from kintinuous_tpu.ops import preprocess as jpp
from kintinuous_tpu.ops.blocked import make_blocked_volume as jmake
from kintinuous_tpu.ops.pallas_integrate import integrate_pallas
from kintinuous_tpu.ops.tsdf_fast import integrate_fast as j_integrate_fast
from kintinuous_tpu_torch.ops.blocked import blocked_to_dense
from kintinuous_tpu_torch.ops.cuda_integrate import (
    free_carve, integrate_cuda, integrate_plan)
from kintinuous_tpu_torch.ops.tsdf import sqrt_rn
from tests.test_torch_package import port_cam, port_vol, tt

torch.set_num_threads(2)

CAM = CameraIntrinsics(fx=140.0, fy=140.0, cx=80.0, cy=60.0, width=160, height=120)
PCAM = port_cam(CAM)
CFG = KintinuousConfig(camera=CAM, volume_size=3.0, volume_resolution=128,
                       fast_mode=True, bilateral_radius=2, band_cap=2048)


def frame_inputs(T_world):
    d, rgb = render_frame(Scene.default(), CAM, T_world)
    dm = np.asarray(jpp.depth_to_metres(jnp.asarray(d, jnp.float32), 6.0))
    disc = jpp.depth_discontinuity_mask(jnp.asarray(dm), radius=3, jump_m=0.2)
    cw = np.asarray(jmaps.color_fusion_weight(CAM, jnp.asarray(dm), disc))
    return dm, rgb.astype(np.float32), cw


def pose_of(T_world):
    T = np.array(T_world, np.float32)
    T[:3, 3] += CFG.volume_size / 2.0
    return T


def unpack(cw):
    c = np.asarray(cw).view(np.uint32)
    return [((c >> s) & 0xFF).astype(np.int64) for s in (24, 16, 8, 0)]


def voxel_pixels(rows, cells, wrap, poses, R=128):
    """The float64 pixel coordinate (x, y), before rounding, of each
    voxel (block row, cell) under each camera pose: (n_poses, n, 2)."""
    B = R // 8
    p = np.stack([(rows % B) * 8 + (cells & 7),
                  (rows // B) % B * 8 + ((cells >> 3) & 7),
                  rows // (B * B) * 8 + (cells >> 6)], axis=1)
    g = (np.mod(p - np.asarray(wrap)[None], R) + 0.5) * CFG.voxel_size
    out = []
    for T in poses:
        Ti = np.linalg.inv(np.asarray(T, np.float64))
        c = g @ Ti[:3, :3].T + Ti[:3, 3]
        out.append(np.stack([c[:, 0] / c[:, 2] * CAM.fx + CAM.cx,
                             c[:, 1] / c[:, 2] * CAM.fy + CAM.cy], axis=1))
    return np.array(out)


def mismatch_report(vj, vp, poses, first=8):
    """Row, cell, both weights, both tsdf values and the float64 pixel
    coordinate of the first voxels whose weights differ."""
    tj, tp = np.asarray(vj.tsdf).reshape(-1, 512), vp.tsdf.numpy().reshape(-1, 512)
    wj, wp = (unpack(c)[0].reshape(-1, 512) for c in (vj.cw, vp.cw.numpy()))
    rows, cells = np.nonzero(wj != wp)
    rows, cells = rows[:first], cells[:first]
    px = voxel_pixels(rows, cells, np.asarray(vj.wrap), poses)
    return "\n".join(
        f"row {r} cell {c}: weight jax {wj[r, c]} port {wp[r, c]}, tsdf jax "
        f"{tj[r, c]!r} port {tp[r, c]!r}, pixel (x, y) per frame {px[:, k].tolist()}"
        for k, (r, c) in enumerate(zip(rows, cells)))


def assert_volumes_match(vj, vp, tsdf_atol, w_mis_max, both_fused_colour=True,
                         poses=()):
    tj, tp = np.asarray(vj.tsdf), vp.tsdf.numpy()
    (wj, *cj), (wp, *cp) = unpack(vj.cw), unpack(vp.cw.numpy())
    mis = (wj != wp).mean()
    assert mis <= w_mis_max, (
        f"weight mismatch fraction {mis}\n{mismatch_report(vj, vp, poses)}")
    same = wj == wp
    np.testing.assert_allclose(tp[same], tj[same], atol=tsdf_atol)
    sel = same & (wj > 0) & (wp > 0) if both_fused_colour else same
    for a, b in zip(cj, cp):
        assert np.abs(a - b)[sel].max(initial=0) <= 1


@pytest.mark.parametrize("case", ["one_frame", "three_frames", "wrap"])
def test_band_fusion_and_carve_match_integrate_fast(case):
    """Weights equal, tsdf within 1e-5 (f32 association: the sdf and the
    running average are the same operations), colour within one step
    (a mix that lands on .5 may truncate to either side)."""
    poses = orbit_trajectory(3, radius=0.1, angle_deg=8.0) if case == "three_frames" \
        else [np.eye(4)]
    vj = jmake(128)
    if case == "wrap":
        vj = vj._replace(wrap=jnp.array([8, 16, 8], jnp.int32))
    vp = port_vol(vj)
    Ts = [pose_of(Tw) for Tw in poses]
    for Tw, T in zip(poses, Ts):
        dm, rgb, cw = frame_inputs(Tw)
        vj = j_integrate_fast(vj, CAM, jnp.asarray(dm), jnp.asarray(rgb), jnp.asarray(cw),
                              jnp.asarray(T), CFG.voxel_size, CFG.trunc_dist, 128.0,
                              band_cap=2048)
        integrate_cuda(vp, PCAM, tt(dm), tt(rgb), tt(cw), tt(T), CFG.voxel_size,
                       CFG.trunc_dist, 128.0, band_cap=2048)
    assert (unpack(vj.cw)[0] > 0).sum() > 10_000
    assert_volumes_match(vj, vp, 1e-5, 0.0, both_fused_colour=False, poses=Ts)


def test_sqrt_rn_is_correctly_rounded():
    """The fusion's ray lengths take sqrt_rn: equal to numpy's correctly
    rounded f32 sqrt on every input (torch.sqrt on the CPU goes through
    MKL, which on AVX-512 is one ulp off on some inputs)."""
    a = np.random.default_rng(5).uniform(1e-3, 40.0, 200_003).astype(np.float32)
    got = sqrt_rn(torch.from_numpy(a)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), np.sqrt(a).view(np.int32))


@pytest.mark.parametrize("n_frames", [1, 2])
def test_band_fusion_matches_integrate_pallas_interpret(n_frames):
    """Against the TPU kernel (interpret mode) at tests/test_pallas_
    integrate.py's tolerances: its bf16 hi/lo ray split flips a rare
    sdf >= -trunc boundary (weight mismatch < 1e-3, tsdf atol 5e-3), and
    it samples colour at half resolution (uniform colour: +-1)."""
    from tests.test_tsdf import CAM as SCAM, CFG as SCFG, SPHERE_CAM, SPHERE_R, sphere_depth

    depth = sphere_depth(SCAM, SPHERE_CAM, SPHERE_R)
    rgb = np.full((SCAM.height, SCAM.width, 3), 128.0, np.float32)
    disc = np.zeros(depth.shape, bool)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = SCFG.volume_size / 2
    vj = jmake(SCFG.volume_resolution)
    vp = port_vol(vj)
    for _ in range(n_frames):
        vj = integrate_pallas(vj, SCAM, jnp.asarray(depth), jnp.asarray(rgb),
                              jnp.asarray(disc), jnp.asarray(T), SCFG.voxel_size,
                              SCFG.trunc_dist, band_cap=2048, fb_cap=512, interpret=True)
        integrate_cuda(vp, port_cam(SCAM), tt(depth), tt(rgb), tt(disc), tt(T),
                       SCFG.voxel_size, SCFG.trunc_dist, band_cap=2048)
    assert (unpack(vj.cw)[0] > 0).sum() > 1000
    assert_volumes_match(vj, vp, 5e-3, 1e-3)


def test_free_carve_is_bit_exact_on_a_prefilled_volume():
    """A wall 2.4 m ahead leaves blocks in observed free space; on a
    volume pre-filled with random tsdf and colour bytes the carved rows
    equal the JAX package's bit for bit, the rgb bytes are kept."""
    rng = np.random.default_rng(3)
    R = 128
    n_rows = (R // 8) ** 3
    tsdf = rng.uniform(-1, 1, (n_rows, 4, 128)).astype(np.float32)
    w = rng.integers(0, 129, (n_rows, 4, 128), dtype=np.uint32)
    rgb_bits = rng.integers(0, 1 << 24, (n_rows, 4, 128), dtype=np.uint32)
    vj = jmake(R)._replace(tsdf=jnp.asarray(tsdf), cw=jnp.asarray((w << 24) | rgb_bits))
    vp = port_vol(vj)
    # 32-pixel classification cells dilated by two: a free block needs
    # the 320x240 camera's interior cells
    cam = CameraIntrinsics(fx=280.0, fy=280.0, cx=160.0, cy=120.0, width=320, height=240)
    dm = np.full((cam.height, cam.width), 2.4, np.float32)
    rgb = np.full((cam.height, cam.width, 3), 90.0, np.float32)
    cw = np.ones_like(dm)
    T = pose_of(np.eye(4))
    _, lists, _ = integrate_plan(vp, port_cam(cam), tt(dm), tt(rgb), tt(cw), tt(T),
                                 CFG.voxel_size, CFG.trunc_dist, 2048)
    n_free = int(lists.n_free)
    assert n_free > 20
    vj = j_integrate_fast(vj, cam, jnp.asarray(dm), jnp.asarray(rgb), jnp.asarray(cw),
                          jnp.asarray(T), CFG.voxel_size, CFG.trunc_dist, 128.0,
                          band_cap=2048)
    integrate_cuda(vp, port_cam(cam), tt(dm), tt(rgb), tt(cw), tt(T), CFG.voxel_size,
                   CFG.trunc_dist, 128.0, band_cap=2048)
    rows = lists.free_ids[:n_free].numpy()
    tj = np.asarray(vj.tsdf)[rows]
    cj = np.asarray(vj.cw).view(np.int32)[rows]
    assert np.array_equal(vp.tsdf.numpy()[rows].view(np.int32), tj.view(np.int32))
    assert np.array_equal(vp.cw.numpy()[rows], cj)
    assert np.array_equal(cj.view(np.uint32) & 0xFFFFFF, rgb_bits[rows])
    # the carve raised every weight below the cap by one
    assert np.array_equal(cj.view(np.uint32) >> 24, np.minimum(w[rows] + 1, 128))


def test_free_carve_count_zero_leaves_the_volume():
    rng = np.random.default_rng(4)
    t = torch.from_numpy(rng.standard_normal((64, 4, 128)).astype(np.float32))
    c = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (64, 4, 128), dtype=np.int64)
                         .astype(np.int32))
    t0, c0 = t.clone(), c.clone()
    ids = torch.arange(16, dtype=torch.int32)
    free_carve(t, c, ids, torch.tensor(0, dtype=torch.int32), 128.0)
    assert torch.equal(t, t0) and torch.equal(c, c0)
    free_carve(t, c, ids, torch.tensor(3, dtype=torch.int32), 128.0)
    assert not torch.equal(t[:3], t0[:3]) and torch.equal(t[3:], t0[3:])
    assert torch.equal(c[3:], c0[3:])


def test_integrate_keeps_the_mirror_current():
    """The refresh of the frame's dirty row-pairs leaves the mirror equal
    to a full bf16 rebuild of the volume."""
    R = 128
    vp = port_vol(jmake(R))
    mirror = torch.zeros((R, R, R), dtype=torch.bfloat16)
    for Tw in orbit_trajectory(2, radius=0.1, angle_deg=8.0):
        dm, rgb, cw = frame_inputs(Tw)
        integrate_cuda(vp, PCAM, tt(dm), tt(rgb), tt(cw), tt(pose_of(Tw)),
                       CFG.voxel_size, CFG.trunc_dist, band_cap=2048, mirror=mirror)
    full = blocked_to_dense(vp.tsdf).to(torch.bfloat16)
    assert torch.equal(mirror, full)
    assert int((mirror != 0).sum()) > 10_000
