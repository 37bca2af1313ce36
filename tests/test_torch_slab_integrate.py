"""Port vs JAX: block-classified fusion on z-slabs of the volume, as
each slab of the sharded fast step runs it (resolution R, a slab's
z_block_offset, a non-zero wrap). On the CPU the band-fusion (K1) and
free-carve (K2) wrappers run their plain versions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kintinuous_tpu.config import CameraIntrinsics
from kintinuous_tpu.io.synth import orbit_trajectory
from kintinuous_tpu.ops.blocked import make_blocked_volume as jmake
from kintinuous_tpu.ops.pallas_integrate import integrate_pallas
from kintinuous_tpu.ops.tsdf_fast import build_depth_tables as j_tables
from kintinuous_tpu.ops.tsdf_fast import classify_blocks as j_classify
from kintinuous_tpu.ops.tsdf_fast import integrate_fast as j_integrate_fast
from kintinuous_tpu_torch.ops.blocked import BlockedVolume
from kintinuous_tpu_torch.ops.cuda_integrate import fusion_params, integrate_cuda, integrate_plan
from kintinuous_tpu_torch.ops.tsdf_fast import (
    build_depth_tables, classify_blocks, volume_resolution)
from tests.test_torch_integrate import (
    CAM, CFG, PCAM, assert_volumes_match, frame_inputs, pose_of, unpack)
from tests.test_torch_package import port_cam, port_vol, tt

torch.set_num_threads(2)

R = 128
B = R // 8
N_SLABS = 4
BZ = B // N_SLABS
ROWS = BZ * B * B
WRAP = (8, 16, 88)  # multiples of 8 on each axis, as a shifted volume has


def slab_wrap(i):
    """A wrap that puts the scene's surfaces (logical z 64-127) on slab i."""
    return (8, 16, ((i - 3) % N_SLABS) * 32)


def jax_slab(v, i):
    return v._replace(tsdf=v.tsdf[i * ROWS:(i + 1) * ROWS], cw=v.cw[i * ROWS:(i + 1) * ROWS])


def port_slab(v, i):
    return BlockedVolume(tsdf=v.tsdf[i * ROWS:(i + 1) * ROWS].clone(),
                         cw=v.cw[i * ROWS:(i + 1) * ROWS].clone(), wrap=v.wrap,
                         origin=v.origin)


def start_volume(wrap=WRAP):
    return jmake(R)._replace(wrap=jnp.array(wrap, jnp.int32))


def wall_inputs():
    """A wall 2.4 m ahead of a 320x240 camera: free space in front of it
    (the carve needs the interior of 32-pixel cells dilated by two)."""
    cam = CameraIntrinsics(fx=280.0, fy=280.0, cx=160.0, cy=120.0, width=320, height=240)
    dm = np.full((cam.height, cam.width), 2.4, np.float32)
    return port_cam(cam), dm, np.full((*dm.shape, 3), 90.0, np.float32), np.ones_like(dm)


FRAMES = orbit_trajectory(2, radius=0.1, angle_deg=8.0)


def test_slab_classification_is_the_whole_volumes_rows():
    """classify_blocks on slab i (resolution, z_blocks, z_block_offset)
    gives the whole volume's block-planes [i*Bz, (i+1)*Bz), and the JAX
    package's slab classification gives the same classes."""
    dm, rgb, cw = frame_inputs(np.eye(4))
    T = pose_of(np.eye(4))
    vp = port_vol(start_volume())
    tables = build_depth_tables(PCAM, tt(dm), tt(rgb), tt(cw))
    Tinv = torch.linalg.inv(tt(T))
    whole = classify_blocks(vp, PCAM, tables, Tinv, CFG.voxel_size, CFG.trunc_dist)
    jt = j_tables(CAM, jnp.asarray(dm), jnp.asarray(rgb), jnp.asarray(cw))
    for i in range(N_SLABS):
        sl = port_slab(vp, i)
        got = classify_blocks(sl, PCAM, tables, Tinv, CFG.voxel_size, CFG.trunc_dist,
                              resolution=R, z_blocks=BZ, z_block_offset=i * BZ)
        assert torch.equal(got, whole[i * BZ:(i + 1) * BZ])
        jcls = j_classify(jax_slab(start_volume(), i), CAM, jt, jnp.asarray(T),
                          CFG.voxel_size, CFG.trunc_dist, resolution=R, z_blocks=BZ,
                          z_block_offset=i * BZ)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jcls))
    assert (whole == 2).sum() > 50


@pytest.mark.parametrize("slab", range(N_SLABS))
def test_slab_fusion_matches_integrate_fast(slab):
    """K1 and K2's plain versions on one slab, two frames, against JAX
    integrate_fast(resolution=R, z_block_offset=slab*Bz): weights equal,
    tsdf within 1e-5, colour within one step."""
    vj = jax_slab(start_volume(slab_wrap(slab)), slab)
    vp = port_vol(vj)
    Ts = [pose_of(Tw) for Tw in FRAMES]
    for Tw, T in zip(FRAMES, Ts):
        dm, rgb, cw = frame_inputs(Tw)
        vj = j_integrate_fast(vj, CAM, jnp.asarray(dm), jnp.asarray(rgb), jnp.asarray(cw),
                              jnp.asarray(T), CFG.voxel_size, CFG.trunc_dist, 128.0,
                              band_cap=2048, resolution=R, z_block_offset=slab * BZ)
        integrate_cuda(vp, PCAM, tt(dm), tt(rgb), tt(cw), tt(T), CFG.voxel_size,
                       CFG.trunc_dist, 128.0, band_cap=2048, resolution=R,
                       z_block_offset=slab * BZ)
    assert (unpack(vj.cw)[0] > 0).sum() > 1000
    assert_volumes_match(vj, vp, 1e-5, 0.0, both_fused_colour=False)


def test_slabs_concatenated_equal_the_whole_volume():
    """The four slabs fused one by one, concatenated, equal the whole
    volume fused at the same wrap bit for bit, band fusion (K1) and free
    carve (K2) alike: the arithmetic per voxel is the same, only the
    addressing moved. The wall frame's free blocks fall on slab 2."""
    whole = port_vol(start_volume())
    slabs = [port_slab(whole, i) for i in range(N_SLABS)]
    T = tt(pose_of(np.eye(4)))
    wcam, *wall = wall_inputs()
    frames = [(PCAM, *frame_inputs(np.eye(4))), (wcam, *wall)]
    n_free = [0] * N_SLABS
    for cam, dm, rgb, cw in frames:
        args = (cam, tt(dm), tt(rgb), tt(cw), T, CFG.voxel_size, CFG.trunc_dist)
        integrate_cuda(whole, *args, 128.0, band_cap=8192)
        for i, sl in enumerate(slabs):
            _, lists, _ = integrate_plan(sl, *args, band_cap=8192, resolution=R,
                                         z_block_offset=i * BZ)
            n_free[i] += int(lists.n_free)
            integrate_cuda(sl, *args, 128.0, band_cap=8192, resolution=R,
                           z_block_offset=i * BZ)
    assert n_free[2] > 20, n_free
    cat_t = torch.cat([s.tsdf for s in slabs])
    cat_c = torch.cat([s.cw for s in slabs])
    assert torch.equal(cat_t.view(torch.int32), whole.tsdf.view(torch.int32))
    assert torch.equal(cat_c, whole.cw)
    assert int((whole.cw != 0).sum()) > 10_000


@pytest.mark.parametrize("slab", [0, 2])
def test_slab_fusion_matches_integrate_pallas_interpret(slab):
    """Against the TPU kernel (interpret mode) on a slab, at
    tests/test_pallas_integrate.py's tolerances (its bf16 hi/lo ray
    split flips a rare boundary voxel)."""
    Tw = FRAMES[0]
    dm, rgb, cw = frame_inputs(Tw)
    T = pose_of(Tw)
    vj = jax_slab(start_volume(slab_wrap(slab)), slab)
    vp = port_vol(vj)
    vj = integrate_pallas(vj, CAM, jnp.asarray(dm), jnp.asarray(rgb), jnp.asarray(cw),
                          jnp.asarray(T), CFG.voxel_size, CFG.trunc_dist,
                          band_cap=min(2048, ROWS), t1_cap=min(4096, ROWS),
                          t2_cap=min(1024, ROWS), fb_cap=min(128, ROWS),
                          free_cap=ROWS, interpret=True, resolution=R,
                          z_block_offset=slab * BZ)
    integrate_cuda(vp, PCAM, tt(dm), tt(rgb), tt(cw), tt(T), CFG.voxel_size,
                   CFG.trunc_dist, band_cap=2048, resolution=R, z_block_offset=slab * BZ)
    assert (unpack(vj.cw)[0] > 0).sum() > 1000
    assert_volumes_match(vj, vp, 5e-3, 1e-3)


def test_slab_addressing_contract():
    """params is the Pallas layout, 16 floats with the offset last; a
    slab needs its resolution; the mirror refresh takes only a whole
    volume."""
    p = fusion_params(torch.eye(4), torch.tensor([8, 16, 24], dtype=torch.int32), 12)
    assert p.shape == (16,) and p[12:].tolist() == [8.0, 16.0, 24.0, 12.0]
    assert fusion_params(torch.eye(4), torch.zeros(3, dtype=torch.int32))[15] == 0
    assert volume_resolution(B ** 3) == R
    assert volume_resolution(ROWS, R, 4) == R
    with pytest.raises(ValueError, match="resolution"):
        volume_resolution(ROWS)
    with pytest.raises(ValueError, match="resolution"):
        volume_resolution(B ** 3, None, 4)
    sl = port_slab(port_vol(start_volume()), 1)
    dm, rgb, cw = frame_inputs(np.eye(4))
    with pytest.raises(ValueError, match="mirror"):
        integrate_cuda(sl, PCAM, tt(dm), tt(rgb), tt(cw), tt(pose_of(np.eye(4))),
                       CFG.voxel_size, CFG.trunc_dist, resolution=R, z_block_offset=BZ,
                       mirror=torch.zeros((R, R, R), dtype=torch.bfloat16))
