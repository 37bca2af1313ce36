"""Port vs JAX: the gather raycast of the fast step with pallas=False
(ops/raycast_fast.py): its x-pair texture bit for bit, and the raycast
on tests/test_pallas_raycast.py's fused volume, warm-started from the
measurement alone and from a previous prediction."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kintinuous_tpu.ops import preprocess as jpp
from kintinuous_tpu.ops.raycast_fast import build_pair_texture as jax_pairs
from kintinuous_tpu.ops.raycast_fast import raycast_fast as jax_raycast_fast
from kintinuous_tpu_torch.ops.raycast_fast import build_pair_texture, raycast_fast
from tests.test_pallas_raycast import _fused_volume
from tests.test_torch_package import port_cam, port_vol, tt

torch.set_num_threads(2)


def test_pair_texture_equals_the_jax_packing_bit_for_bit():
    """A 64^3 volume (8 blocks an edge) of random values, exact zeros of
    both signs and values on bf16 rounding ties: each pair equals JAX's
    u32 unpacked, the +x neighbour taken across the block seam (dx=7 ->
    the next block's dx=0) and across the volume (bx=7 -> bx=0)."""
    rng = np.random.default_rng(0)
    t = rng.standard_normal((512, 4, 128)).astype(np.float32)
    t.reshape(-1)[::7] = 0.0
    t.reshape(-1)[3::11] = -0.0
    # f32 values halfway between two bf16s (round half to even)
    ties = (rng.integers(0, 1 << 15, 4096).astype(np.uint32) << 16) | 0x8000
    t.reshape(-1)[:4096] = ties.view(np.float32)
    ref = np.asarray(jax_pairs(jnp.asarray(t)))  # (512, 512) u32
    got = build_pair_texture(tt(t)).view(torch.int16).numpy().view(np.uint16)
    got = got.astype(np.uint32)
    assert np.array_equal((got[:, 0] << 16) | got[:, 1], ref.reshape(-1))
    # the seams: x = 7 (block 0, dx 7) pairs with x = 8; x = 63 with x = 0
    dense = t.reshape(8, 8, 8, 8, 8, 8).transpose(0, 3, 1, 4, 2, 5).reshape(64, 64, 64)
    pairs = build_pair_texture(tt(t)).float().reshape(8, 8, 8, 8, 8, 8, 2)
    for x in (7, 63):
        bx, dx = divmod(x, 8)
        hi = pairs[2, 3, bx, 1, 5, dx, 1].item()
        nxt = dense[2 * 8 + 1, 3 * 8 + 5, (x + 1) % 64]
        assert hi == float(torch.tensor(nxt).to(torch.bfloat16).float())


@pytest.fixture(scope="module")
def fused():
    cfg, vol, pose, depth_m = _fused_volume()
    depth_half = jpp.pyr_down_depth(depth_m, sigma=0.09)
    return cfg, vol, pose, depth_half


@pytest.mark.parametrize("warm", ["measured", "previous"])
def test_raycast_fast_matches_jax(fused, warm):
    """Hit masks differ on <= 0.1 % of pixels (measured: none of about
    2,400 hits); where both hit, depth within 1e-5 m on >= 99.9 % of
    pixels (measured: all, the largest difference 3.6e-7 m), median
    normal dot > 0.9999 (measured: 1.0, the least 0.99999976), weights
    and colours equal on >= 99.9 % (measured: all). "previous"
    forward-warps a prediction cast 2 cm to the side into the pose (the
    z-buffer splat, the min dilations and the measured fallback)."""
    cfg, vol, pose, depth_half = fused
    cam = cfg.camera.at_level(1)
    args = (cfg.voxel_size, cfg.volume_size, cfg.trunc_dist)
    prev = None
    if warm == "previous":
        side = pose.at[0, 3].add(0.02)
        prev = jax_raycast_fast(vol, cam, side, None, depth_half, *args).vmap
        assert np.isfinite(np.asarray(prev)).all(axis=0).mean() > 0.5
    a = jax_raycast_fast(vol, cam, pose, prev, depth_half, *args)
    b = raycast_fast(port_vol(vol), port_cam(cam), tt(pose),
                     None if prev is None else tt(prev), tt(depth_half), *args)
    assert b.fallback_frac == 0.0
    da, db = np.asarray(a.depth), b.depth.numpy()
    ha, hb = da > 0, db > 0
    assert ha.mean() > 0.45
    assert (ha != hb).mean() <= 1e-3, (ha != hb).sum()
    both = ha & hb
    dd = np.abs(da[both] - db[both])
    assert (dd <= 1e-5).mean() >= 0.999, np.sort(dd)[-5:]
    vd = np.abs(np.asarray(a.vmap)[:, both] - b.vmap.numpy()[:, both])
    assert (vd.max(axis=0) <= 1e-5).mean() >= 0.999
    dots = np.sum(np.asarray(a.nmap)[:, both] * b.nmap.numpy()[:, both], axis=0)
    assert np.median(dots) > 0.9999, np.median(dots)
    assert (np.asarray(a.weight)[both] == b.weight.numpy()[both]).mean() >= 0.999
    assert (np.asarray(a.color)[:, both] == b.color.numpy()[:, both]).all(axis=0).mean() \
        >= 0.999
