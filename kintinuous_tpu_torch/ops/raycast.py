"""Raycasting the dense rolling TSDF volume (port of
kintinuous_tpu/ops/raycast.py: RaycastResult, _ray_box, raycast).

Every pixel's ray marches at a fixed step of step_factor * trunc_dist
from max(min_range, box entry) until the volume's exit or max_range; a
+ -> - crossing of the trilinear tsdf between two samples is refined by
linear interpolation. Normals are the analytic gradient of the
trilinear cell at the hit, colour and weight the nearest voxel's.

Plain PyTorch on any device: the JAX package computes this with XLA,
outside any Pallas kernel. The JAX march is a fixed-length fori_loop
over all rays. Once no ray is active (each has hit or passed its stop),
the remaining steps change no value, so the loop here reads on the host
every CHECK_EVERY steps whether any ray is still active and stops when
none is: the same bits, fewer launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from kintinuous_tpu_torch.config import CameraIntrinsics
from kintinuous_tpu_torch.ops.tsdf import (
    VolumeState, _corners, _gradient, _lerp3, div_f32, sqrt_rn, unpack_cw)

CHECK_EVERY = 32  # march steps between host reads of "any ray active"


class RaycastResult(NamedTuple):
    vmap: torch.Tensor  # (3,H,W) hit points, local-volume metres; NaN = miss
    nmap: torch.Tensor  # (3,H,W) unit normals (out of the surface); NaN = miss
    color: torch.Tensor  # (3,H,W) RGB 0..255 (0 on a miss)
    weight: torch.Tensor  # (H,W) fusion weight at the hit (0 on a miss)
    depth: torch.Tensor  # (H,W) camera z-depth (0 on a miss)


def _ray_box(o: torch.Tensor, d: torch.Tensor, box_size: float):
    """Slab intersection of the rays o + t d (d (3,H,W)) with [0, box]^3:
    (t_near, t_far)."""
    tiny = torch.where(d >= 0, 1e-12, -1e-12)
    inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, tiny)
    t0 = (0.0 - o[:, None, None]) * inv
    t1 = (box_size - o[:, None, None]) * inv
    tmin = torch.minimum(t0, t1).amax(dim=0)
    tmax = torch.maximum(t0, t1).amin(dim=0)
    return tmin, tmax


def raycast(vol: VolumeState, cam: CameraIntrinsics, T_cam_to_local: torch.Tensor,
            voxel_size: float, volume_size: float, trunc_dist: float,
            step_factor: float = 0.8, min_range: float = 0.3,
            max_range: float | None = None) -> RaycastResult:
    H, W = cam.height, cam.width
    R = vol.tsdf.shape[0]
    dev = vol.tsdf.device
    step = step_factor * trunc_dist
    if max_range is None:
        max_range = volume_size * math.sqrt(3.0)
    n_steps = int(math.ceil((max_range - min_range) / step))
    step32 = np.float32(step)

    Rot = T_cam_to_local[:3, :3]
    o = T_cam_to_local[:3, 3]
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    rx = div_f32(u - cam.cx, cam.fx).expand(H, W)
    ry = div_f32(v - cam.cy, cam.fy).expand(H, W)
    d = [Rot[i, 0] * rx + Rot[i, 1] * ry + Rot[i, 2] for i in range(3)]
    norm = sqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dn = torch.stack([c / norm for c in d])  # (3,H,W)
    cos_z = Rot[0, 2] * dn[0] + Rot[1, 2] * dn[1] + Rot[2, 2] * dn[2]

    t_near, t_far = _ray_box(o, dn, volume_size)
    t_start = torch.clamp(t_near + 1e-5, min=min_range)
    t_stop = torch.clamp(t_far - 1e-5, max=max_range)
    flat = vol.tsdf.reshape(-1)
    vsz = torch.full((), voxel_size, dtype=torch.float32, device=dev)

    o3 = o[:, None, None]

    def at(t):
        """(3,H,W) [x,y,z] voxel coordinates of the rays at t."""
        return (o3 + t * dn) / vsz - 0.5

    def sample(t):
        return _lerp3(*_corners(flat, R, vol.wrap, at(t)))

    prev = sample(t_start)
    found = torch.zeros((H, W), dtype=torch.bool, device=dev)
    t_hit = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for i in range(n_steps):
        t = t_start + float(np.float32(i + 1) * step32)
        active = ~found & (t <= t_stop)
        if i and i % CHECK_EVERY == 0 and not bool(active.any()):
            break  # no ray is active at this t or any later one
        val = sample(t)
        crossing = active & (prev > 0) & (val < 0)
        denom = prev - val
        frac_t = torch.where(torch.abs(denom) > 1e-12, prev / denom, 0.5)
        t_cross = (t - float(step32)) + float(step32) * frac_t
        t_hit = torch.where(crossing, t_cross, t_hit)
        found = found | crossing
        prev = torch.where(active, val, prev)

    pos_hit = o3 + t_hit * dn
    pv = at(t_hit)
    gx, gy, gz = _gradient(*_corners(flat, R, vol.wrap, pv))
    gnorm = sqrt_rn(gx * gx + gy * gy + gz * gz)
    g = torch.clamp(gnorm, min=1e-12)
    normal = torch.stack([gx / g, gy / g, gz / g])
    ok = found & (gnorm > 1e-9)

    # nearest voxel's colour and weight at the hit (visual only)
    ix, iy, iz = (torch.round(pv).to(torch.int32) + vol.wrap[:, None, None]) % R
    wgt, cr, cg, cb = unpack_cw(vol.cw.reshape(-1)[(iz * R + iy) * R + ix])
    nan = torch.full((), math.nan, dtype=torch.float32, device=dev)
    return RaycastResult(
        vmap=torch.where(ok[None], pos_hit, nan),
        nmap=torch.where(ok[None], normal, nan),
        color=torch.where(ok[None], torch.stack([cr, cg, cb]), 0.0),
        weight=torch.where(ok, wgt, 0.0),
        depth=torch.where(ok, t_hit * cos_z, 0.0),
    )
