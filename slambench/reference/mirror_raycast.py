# Frozen copy of kintinuous_tpu_torch/ops/cuda_raycast.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""Mirror refresh, mirror rebuild and warm-started raycast on the card
(counterpart of kintinuous_tpu/ops/pallas_raycast.py:
update_logical_pairs, build_logical_bf16, raycast_pallas and its post
step).

The raycast reads a dense (R,R,R) bf16 mirror of the blocked volume
that integration keeps current (`mirror_refresh`, csrc/logical.cu);
`build_mirror` (same source) rebuilds it whole, on checkpoint restore
and for a raycast given no mirror.
`tile_raycast` (csrc/raycast.cu) marches each half-resolution pixel
around its warm-start depth; PyTorch code around it builds the warm
start, and turns the hits into vertex, normal, colour and depth maps
with the measurement fallback. The TPU's per-tile VMEM regions, their
median centring and the second-chance pass are not ported: a Hopper
thread reads the mirror directly, so no pixel misses a region.

Only the plain PyTorch versions of the kernels are kept here, on any
device: the reference launches no kernel. `raycast_mirror` is the
program's `raycast_cuda`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from slambench.reference.config import CameraIntrinsics
from slambench.reference import maps as map_ops
from slambench.reference.blocked import BLOCK, blocked_to_dense, flat_index
from slambench.reference.raycast_fast import FastRaycastResult, ray_directions
from slambench.reference.reduce import round_to_int
from slambench.reference.tsdf import unpack_cw



def _f32(x: float) -> float:
    """The float32 value of x, as a Python float (exact in f32)."""
    return float(np.float32(x))


# ---------------------------------------------------------------- mirror
def mirror_refresh_plain(tsdf, mirror, pairs, count) -> None:
    """Plain version of the mirror-refresh kernel, in place: the first
    `count` pairs of `pairs` are rewritten as bf16 (round to nearest
    even, zero written as +0.0); all other voxels are kept."""
    R = mirror.shape[0]
    B = R // BLOCK
    n_pairs = pairs.shape[0]
    k = torch.arange(n_pairs, device=pairs.device)
    slot = torch.where(k < count, k, 0)
    p = pairs.long()[slot]
    live = (slot < count)[:, None, None, None]
    rows = tsdf.reshape(n_pairs, 2, B, BLOCK, BLOCK, BLOCK)[p]  # [j,bx,dz,dy,dx]
    slab = rows.permute(0, 3, 1, 4, 2, 5).reshape(-1, BLOCK, 2 * BLOCK, R)
    slab = torch.where(slab == 0, 0.0, slab).to(torch.bfloat16)
    m5 = mirror.view(B, BLOCK, B // 2, 2 * BLOCK, R)  # [bz, dz, pair-y, yy, x]
    bz, py = p // (B // 2), p % (B // 2)
    m5[bz, :, py] = torch.where(live, slab, m5[bz, :, py])


def build_mirror_plain(tsdf, R: int, out=None) -> torch.Tensor:
    """Plain version of the full-rebuild kernel: the dense (R,R,R) bf16
    mirror of the blocked tsdf, round to nearest even, zero as +0.0."""
    dense = blocked_to_dense(tsdf)
    mirror = torch.where(dense == 0, 0.0, dense).to(torch.bfloat16)
    if out is None:
        return mirror
    out.copy_(mirror)
    return out


# ---------------------------------------------------------------- march
def raycast_params(T: torch.Tensor) -> torch.Tensor:
    """(12,) f32 [origin (3) | rotation row-major (9)] of a camera pose."""
    return torch.cat([T[:3, 3], T[:3, :3].reshape(-1)]).contiguous()


def _tap_plain(mirror_flat, R, o, dn, inv_vsz, t, hi, hc):
    """Trilinear value + analytic gradient at o + t*dn, in the kernel's
    order of operations (x, then y, then z)."""
    v = [(o[a] + t * dn[a]) * inv_vsz - 0.5 for a in range(3)]
    inreg = torch.ones_like(t, dtype=torch.bool)
    for a in range(3):
        inreg = inreg & (v[a] >= 0.0) & (v[a] <= hi)
    v = [torch.clamp(c, 0.0, hc) for c in v]
    i = [torch.floor(c) for c in v]
    f = [c - ic for c, ic in zip(v, i)]
    ix, iy, iz = (c.long() for c in i)
    fx, fy, fz = f
    base = (iz * R + iy) * R + ix
    sy, sz = R, R * R

    def ld(off):
        return mirror_flat[base + off].to(torch.float32)

    v000, v001, v010, v011 = ld(0), ld(1), ld(sy), ld(sy + 1)
    v100, v101, v110, v111 = ld(sz), ld(sz + 1), ld(sz + sy), ld(sz + sy + 1)
    ax, ay, az = 1.0 - fx, 1.0 - fy, 1.0 - fz
    a00 = v000 * ax + v001 * fx
    a01 = v010 * ax + v011 * fx
    a10 = v100 * ax + v101 * fx
    a11 = v110 * ax + v111 * fx
    b0 = a00 * ay + a01 * fy
    b1 = a10 * ay + a11 * fy
    val = b0 * az + b1 * fz
    d00, d01, d10, d11 = v001 - v000, v011 - v010, v101 - v100, v111 - v110
    gx = (d00 * ay + d01 * fy) * az + (d10 * ay + d11 * fy) * fz
    gy = (a01 - a00) * az + (a11 - a10) * fz
    gz = b1 - b0
    return val, inreg, gx, gy, gz


def tile_raycast_plain(mirror, t_warm, params, cam: CameraIntrinsics,
                       voxel_size: float, trunc_dist: float, window: int,
                       newton: int):
    """Plain version of the raycast kernel: per pixel, the window march
    for the first + -> - crossing and `newton` Newton steps. Returns
    (t_hit, found, gx, gy, gz), each (h,w) f32."""
    h, w = t_warm.shape
    R = mirror.shape[0]
    dev = t_warm.device
    inv_vsz = _f32(1.0 / voxel_size)
    step = _f32(0.8 * trunc_dist)
    trunc = _f32(trunc_dist)
    hi = _f32(np.float32(R) - np.float32(1.001))
    hc = _f32(np.float32(R) - np.float32(1.002))
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    # tensor divisors: on the card PyTorch divides by a Python float as a
    # product with its reciprocal, which rounds apart from the kernel's
    # division (on the CPU both are the division)
    rxc = (u - cam.cx) / torch.full_like(u, cam.fx)
    ryc = (v - cam.cy) / torch.full_like(v, cam.fy)
    o = params[0:3]
    d = [params[3 + 3 * r] * rxc + params[4 + 3 * r] * ryc + params[5 + 3 * r]
         for r in range(3)]
    inv_n = 1.0 / torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dn = [c * inv_n for c in d]
    flat = mirror.reshape(-1)

    t0 = t_warm - _f32(np.float32(window // 2) * np.float32(step))
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    ok_all = t_warm > 0.0
    t_hit = torch.zeros((h, w), dtype=torch.float32, device=dev)
    prev_val = torch.zeros_like(t_hit)
    prev_t = t0
    for k in range(window):
        tk = t0 + _f32(np.float32(k) * np.float32(step))
        val, inreg, _, _, _ = _tap_plain(flat, R, o, dn, inv_vsz, tk, hi, hc)
        ok_all = ok_all & inreg
        if k > 0:
            crossing = torch.logical_not(found) & (prev_val > 0) & (val < 0)
            denom = prev_val - val
            big = torch.abs(denom) > 1e-12
            frac = torch.where(big, prev_val / torch.where(big, denom, 1.0), 0.5)
            t_hit = torch.where(crossing, prev_t + step * frac, t_hit)
            found = found | crossing
        prev_val = val
        prev_t = tk
    found = found & ok_all
    gx = gy = gz = torch.zeros_like(t_hit)
    for _ in range(newton):
        val, inreg, gx, gy, gz = _tap_plain(flat, R, o, dn, inv_vsz, t_hit, hi, hc)
        found = found & inreg
        dval_dt = (gx * dn[0] + gy * dn[1] + gz * dn[2]) * inv_vsz
        big = torch.abs(dval_dt) > 1e-6
        nstep = torch.where(big, val / torch.where(big, dval_dt, 1.0), 0.0)
        t_hit = t_hit - torch.clamp(nstep, -2.0 * trunc, 2.0 * trunc)
    t_out = torch.where(found, t_hit, 0.0)
    return t_out, found.to(torch.float32), gx, gy, gz


# the (window, newton) pairs csrc/raycast.cu unrolls; every other pair
# with window >= 1 and newton >= 0 runs its run-time loops
RAYCAST_PAIRS = ((5, 0), (5, 1), (5, 2))


def _raycast_constants(cam: CameraIntrinsics, voxel_size: float,
                       trunc_dist: float) -> tuple:
    """The kernel's f32 arguments after R: inv_vsz, fx, fy, cx, cy, step,
    trunc."""
    return (_f32(1.0 / voxel_size), cam.fx, cam.fy, cam.cx, cam.cy,
            _f32(0.8 * trunc_dist), trunc_dist)


# ---------------------------------------------------------------- around
def ray_setup(cam: CameraIntrinsics, T, measured_depth):
    """Unit ray directions (3,h,w) in the local frame, the cosine of each
    ray to the optical axis (h,w), and the warm-start ray lengths t_warm
    (h,w; 0 = none) that the raycast kernel marches around: the measured
    depth's, as the JAX package's fast step warms without a previous
    prediction (its _warm_start with prev_vmap=None)."""
    dn, cos_z, lam = ray_directions(cam, T)
    t_warm = torch.where(measured_depth > 0, measured_depth * lam, 0.0).contiguous()
    return dn, cos_z, t_warm


def raycast_mirror(vol, cam: CameraIntrinsics, T, measured_depth, voxel_size: float, volume_size: float,
                 trunc_dist: float, mirror: Optional[torch.Tensor] = None,
                 window: int = 5, newton: int = 1) -> FastRaycastResult:
    """Predicted vertex/normal maps at the (half-resolution) camera `cam`
    from the mirror, warm-started from the measured depth. Pixels with
    no model hit but a measurement take the measurement's own vertex and
    normal; `fallback_frac` is their share of the in-volume rays. Without
    a mirror, one is built from the volume first (`build_mirror`), as
    raycast_pallas does."""
    if mirror is None:
        mirror = build_mirror_plain(vol.tsdf, vol.resolution)
    R = mirror.shape[0]
    inv_vsz = 1.0 / voxel_size
    Rot = T[:3, :3]
    o = T[:3, 3]
    dn, cos_z, t_warm = ray_setup(cam, T, measured_depth)

    t_hit, found, gx, gy, gz = tile_raycast_plain(
        mirror, t_warm, raycast_params(T), cam, voxel_size, trunc_dist,
        window, newton,
    )
    found = found > 0.5
    grad = torch.stack([gx, gy, gz], dim=-1)
    gnorm = torch.sqrt(torch.sum(grad * grad, dim=-1, keepdim=True))
    ok = found & (gnorm[..., 0] > 1e-9)
    normal = torch.movedim(grad / torch.clamp(gnorm, min=1e-12), -1, 0)
    pos_hit = o[:, None, None] + t_hit[None] * dn

    gi = round_to_int(torch.movedim(pos_hit, 0, -1) * inv_vsz - 0.5)
    px = (gi[..., 0] + vol.wrap[0]) % R
    py = (gi[..., 1] + vol.wrap[1]) % R
    pz = (gi[..., 2] + vol.wrap[2]) % R
    cw = vol.cw.reshape(-1)[flat_index(R, pz, py, px).long()]
    wgt, cr, cg, cb = unpack_cw(cw)

    vm_m = map_ops.create_vmap(cam, measured_depth)
    vm_l = torch.einsum("ij,jhw->ihw", Rot, vm_m) + o[:, None, None]
    nm_l = torch.einsum("ij,jhw->ihw", Rot, map_ops.create_nmap(vm_m))
    facing = torch.sum(nm_l * dn, dim=0)
    nm_l = torch.where(facing[None] > 0, -nm_l, nm_l)
    meas_ok = (
        torch.logical_not(ok)
        & (measured_depth > 0)
        & torch.isfinite(vm_l).all(dim=0)
        & torch.isfinite(nm_l).all(dim=0)
    )
    nan = torch.nan
    vmap_out = torch.where(ok[None], pos_hit, torch.where(meas_ok[None], vm_l, nan))
    nmap_out = torch.where(ok[None], normal, torch.where(meas_ok[None], nm_l, nan))
    either = ok | meas_ok
    depth_out = torch.where(ok, t_hit * cos_z,
                            torch.where(meas_ok, measured_depth, 0.0))
    pos_warm = torch.movedim(o[:, None, None] + t_warm[None] * dn, 0, -1) * inv_vsz
    in_vol = ((pos_warm >= 0.0).all(dim=-1) & (pos_warm <= R - 1.0).all(dim=-1)
              & (t_warm > 0))
    fallback_frac = (meas_ok & in_vol).sum().to(torch.float32) / torch.clamp(
        (either & in_vol).sum().to(torch.float32), min=1.0
    )
    return FastRaycastResult(
        vmap=vmap_out,
        nmap=nmap_out,
        color=torch.where(ok[None], torch.stack([cr, cg, cb], 0), 0.0),
        weight=torch.where(ok, wgt, 0.0),
        depth=depth_out,
        fallback_frac=fallback_frac,
    )
