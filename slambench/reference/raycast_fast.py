# Frozen copy of kintinuous_tpu_torch/ops/raycast_fast.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""The warm-started gather raycast of the fast step when `cfg.pallas` is
False (port of kintinuous_tpu/ops/raycast_fast.py).

Each half-resolution pixel starts near the surface: last frame's
prediction forward-warped into the new pose (when one is given), its
splat holes filled by two 3x3 min dilations, else the current measured
depth. A window of nearest-voxel samples around that start finds the
first + -> - crossing, and two Newton steps on the trilinear field
refine it; the last step's gradient is the normal.

The samples read an x-pair texture: for each voxel, bf16 of its tsdf
and of its +x neighbour's (wrapping across the block and the volume),
so a trilinear evaluation is four row gathers instead of eight. The
JAX package packs the pair into one u32; here it is an (R^3, 2) bf16
tensor in the blocked volume's flat order, gathered by rows, with the
same values.

Plain PyTorch on the tensors' device: the JAX function reaches no
Pallas kernel, so there is no CUDA kernel here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from slambench.reference.config import CameraIntrinsics
from slambench.reference.blocked import BLOCK, flat_index
from slambench.reference.reduce import round_to_int
from slambench.reference.tsdf import trilinear_gradient, unpack_cw

_INF = 1e9  # "no warm start" in the z-buffer


class FastRaycastResult(NamedTuple):
    vmap: torch.Tensor  # (3,h,w) local metres, NaN = miss
    nmap: torch.Tensor  # (3,h,w)
    color: torch.Tensor  # (3,h,w)
    weight: torch.Tensor  # (h,w)
    depth: torch.Tensor  # (h,w) camera z (0 = miss)
    # fraction of in-volume rays answered by the measurement fallback
    # (0.0 for the gather raycast)
    fallback_frac: Union[torch.Tensor, float] = 0.0


def build_pair_texture(tsdf_b: torch.Tensor, xy_blocks: Optional[int] = None) -> torch.Tensor:
    """(B^3,4,128) f32 -> (B^3*512, 2) bf16: row v holds bf16(t[x]) and
    bf16(t[x+1 mod R]) for the voxel at flat offset v and its +x
    neighbour (the next block's dx=0 past dx=7, block B-1 wrapping to
    block 0). xy_blocks: the x/y block count B when tsdf_b holds only
    Bz*B*B rows, a block-z slab of a larger volume."""
    B = xy_blocks if xy_blocks is not None else round(tsdf_b.shape[0] ** (1 / 3))
    Bz = tsdf_b.shape[0] // (B * B)
    t = tsdf_b.reshape(Bz, B, B, BLOCK, BLOCK, BLOCK)  # [bz,by,bx,dz,dy,dx]
    pairs = torch.empty((Bz, B, B, BLOCK, BLOCK, BLOCK, 2), dtype=torch.bfloat16,
                        device=tsdf_b.device)
    pairs[..., 0] = t
    pairs[..., :-1, 1] = t[..., 1:]
    pairs[..., -1, 1] = torch.roll(t[..., 0], -1, dims=2)  # dx=0 of block bx+1
    return pairs.reshape(-1, 2)


def _gather_pairs(pairs, R: int, wrap, ix, iy, iz):
    """The x-pair at integer logical coords, wrapped: (lo, hi) f32."""
    px = torch.remainder(ix + wrap[0], R)
    py = torch.remainder(iy + wrap[1], R)
    pz = torch.remainder(iz + wrap[2], R)
    p = pairs[flat_index(R, pz, py, px).long()].to(torch.float32)
    return p[..., 0], p[..., 1]


def _nearest_pairs(pairs, R: int, wrap, pos_vox):
    """Nearest-voxel tsdf at fractional logical coords (...,3): one row
    gather a sample (lane 0 of the x-pair)."""
    gi = round_to_int(pos_vox)
    return _gather_pairs(pairs, R, wrap, gi[..., 0], gi[..., 1], gi[..., 2])[0]


def _trilinear_pairs(pairs, R: int, wrap, pos_vox):
    """Trilinear value, the corners (...,8) in trilinear_gradient's order
    c000, c100, c010, c110, c001, c101, c011, c111 (x fastest) and the
    fractions (...,3), from four x-pair gathers."""
    base = torch.floor(pos_vox).to(torch.int32)
    frac = pos_vox - base.to(torch.float32)
    bx, by, bz = base[..., 0], base[..., 1], base[..., 2]
    c000, c100 = _gather_pairs(pairs, R, wrap, bx, by, bz)
    c010, c110 = _gather_pairs(pairs, R, wrap, bx, by + 1, bz)
    c001, c101 = _gather_pairs(pairs, R, wrap, bx, by, bz + 1)
    c011, c111 = _gather_pairs(pairs, R, wrap, bx, by + 1, bz + 1)
    corners = torch.stack([c000, c100, c010, c110, c001, c101, c011, c111], dim=-1)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    val = (c00 * (1 - fy) + c10 * fy) * (1 - fz) + (c01 * (1 - fy) + c11 * fy) * fz
    return val, corners, frac


def ray_directions(cam: CameraIntrinsics, T: torch.Tensor):
    """Unit ray directions (3,h,w) of camera `cam` at pose T in the local
    frame, each ray's cosine to the optical axis (h,w), and its length
    per unit of camera z (h,w)."""
    h, w = cam.height, cam.width
    dev = T.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    rx = (u - cam.cx) / cam.fx
    ry = (v - cam.cy) / cam.fy
    lam = torch.sqrt(rx * rx + ry * ry + 1.0)
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    d_cam = torch.stack([rx * ones, ry * ones, ones], dim=0)
    Rot = T[:3, :3]
    d = torch.einsum("ij,jhw->ihw", Rot, d_cam)
    dn = d / torch.sqrt(torch.sum(d * d, dim=0, keepdim=True))
    cos_z = torch.einsum("j,jhw->hw", Rot[:, 2], dn)
    return dn, cos_z, lam


def _dilate_min(x: torch.Tensor) -> torch.Tensor:
    """3x3 min filter, padded with the z-buffer's INF."""
    h, w = x.shape
    p = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1), value=_INF)[0, 0]
    out = x
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, p[dy:dy + h, dx:dx + w])
    return out


def warm_start_z(cam: CameraIntrinsics, T: torch.Tensor,
                 prev_vmap: Optional[torch.Tensor],
                 measured_depth: torch.Tensor) -> torch.Tensor:
    """Camera z (h,w) each ray starts its search at, INF where none: the
    nearest forward-warped previous prediction, its holes filled by two
    3x3 min dilations, else the measured depth."""
    h, w = cam.height, cam.width
    dev = measured_depth.device
    zbuf = torch.full((h * w + 1,), _INF, dtype=torch.float32, device=dev)
    if prev_vmap is not None:
        Tinv = torch.linalg.inv_ex(T)[0]  # no host read of the error code
        pv = torch.einsum("ij,jhw->ihw", Tinv[:3, :3], prev_vmap) + Tinv[:3, 3][:, None, None]
        pz = pv[2].reshape(-1)
        okp = torch.isfinite(pz) & (pz > 0.05)
        zc = torch.clamp(pz, min=1e-6)
        uu = round_to_int(torch.where(okp, pv[0].reshape(-1) / zc, 0.0) * cam.fx + cam.cx)
        vv = round_to_int(torch.where(okp, pv[1].reshape(-1) / zc, 0.0) * cam.fy + cam.cy)
        okp = okp & (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        idx = torch.where(okp, vv * w + uu, h * w)  # slot h*w is dropped
        zbuf.scatter_reduce_(0, idx.long(), torch.where(okp, pz, _INF), "amin")
    zbuf = zbuf[:h * w].reshape(h, w)
    filled = _dilate_min(_dilate_min(zbuf))
    warm_z = torch.where(zbuf < _INF, zbuf, filled)
    return torch.where(warm_z < _INF, warm_z,
                       torch.where(measured_depth > 0, measured_depth, _INF))


def raycast_fast(vol, cam: CameraIntrinsics, T_cam_to_local: torch.Tensor,
                 prev_vmap: Optional[torch.Tensor], measured_depth: torch.Tensor,
                 voxel_size: float, volume_size: float, trunc_dist: float,
                 window: int = 6) -> FastRaycastResult:
    """Predicted maps at the (half-resolution) camera `cam` from the
    blocked volume: a `window`-sample nearest search around each ray's
    warm start, then two Newton steps on the trilinear field. Rays with
    no warm start or no crossing miss (NaN vertex, zero depth)."""
    h, w = cam.height, cam.width
    B = round(vol.tsdf.shape[0] ** (1 / 3))
    R = B * BLOCK
    step = 0.8 * trunc_dist
    inv_vsz = 1.0 / voxel_size
    pairs = build_pair_texture(vol.tsdf)
    o = T_cam_to_local[:3, 3]
    dn, cos_z, lam = ray_directions(cam, T_cam_to_local)

    warm_z = warm_start_z(cam, T_cam_to_local, prev_vmap, measured_depth)
    has_warm = warm_z < _INF
    t_warm = torch.where(has_warm, warm_z * lam, 0.0)

    # windowed search: nearest samples around the warm start
    t0 = t_warm - (window // 2) * step

    def pos_vox_at(t):
        return torch.movedim(o[:, None, None] + t[None] * dn, 0, -1) * inv_vsz - 0.5

    ts = [t0 + i * step for i in range(window)]
    vals = [_nearest_pairs(pairs, R, vol.wrap, pos_vox_at(t)) for t in ts]
    found = torch.zeros((h, w), dtype=torch.bool, device=t0.device)
    t_hit = torch.zeros((h, w), dtype=torch.float32, device=t0.device)
    for i in range(window - 1):
        a, b = vals[i], vals[i + 1]
        crossing = torch.logical_not(found) & (a > 0) & (b < 0)
        denom = a - b
        frac_t = torch.where(torch.abs(denom) > 1e-12, a / denom, 0.5)
        t_hit = torch.where(crossing, ts[i] + step * frac_t, t_hit)
        found = found | crossing
    found = found & has_warm

    # two Newton steps on the trilinear field; the last one's gradient
    # is the normal
    dn_hw = torch.movedim(dn, 0, -1)
    t_ref = t_hit
    grad = torch.zeros((h, w, 3), dtype=torch.float32, device=t0.device)
    for _ in range(2):
        val, corners, frac = _trilinear_pairs(pairs, R, vol.wrap, pos_vox_at(t_ref))
        grad = trilinear_gradient(corners, frac)  # d val / d voxel coordinate
        dval_dt = torch.sum(grad * dn_hw, dim=-1) * inv_vsz
        newton = torch.where(torch.abs(dval_dt) > 1e-6, val / dval_dt, 0.0)
        t_ref = t_ref - torch.clamp(newton, -2.0 * trunc_dist, 2.0 * trunc_dist)
    t_hit = torch.where(found, t_ref, t_hit)
    pos_hit = o[:, None, None] + t_hit[None] * dn
    gnorm = torch.sqrt(torch.sum(grad * grad, dim=-1, keepdim=True))
    normal = torch.movedim(grad / torch.clamp(gnorm, min=1e-12), -1, 0)
    ok = found & (gnorm[..., 0] > 1e-9)

    # nearest colour and weight
    gi = round_to_int(torch.movedim(pos_hit, 0, -1) * inv_vsz - 0.5)
    px = torch.remainder(gi[..., 0] + vol.wrap[0], R)
    py = torch.remainder(gi[..., 1] + vol.wrap[1], R)
    pz = torch.remainder(gi[..., 2] + vol.wrap[2], R)
    cw = vol.cw.reshape(-1)[flat_index(R, pz, py, px).long()]
    wgt, cr, cg, cb = unpack_cw(cw)

    nan = torch.nan
    return FastRaycastResult(
        vmap=torch.where(ok[None], pos_hit, nan),
        nmap=torch.where(ok[None], normal, nan),
        color=torch.where(ok[None], torch.stack([cr, cg, cb], 0), 0.0),
        weight=torch.where(ok, wgt, 0.0),
        depth=torch.where(ok, t_hit * cos_z, 0.0),
    )
